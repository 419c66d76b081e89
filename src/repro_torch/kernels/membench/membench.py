"""The membench throughput kernels — hand-written CUDA C++ for Hopper, with
their build, their wrappers and their plain PyTorch versions.

Counterpart of ``repro.kernels.membench.membench`` (the Pallas kernels of the
JAX reference).  Knobs (mapping to the paper):

  mix         load_only | load_sum | copy | triad | fma_k | mxu | rw_RtoW |
              latency_chase                                      (C2)
  block_rows  rows per (block_rows, 128) tile                    (C4)
  streams     1 = sequential tile walk; S > 1 = S interleaved address
              streams: walk step i visits tile (i % S)*(n_tiles/S) + i // S  (C3)
  interleave  K independent accumulators / store streams per tile
  passes      sweeps over the buffer inside ONE launch (the measurement loop)
  unroll      pass-loop bodies per loop trip (1, 2, 4 or 8)

The kernels are in ``csrc/*.cu`` (each file's header says which reference
kernel it replaces, what bounds it on an H100 and what the design does about
it).  They are compiled with ``nvcc`` for ``sm_90a`` at first use — one
``nvcc`` per source, all started together — into shared libraries with a plain
C interface under ``build/membench/`` at the checkout's root, and loaded with
``ctypes`` (``repro_torch.kernels.build``).  Nothing is built or loaded when
this module is imported.

Every wrapper takes its plain version ONLY for a tensor that lies on the CPU.
For a CUDA tensor it launches the kernel or raises: no fallback.  Each
wrapper adds one to ``launch_counts[name]`` where it launches its kernel, and
nowhere else.

Grid: rw and mxu own whole tiles: ``G = min(n_tiles, CTAS_PER_SM * SM
count)`` CTAs of 256 threads (mxu: as many as stay resident,
``mxu_launch_plan``), CTA ``c`` owns walk steps ``c, c+G, ...`` in every
pass.  load_sum, load_only, fma, copy and triad cut the walk into blocks of
consecutive 16-byte vectors instead (``acc_launch_plan``,
``copy_launch_plan``, ``triad_launch_plan``; ``csrc/walk.cuh``): a
non-persistent grid above the L2, a persistent one at and below it, so that
a buffer of one tile spans many SMs.  The chase is the exception: one thread
walks every tile, so that one dependent chain runs at a time, and each pass
is a launch of its own, so that every pass starts from the same cache state
(``csrc/chase.cu``).
"""
from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench.mixes import (MAX_RW, RW_COMBINE_COEF, get_mix,
                                     interleavable)
from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.build import launch as _launch
from repro_torch.kernels.build import raise_on as _raise_on

LANES = 128
#: resident CTAs asked for per SM (256 threads each); csrc/rw.cu is compiled
#: for it (``kRwCtas``, its ``__launch_bounds__``)
CTAS_PER_SM = 4
UNROLLS = (1, 2, 4, 8)
INTERLEAVES = (1, 2, 4, 8)
FMA_A = 1.0000001
FMA_B = 1e-9

#: launches per kernel since the last ``reset_launch_counts`` (row 1 of the
#: kernel table counts its three bodies separately)
KERNEL_NAMES = ("load_sum", "load_only", "fma", "mxu", "copy", "triad", "rw",
                "chase")
launch_counts: dict[str, int] = {k: 0 for k in KERNEL_NAMES}

#: kernel name -> source file (relative to this package's csrc/)
SOURCES = {"load_sum": "acc.cu", "load_only": "acc.cu", "fma": "acc.cu",
           "mxu": "mxu.cu", "copy": "copy.cu", "triad": "triad.cu",
           "rw": "rw.cu", "chase": "chase.cu"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACC_MIX_CODE = {"load_sum": 0, "load_only": 1, "fma": 2}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# build + load (route: nvcc -> shared library with a C interface -> ctypes;
# kernels/build.py)
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = KernelLibrary("membench", Path(__file__).resolve().parent / "csrc", {
    # mix dtype x partials out n_tiles block_rows streams passes unroll
    # interleave depth shape grid stream
    "acc.cu": ("membench_acc",
               [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # dtype x w partials out n_tiles block_rows streams passes unroll grid
    # stream
    "mxu.cu": ("membench_mxu", [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # x out n_tiles tile_bytes streams passes unroll interleave shape grid
    # stream
    "copy.cu": ("membench_copy",
                [_P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _P]),
    # dtype b c out n_tiles block_rows streams passes unroll shape grid
    # stream
    "triad.cu": ("membench_triad",
                 [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    # dtype ins reads outs writes n_tiles block_rows streams passes unroll
    # interleave grid stream
    "rw.cu": ("membench_rw",
              [_I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # perm out n_tiles tile_elems streams accumulate stream
    "chase.cu": ("membench_chase", [_P, _P, _I, _I, _I, _I, _P]),
}, headers=("membench_common.cuh", "walk.cuh", "stream.cuh",
            "../../tensor_core.cuh"))
CSRC = LIBRARY.csrc
#: source -> loaded library (empty until the first launch on a card)
_libs = LIBRARY.libs
_entry = LIBRARY.entry


# ---------------------------------------------------------------------------
# argument checks shared by every wrapper
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, block_rows: int, streams: int, passes: int,
           unroll: int, interleave: int = 1, name: str = "x",
           dtypes: tuple = tuple(_DTYPE_CODE)) -> int:
    """Validate one (rows, 128) operand and the knobs; returns n_tiles."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on {x.device}: need a cpu or cuda "
                         f"tensor")
    if x.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name} has dtype {x.dtype}: this membench kernel "
                        f"takes {names}")
    if x.ndim != 2 or x.shape[1] != LANES or x.shape[0] % 8:
        raise ValueError(f"{name} must have shape (rows, {LANES}) with rows a "
                         f"multiple of 8, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return _check_knobs(x.shape[0], block_rows, streams, passes, unroll,
                        interleave)


@functools.lru_cache(maxsize=1024)
def _check_knobs(rows: int, block_rows: int, streams: int, passes: int,
                 unroll: int, interleave: int) -> int:
    """The knob checks of ``_check`` (they depend on the knobs and the row
    count alone, so a timed loop pays for them once: a call that raises is
    not cached and raises again); returns n_tiles."""
    if block_rows < 8 or block_rows % 8 or rows % block_rows:
        raise ValueError(f"block_rows {block_rows} must be a multiple of 8 "
                         f"that divides {rows} rows")
    n_tiles = rows // block_rows
    if streams < 1 or n_tiles % streams:
        raise ValueError(f"streams {streams} does not divide {n_tiles} tiles")
    if unroll not in UNROLLS:
        raise ValueError(f"unroll {unroll} not in {UNROLLS} (the pass loop "
                         f"is unrolled at compile time)")
    if passes < 1 or passes % unroll:
        raise ValueError(f"passes={passes} must be a positive multiple of "
                         f"unroll={unroll}")
    if interleave not in INTERLEAVES:
        raise ValueError(f"interleave {interleave} not in {INTERLEAVES}")
    if block_rows % interleave:
        raise ValueError(f"interleave {interleave} does not divide the "
                         f"{block_rows}-row tile")
    return n_tiles


def _check_like(y: torch.Tensor, x: torch.Tensor, name: str,
                index: int | None = None) -> None:
    """Raise unless y is a contiguous tensor of x's shape, dtype and device
    (``name[index]`` in the message when an index is given)."""
    if not isinstance(y, torch.Tensor) or y.shape != x.shape \
            or y.dtype != x.dtype or y.device != x.device \
            or not y.is_contiguous():
        if index is not None:
            name = f"{name}[{index}]"
        raise ValueError(f"{name} must be a contiguous tensor like x "
                         f"(shape {tuple(x.shape)}, {x.dtype}, {x.device})")


#: id(perm) -> (weak reference, version, tile size) of every buffer that
#: passed check_chase_perm and has not been written to since
_checked_perms: dict[int, tuple] = {}


def check_chase_perm(perm: torch.Tensor, block_rows: int) -> None:
    """Raise unless every entry of ``perm`` lies in ``[0, block_rows *
    128)``: the chase kernel trusts its buffer (a check inside the walk
    would lengthen every step).  One device reduction and one
    synchronisation, paid once per buffer: the result is remembered until
    the buffer is written to (its version counter moves) or freed, so the
    ``chase`` wrapper, which runs this before every launch, pays nothing
    after the first."""
    m = block_rows * LANES
    key = id(perm)
    seen = _checked_perms.get(key)
    if seen is not None and seen[0]() is perm \
            and seen[1:] == (perm._version, m):
        return
    if bool(((perm < 0) | (perm >= m)).any()):
        raise ValueError(f"perm holds an index outside [0, {m}): every "
                         f"entry must point inside its {block_rows}-row "
                         f"tile")
    _checked_perms[key] = (
        weakref.ref(perm, lambda _, k=key: _checked_perms.pop(k, None)),
        perm._version, m)


def default_block_rows(rows: int) -> int:
    """Default tiling: the largest multiple of 8 that is <= 128 and divides
    ``rows`` (rows is a multiple of 8, so 8 always does)."""
    r = min(128, rows)
    while r > 8 and rows % r:
        r -= 8
    return r


@functools.lru_cache(maxsize=None)
def _properties(idx: int):
    return torch.cuda.get_device_properties(idx)


def _device_index(device) -> int:
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def sm_count(device) -> int:
    return _properties(_device_index(device)).multi_processor_count


def l2_bytes(device) -> int:
    """The card's L2 size in bytes (50 MiB on an H100)."""
    return _properties(_device_index(device)).L2_cache_size


def grid_size(n_tiles: int, device) -> int:
    return min(n_tiles, CTAS_PER_SM * sm_count(device))


#: csrc/triad.cu: threads (one vector each) of a non-persistent block, and
#: persistent CTAs (of 256 threads, one vector each) an SM
TRIAD_NP_THREADS = 1024
TRIAD_WIN_CTAS = 8
_THREADS = 256


@functools.lru_cache(maxsize=256)
def triad_launch_plan(n_tiles: int, tile_bytes: int, sms: int,
                      l2: int) -> dict:
    """The grid shape of csrc/triad.cu for n_tiles tiles of tile_bytes:
    ``shape`` 1 (non-persistent: ``grid`` blocks of ``TRIAD_NP_THREADS``
    vectors per pass, the pass the slow grid dimension) when the three
    buffers exceed the L2 of ``l2`` bytes, else 0 (persistent: ``grid``
    resident CTAs take blocks of 256 vectors c, c + grid, ... in every
    pass).  ``block_vecs`` is the vectors a block covers."""
    vecs = n_tiles * tile_bytes // 16
    if 3 * n_tiles * tile_bytes > l2:
        return {"shape": 1, "grid": -(-vecs // TRIAD_NP_THREADS),
                "block_vecs": TRIAD_NP_THREADS}
    return {"shape": 0, "grid": min(-(-vecs // _THREADS),
                                    TRIAD_WIN_CTAS * sms),
            "block_vecs": _THREADS}


#: csrc/acc.cu and csrc/copy.cu: (threads a CTA, positions a thread a block,
#: resident CTAs an SM) of the persistent shape, and (threads, positions a
#: thread) of the non-persistent one (acc.cu compiles it for kAccNpCtas
#: CTAs an SM; its grid is the blocks of a pass either way)
ACC_WIN = (256, 1, 4)
ACC_NP = (256, 4)
COPY_WIN = (256, 1, 4)
COPY_NP = (256, 1)
#: csrc/acc.cu: partials a CTA of the first of its two fold stages
FOLD_CHUNK = 1024
#: fma chain links a byte of the buffer from which acc.cu keeps the
#: persistent grid above the L2 (bfloat16 at depth 8 has 4 and lost 7 % on
#: the non-persistent grid; float32 at depth 8 has 2 and gained 1.5-3 %:
#: tools/stream_variants.py --sweep acc on an H100)
FMA_PERSISTENT_PER_BYTE = 4


def _block_plan(positions: int, persistent: bool, win: tuple, np_: tuple,
                sms: int) -> dict:
    """The grid of a vector-block walk (``csrc/walk.cuh``) over
    ``positions`` positions a pass: ``shape`` 0 (persistent: ``grid``
    resident CTAs take blocks c, c + grid, ... in every pass) or 1
    (non-persistent: ``grid`` blocks a pass, the pass the slow grid
    dimension); ``block`` positions a block, ``threads`` a CTA."""
    if persistent:
        threads, vecs, ctas = win
        per = threads * vecs
        return {"shape": 0, "grid": min(-(-positions // per), ctas * sms),
                "block": per, "threads": threads}
    threads, vecs = np_
    per = threads * vecs
    return {"shape": 1, "grid": -(-positions // per), "block": per,
            "threads": threads}


def _win(win: tuple, interleave: int) -> tuple:
    """The persistent shape at ``interleave``: K >= 4 holds K vectors a
    position and is compiled for half the CTAs an SM."""
    threads, vecs, ctas = win
    return threads, vecs, ctas // 2 if interleave >= 4 else ctas


@functools.lru_cache(maxsize=256)
def acc_launch_plan(n_tiles: int, tile_bytes: int, interleave: int, sms: int,
                    l2: int, links_per_byte: float = 0.0) -> dict:
    """The grid of csrc/acc.cu (load_sum, load_only, fma): persistent while
    the buffer fits the L2 of ``l2`` bytes, non-persistent above it, but for
    an fma chain of ``links_per_byte`` >= FMA_PERSISTENT_PER_BYTE (depth /
    element size), which stays persistent: its chains keep the float32
    units about as busy as its loads keep the memory, and CTAs that retire
    after one block overlap the two less.  With interleave = K a position
    is K vectors (one in each row chunk of a tile); K >= 4 is compiled for
    half the persistent CTAs an SM."""
    positions = n_tiles * tile_bytes // 16 // interleave
    fits = (n_tiles * tile_bytes <= l2
            or links_per_byte >= FMA_PERSISTENT_PER_BYTE)
    return _block_plan(positions, fits, _win(ACC_WIN, interleave), ACC_NP,
                       sms)


@functools.lru_cache(maxsize=256)
def copy_launch_plan(n_tiles: int, tile_bytes: int, interleave: int,
                     sms: int, l2: int) -> dict:
    """The grid of csrc/copy.cu: persistent while the two buffers fit the
    L2 of ``l2`` bytes, non-persistent above it (positions as in
    ``acc_launch_plan``, and so is the persistent grid)."""
    positions = n_tiles * tile_bytes // 16 // interleave
    return _block_plan(positions, 2 * n_tiles * tile_bytes <= l2,
                       _win(COPY_WIN, interleave), COPY_NP, sms)


def acc_scratch(plan: dict, passes: int) -> int:
    """Floats of csrc/acc.cu's partials scratch: one partial a CTA
    (persistent) or per block and pass (non-persistent), then the first fold
    stage's output."""
    n = plan["grid"] * (passes if plan["shape"] == 1 else 1)
    return n + -(-n // FOLD_CHUNK)


#: the launch plan of csrc/mxu.cu per dtype (mirrors its route constants):
#: CTAs resident per SM, and dynamic shared memory per CTA — float32: w
#: (64 KiB) and two 128-row chunks of x; bfloat16: two 128-row chunks (w
#: lives in registers)
MXU_PLAN = {torch.float32: (1, 64 * 1024 + 2 * 128 * LANES * 4),
            torch.bfloat16: (2, 2 * 128 * LANES * 2)}


def mxu_launch_plan(n_tiles: int, block_rows: int, dtype, sms: int) -> dict:
    """Grid, dynamic shared memory per CTA, and whether a tile ends in a
    half-full 16-row slab (bfloat16 route: its rows 8..15 enter the product
    as zeros).  The grid is persistent: as many CTAs as stay resident, at
    most one per tile."""
    ctas_per_sm, smem = MXU_PLAN[dtype]
    return {"grid": min(n_tiles, ctas_per_sm * sms), "smem_bytes": smem,
            "half_slab": block_rows % 16 == 8}


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _repeat_sum(one: torch.Tensor, passes: int) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float32, device=one.device)
    for _ in range(passes):
        acc = acc + one
    return acc


def plain_load_sum(x, passes: int = 1) -> torch.Tensor:
    """Sum of every element in float32, ``passes`` times over (the tile
    walk, streams and interleave change only the order of the additions)."""
    return _repeat_sum(x.sum(dtype=torch.float32), passes)


def plain_load_only(x, block_rows: int, passes: int = 1) -> torch.Tensor:
    """Sum of element [0,0] of every (block_rows, 128) tile."""
    return _repeat_sum(x[::block_rows, 0].sum(dtype=torch.float32), passes)


def plain_fma(x, depth: int, passes: int = 1) -> torch.Tensor:
    v = x.to(torch.float32)
    for _ in range(depth):
        v = v * FMA_A + FMA_B
    return _repeat_sum(v.sum(), passes)


def plain_mxu(x, w, block_rows: int, passes: int = 1) -> torch.Tensor:
    """(2,) float32: the sum of y[0,0] over tiles, and the sum of all of y,
    for y = tile @ w accumulated in float32."""
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return torch.stack([_repeat_sum(y[::block_rows, 0].sum(), passes),
                        _repeat_sum(y.sum(), passes)])


def plain_copy(x, out=None, passes: int = 1) -> torch.Tensor:
    """``out = x``, written ``passes`` times over."""
    if out is None:
        out = torch.empty_like(x)
    for _ in range(passes):
        out.copy_(x)
    return out


def plain_triad(b, c, out=None, passes: int = 1) -> torch.Tensor:
    """``out = b + 1.5 * c`` in the working dtype, one rounding per
    operation, written ``passes`` times over."""
    if out is None:
        out = torch.empty_like(b)
    for _ in range(passes):
        torch.add(b, c * RW_COMBINE_COEF, out=out)
    return out


def plain_rw(x, *ys, writes: int, outs=None, passes: int = 1) -> tuple:
    """``v = x + 1.5*ys[0] + 1.5*ys[1] + ...`` in the working dtype, one
    rounding per operation, written to each of ``writes`` outputs,
    ``passes`` times over; returns the outputs."""
    if outs is None:
        outs = tuple(torch.empty_like(x) for _ in range(writes))
    for _ in range(passes):
        v = x
        for y in ys:
            v = v + y * RW_COMBINE_COEF
        for o in outs:
            o.copy_(v)
    return tuple(outs)


def plain_chase(perm, block_rows: int, streams: int = 1,
                passes: int = 1) -> torch.Tensor:
    """0-dim float32: per pass, the sum over tiles in walk order of the
    index reached after ``block_rows * 128`` steps ``j = tile[j]`` from
    ``j = 0``.  The tiles walk side by side (one gather per step, for all
    of them), and the float32 fold runs in the kernel's order."""
    n_tiles, m = perm.shape[0] // block_rows, block_rows * LANES
    tiles = perm.reshape(n_tiles, m).to(torch.int64)
    j = torch.zeros(n_tiles, 1, dtype=torch.int64, device=perm.device)
    for _ in range(m):
        j = tiles.gather(1, j)
    finals = j[:, 0].tolist()
    seg = n_tiles // streams
    one = np.float32(0.0)
    for i in range(n_tiles):                  # walk step i visits this tile
        one = np.float32(one + np.float32(finals[(i % streams) * seg
                                                 + i // streams]))
    acc = np.float32(0.0)
    for _ in range(passes):
        acc = np.float32(acc + one)
    return torch.tensor(acc, dtype=torch.float32, device=perm.device)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _acc(name: str, x, n_tiles, block_rows, streams, passes, unroll,
         interleave, depth) -> torch.Tensor:
    plan = acc_launch_plan(n_tiles, block_rows * LANES * x.element_size(),
                           interleave, sm_count(x.device), l2_bytes(x.device),
                           depth / x.element_size())
    partials = torch.empty(acc_scratch(plan, passes), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    err = _launch(_entry(SOURCES[name]), x, _ACC_MIX_CODE[name],
                  _DTYPE_CODE[x.dtype], x.data_ptr(), partials.data_ptr(),
                  out.data_ptr(), n_tiles, block_rows, streams, passes,
                  unroll, interleave, depth, plan["shape"], plan["grid"])
    launch_counts[name] += 1
    _raise_on(err, name)
    return out


def load_sum(x, *, block_rows: int, streams: int = 1, passes: int = 1,
             unroll: int = 1, interleave: int = 1) -> torch.Tensor:
    """0-dim float32: the sum of every element, over ``passes`` sweeps."""
    n_tiles = _check(x, block_rows, streams, passes, unroll, interleave)
    if x.device.type == "cpu":
        return plain_load_sum(x, passes)
    return _acc("load_sum", x, n_tiles, block_rows, streams, passes, unroll,
                interleave, 0)


def load_only(x, *, block_rows: int, streams: int = 1, passes: int = 1,
              unroll: int = 1) -> torch.Tensor:
    """0-dim float32: the sum of element [0,0] of every tile, over ``passes``
    sweeps in which every tile is moved on chip."""
    n_tiles = _check(x, block_rows, streams, passes, unroll)
    if x.device.type == "cpu":
        return plain_load_only(x, block_rows, passes)
    return _acc("load_only", x, n_tiles, block_rows, streams, passes, unroll, 1, 0)


def fma(x, depth: int, *, block_rows: int, streams: int = 1, passes: int = 1,
        unroll: int = 1) -> torch.Tensor:
    """0-dim float32: the sum over elements of a ``depth``-long dependent
    chain ``v = v * 1.0000001 + 1e-9``, over ``passes`` sweeps."""
    n_tiles = _check(x, block_rows, streams, passes, unroll)
    if depth < 1:
        raise ValueError(f"fma depth must be >= 1: {depth}")
    if x.device.type == "cpu":
        return plain_fma(x, depth, passes)
    return _acc("fma", x, n_tiles, block_rows, streams, passes, unroll, 1, depth)


def mxu(x, w=None, *, block_rows: int, streams: int = 1, passes: int = 1,
        unroll: int = 1, with_checksum: bool = False) -> torch.Tensor:
    """0-dim float32: the sum over tiles and passes of ``(tile @ w)[0, 0]``
    with float32 accumulation; ``w`` defaults to ``eye(128)`` in x's dtype.
    ``with_checksum=True`` returns the (2,) tensor ``[that, sum of all of
    y]`` — the kernel computes all of y either way."""
    n_tiles = _check(x, block_rows, streams, passes, unroll)
    if w is None:
        w = torch.eye(LANES, dtype=x.dtype, device=x.device)
    if not isinstance(w, torch.Tensor) or w.shape != (LANES, LANES) \
            or w.dtype != x.dtype or w.device != x.device \
            or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous ({LANES}, {LANES}) tensor "
                         f"of x's dtype on x's device")
    if x.device.type == "cpu":
        both = plain_mxu(x, w, block_rows, passes)
    else:
        grid = mxu_launch_plan(n_tiles, block_rows, x.dtype,
                               sm_count(x.device))["grid"]
        partials = torch.empty(2 * grid, dtype=torch.float32, device=x.device)
        both = torch.empty(2, dtype=torch.float32, device=x.device)
        err = _launch(_entry(SOURCES["mxu"]), x, _DTYPE_CODE[x.dtype],
                      x.data_ptr(), w.data_ptr(), partials.data_ptr(),
                      both.data_ptr(), n_tiles, block_rows, streams, passes,
                      unroll, grid)
        launch_counts["mxu"] += 1
        _raise_on(err, "mxu")
    return both if with_checksum else both[0]


def copy(x, out=None, *, block_rows: int, streams: int = 1, passes: int = 1,
         unroll: int = 1, interleave: int = 1) -> torch.Tensor:
    """``out[tile] = x[tile]`` for every tile, ``passes`` times over; returns
    ``out`` (allocated when not given, written in place when given)."""
    n_tiles = _check(x, block_rows, streams, passes, unroll, interleave)
    if out is not None:
        _check_like(out, x, "out")
    if x.device.type == "cpu":
        return plain_copy(x, out, passes)
    if out is None:
        out = torch.empty_like(x)
    tile_bytes = block_rows * LANES * x.element_size()
    plan = copy_launch_plan(n_tiles, tile_bytes, interleave,
                            sm_count(x.device), l2_bytes(x.device))
    err = _launch(_entry(SOURCES["copy"]), x, x.data_ptr(), out.data_ptr(),
                  n_tiles, tile_bytes, streams, passes, unroll, interleave,
                  plan["shape"], plan["grid"])
    launch_counts["copy"] += 1
    _raise_on(err, "copy")
    return out


def triad(b, c, out=None, *, block_rows: int, streams: int = 1,
          passes: int = 1, unroll: int = 1) -> torch.Tensor:
    """``out = b + 1.5 * c`` per tile in the working dtype, ``passes`` times
    over; returns ``out``."""
    n_tiles = _check(b, block_rows, streams, passes, unroll, name="b")
    _check_like(c, b, "c")
    if out is not None:
        _check_like(out, b, "out")
    if b.device.type == "cpu":
        return plain_triad(b, c, out, passes)
    if out is None:
        out = torch.empty_like(b)
    plan = triad_launch_plan(n_tiles, block_rows * LANES * b.element_size(),
                             sm_count(b.device), l2_bytes(b.device))
    err = _launch(_entry(SOURCES["triad"]), b, _DTYPE_CODE[b.dtype],
                  b.data_ptr(), c.data_ptr(), out.data_ptr(), n_tiles,
                  block_rows, streams, passes, unroll, plan["shape"],
                  plan["grid"])
    launch_counts["triad"] += 1
    _raise_on(err, "triad")
    return out


_pointers = threading.local()


def _pointer_arrays():
    """This thread's two ``MAX_RW``-long pointer arrays for the rw entry
    point (filled before each launch, read by it before it returns), so
    that a call does not build new ``ctypes`` arrays."""
    try:
        return _pointers.ins, _pointers.outs
    except AttributeError:
        _pointers.ins = (ctypes.c_void_p * MAX_RW)()
        _pointers.outs = (ctypes.c_void_p * MAX_RW)()
        return _pointers.ins, _pointers.outs


def rw(x, *ys, reads: int, writes: int, outs=None, block_rows: int,
       streams: int = 1, passes: int = 1, unroll: int = 1,
       interleave: int = 1) -> tuple:
    """The R:W ratio kernel: ``v = x + 1.5*ys[0] + ...`` per tile (``reads``
    = 1 + len(ys) read streams) stored to each of ``writes`` outputs,
    ``passes`` times over; returns the W outputs (allocated when ``outs`` is
    not given, written in place when it is; an output may not alias an input
    or another output)."""
    n_tiles = _check(x, block_rows, streams, passes, unroll, interleave)
    if not (1 <= reads <= MAX_RW and 1 <= writes <= MAX_RW) \
            or len(ys) != reads - 1:
        raise ValueError(f"rw needs 1 <= reads, writes <= {MAX_RW} and "
                         f"reads - 1 extra read streams: reads={reads}, "
                         f"writes={writes}, {len(ys)} given")
    for i, y in enumerate(ys):
        _check_like(y, x, "ys", i)
    if outs is not None:
        if len(outs) != writes:
            raise ValueError(f"outs holds {len(outs)} tensors, "
                             f"writes={writes}")
        for i, o in enumerate(outs):
            _check_like(o, x, "outs", i)
        read_ptrs = {t.data_ptr() for t in (x, *ys)}
        write_ptrs = {o.data_ptr() for o in outs}
        if len(write_ptrs) != writes or write_ptrs & read_ptrs:
            raise ValueError("an output of rw aliases an input or another "
                             "output")
    if x.device.type == "cpu":
        return plain_rw(x, *ys, writes=writes, outs=outs, passes=passes)
    if outs is None:
        outs = tuple(torch.empty_like(x) for _ in range(writes))
    ins, dst = _pointer_arrays()
    ins[0] = x.data_ptr()
    for i, y in enumerate(ys, 1):
        ins[i] = y.data_ptr()
    for i, o in enumerate(outs):
        dst[i] = o.data_ptr()
    err = _launch(_entry(SOURCES["rw"]), x, _DTYPE_CODE[x.dtype], ins, reads,
                  dst, writes, n_tiles, block_rows, streams, passes, unroll,
                  interleave, grid_size(n_tiles, x.device))
    launch_counts["rw"] += 1
    _raise_on(err, "rw")
    return tuple(outs)


def chase(perm, *, block_rows: int, streams: int = 1, passes: int = 1,
          unroll: int = 1) -> torch.Tensor:
    """0-dim float32: per pass, the sum over tiles (in walk order) of the
    index a walk ``j = tile[j]`` of ``block_rows * 128`` dependent steps
    from ``j = 0`` reaches, over ``passes`` passes.  ``perm`` is an int32
    (rows, 128) buffer whose every entry lies inside its own tile
    (``core.instruction_mix.chase_perm(shape, rows // block_rows)``;
    ``check_chase_perm`` checks it, once per buffer).  On the card one
    thread walks every tile: one dependent chain at a time, one launch per
    pass, so that every pass starts from the same cache state.  ``unroll``
    is checked as for the other kernels and changes nothing here."""
    n_tiles = _check(perm, block_rows, streams, passes, unroll, name="perm",
                     dtypes=(torch.int32,))
    if perm.device.type == "cpu":
        return plain_chase(perm, block_rows, streams, passes)
    check_chase_perm(perm, block_rows)
    out = torch.empty((), dtype=torch.float32, device=perm.device)
    fn = _entry(SOURCES["chase"])
    for p in range(passes):
        err = _launch(fn, perm, perm.data_ptr(), out.data_ptr(), n_tiles,
                      block_rows * LANES, streams, int(p > 0))
        launch_counts["chase"] += 1
        _raise_on(err, "chase")
    return out


def membench_call(x, *, mix: str = "load_sum", depth: int = 8,
                  block_rows: int = 128, streams: int = 1, y=None, ys=(),
                  interleave: int = 1, passes: int = 1, unroll: int = 1,
                  out=None):
    """The dispatcher, as ``repro.kernels.membench.membench.membench_call``:
    x is (rows, 128) float32/bfloat16 (int32 for ``latency_chase``: the
    permutation buffer); returns a 0-dim float32 tensor (load family, fma,
    mxu, latency_chase), an array (copy / triad) or a tuple of W arrays
    (``rw_RtoW``).  ``triad`` needs a second same-shape operand ``y``,
    ``rw_RtoW`` its R-1 extra read streams as ``ys``; ``out`` is the output
    (copy / triad) or the W outputs (rw).  ``passes``/``unroll`` run the
    measurement loop inside the call."""
    kw = dict(block_rows=block_rows, streams=streams, passes=passes,
              unroll=unroll)
    if interleave > 1 and not interleavable(
            get_mix(f"fma_{depth}" if mix == "fma" else mix)):
        raise ValueError(f"mix {mix!r} has no interleaved variant")
    if mix.startswith("rw_"):
        reads, writes = get_mix(mix).rw
        return rw(x, *ys, reads=reads, writes=writes, outs=out,
                  interleave=interleave, **kw)
    if mix == "latency_chase":
        return chase(x, **kw)
    if mix == "load_sum":
        return load_sum(x, interleave=interleave, **kw)
    if mix == "load_only":
        return load_only(x, **kw)
    if mix == "fma" or mix.startswith("fma_"):
        k = int(mix.split("_")[1]) if "_" in mix else depth
        return fma(x, k, **kw)
    if mix == "mxu":
        return mxu(x, **kw)
    if mix == "copy":
        return copy(x, out, interleave=interleave, **kw)
    if mix == "triad":
        if y is None:
            raise ValueError("triad needs y of x.shape")
        return triad(x, y, out, **kw)
    raise KeyError(mix)
