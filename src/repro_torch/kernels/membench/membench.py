"""The membench throughput kernels — hand-written CUDA C++ for Hopper, with
their build, their wrappers and their plain PyTorch versions.

Counterpart of ``repro.kernels.membench.membench`` (the Pallas kernels of the
JAX reference).  Knobs (mapping to the paper):

  mix         load_only | load_sum | copy | triad | fma_k | mxu   (C2)
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
``ctypes``.  Nothing is built or loaded when this module is imported.

Every wrapper takes its plain version ONLY for a tensor that lies on the CPU.
For a CUDA tensor it launches the kernel or raises: no fallback.  Each
wrapper adds one to ``launch_counts[name]`` where it launches its kernel, and
nowhere else.

Grid: ``G = min(n_tiles, CTAS_PER_SM * SM count)`` CTAs of 256 threads; CTA
``c`` owns walk steps ``c, c+G, ...`` in every pass.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.bench.mixes import RW_COMBINE_COEF

LANES = 128
#: resident CTAs asked for per SM (256 threads each)
CTAS_PER_SM = 4
UNROLLS = (1, 2, 4, 8)
INTERLEAVES = (1, 2, 4, 8)
FMA_A = 1.0000001
FMA_B = 1e-9

#: launches per kernel since the last ``reset_launch_counts`` (row 1 of the
#: kernel table counts its three bodies separately)
KERNEL_NAMES = ("load_sum", "load_only", "fma", "mxu", "copy", "triad")
launch_counts: dict[str, int] = {k: 0 for k in KERNEL_NAMES}

#: kernel name -> source file (relative to this package's csrc/)
SOURCES = {"load_sum": "acc.cu", "load_only": "acc.cu", "fma": "acc.cu",
           "mxu": "mxu.cu", "copy": "copy.cu", "triad": "triad.cu"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACC_MIX_CODE = {"load_sum": 0, "load_only": 1, "fma": 2}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# build + load (route: nvcc -> shared library with a C interface -> ctypes)
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
#: seconds the last ``build_all`` spent compiling (0.0 when all were cached)
last_build_seconds = 0.0


def build_dir() -> Path:
    # src/repro_torch/kernels/membench/membench.py -> the checkout's root
    return Path(__file__).resolve().parents[4] / "build" / "membench"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME / "
        "/usr/local/cuda): the membench CUDA kernels cannot be built here")


def _lib_path(source: str) -> Path:
    """Content-addressed library path: a changed source never loads a stale
    build."""
    h = hashlib.sha256()
    for f in (CSRC / source, CSRC / "membench_common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no current library, all ``nvcc``
    processes started together.  Raises with the compiler's output if one
    fails.  Returns source -> library path."""
    import time
    global last_build_seconds
    paths = {src: _lib_path(src) for src in sorted(set(SOURCES.values()))}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    last_build_seconds = 0.0
    if not todo:
        return paths
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for src, (tmp, cmd, proc) in procs.items():
        out, _ = proc.communicate()
        path = todo[src]
        path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\nexit {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    last_build_seconds = time.perf_counter() - t0
    if failures:
        raise RuntimeError("nvcc failed to build the membench kernels:\n"
                           + "\n".join(failures))
    return paths


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # mix dtype x partials out n_tiles block_rows streams passes unroll
    # interleave depth grid stream
    "membench_acc": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype x w partials out n_tiles block_rows streams passes unroll grid
    # stream
    "membench_mxu": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x out n_tiles tile_bytes streams passes unroll interleave grid stream
    "membench_copy": [_P, _P, _I, _LL, _I, _I, _I, _I, _I, _P],
    # dtype b c out n_tiles block_rows streams passes unroll grid stream
    "membench_triad": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}
_ENTRY = {"acc.cu": "membench_acc", "mxu.cu": "membench_mxu",
          "copy.cu": "membench_copy", "triad.cu": "membench_triad"}


def _entry(source: str):
    """The C entry point of ``source``, building and loading at first use."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[source]))
        fn = getattr(lib, _ENTRY[source])
        fn.argtypes = _ARGTYPES[_ENTRY[source]]
        fn.restype = ctypes.c_int
        _libs[source] = lib
    return getattr(lib, _ENTRY[source])


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err} "
                           f"(cudaGetLastError)")


# ---------------------------------------------------------------------------
# argument checks shared by every wrapper
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, block_rows: int, streams: int, passes: int,
           unroll: int, interleave: int = 1, name: str = "x") -> int:
    """Validate one (rows, 128) operand and the knobs; returns n_tiles."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on {x.device}: need a cpu or cuda "
                         f"tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} has dtype {x.dtype}: the membench kernels "
                        f"take float32 or bfloat16")
    if x.ndim != 2 or x.shape[1] != LANES or x.shape[0] % 8:
        raise ValueError(f"{name} must have shape (rows, {LANES}) with rows a "
                         f"multiple of 8, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    rows = x.shape[0]
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


def _check_like(y: torch.Tensor, x: torch.Tensor, name: str) -> None:
    if not isinstance(y, torch.Tensor) or y.shape != x.shape \
            or y.dtype != x.dtype or y.device != x.device \
            or not y.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor like x "
                         f"(shape {tuple(x.shape)}, {x.dtype}, {x.device})")


def default_block_rows(rows: int) -> int:
    """Default tiling: the largest multiple of 8 that is <= 128 and divides
    ``rows`` (rows is a multiple of 8, so 8 always does)."""
    r = min(128, rows)
    while r > 8 and rows % r:
        r -= 8
    return r


_sm_counts: dict[int, int] = {}


def grid_size(n_tiles: int, device) -> int:
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    sms = _sm_counts.get(idx)
    if sms is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _sm_counts[idx] = sms
    return min(n_tiles, CTAS_PER_SM * sms)


def _launch(fn, x: torch.Tensor, *args) -> int:
    """Call the C entry ``fn(*args, stream)`` with x's device current and on
    that device's current stream; returns its ``cudaGetLastError()``.  The
    host's share of a timed call is kept small: the device is switched only
    when it is not the current one already."""
    dev = x.device.index
    if dev == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


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


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _acc(name: str, x, n_tiles, block_rows, streams, passes, unroll,
         interleave, depth) -> torch.Tensor:
    grid = grid_size(n_tiles, x.device)
    partials = torch.empty(grid, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    err = _launch(_entry(SOURCES[name]), x, _ACC_MIX_CODE[name],
                  _DTYPE_CODE[x.dtype], x.data_ptr(), partials.data_ptr(),
                  out.data_ptr(), n_tiles, block_rows, streams, passes,
                  unroll, interleave, depth, grid)
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
        grid = grid_size(n_tiles, x.device)
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
    err = _launch(_entry(SOURCES["copy"]), x, x.data_ptr(), out.data_ptr(),
                  n_tiles, block_rows * LANES * x.element_size(), streams,
                  passes, unroll, interleave, grid_size(n_tiles, x.device))
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
    err = _launch(_entry(SOURCES["triad"]), b, _DTYPE_CODE[b.dtype],
                  b.data_ptr(), c.data_ptr(), out.data_ptr(), n_tiles,
                  block_rows, streams, passes, unroll,
                  grid_size(n_tiles, b.device))
    launch_counts["triad"] += 1
    _raise_on(err, "triad")
    return out


def membench_call(x, *, mix: str = "load_sum", depth: int = 8,
                  block_rows: int = 128, streams: int = 1, y=None,
                  interleave: int = 1, passes: int = 1, unroll: int = 1,
                  out=None):
    """The dispatcher, as ``repro.kernels.membench.membench.membench_call``:
    x is (rows, 128) float32/bfloat16; returns a 0-dim float32 tensor
    (load family, fma, mxu) or an array (copy / triad).  ``triad`` needs a
    second same-shape operand ``y``.  ``passes``/``unroll`` run the
    measurement loop inside the call."""
    kw = dict(block_rows=block_rows, streams=streams, passes=passes,
              unroll=unroll)
    if interleave > 1 and mix not in ("load_sum", "copy"):
        raise ValueError(f"mix {mix!r} has no interleaved variant")
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
