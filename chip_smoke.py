#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one NVIDIA
GPU, and hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py            # everything; needs one CUDA device
    python3 chip_smoke.py --quick    # small sizes only (a first build check)
    python3 chip_smoke.py --out-dir DIR   # where results and log.txt go
                                          # (default: artifacts/chip_smoke)

Phases (any failure raises and the script exits non-zero):

  1  device: card name and power limit, torch / CUDA / nvcc versions, and the
     build of the kernels from ``src/repro_torch/kernels/membench/csrc``.
  2  every kernel against its plain version on the card, over dtypes, sizes,
     tilings, interleave, unroll and passes, on the benchmark's working set
     (whose sums cancel) and on a non-cancelling ramp input with a relative
     tolerance (mxu also against a dense operand); the fma chain's depth;
     bit-identical repeat runs; all ``streams`` give the same load_sum; the
     timed forms against the plain oracles of the ``torch`` backend.  The rw
     kernel over the R:W ladder (and 1:8, 8:1, 8:8) bit for bit against its
     plain version, and equal to copy / triad at 1:1 / 2:1; the chase on
     ``chase_perm`` (exactly 0.0) and on permutations whose walk ends
     elsewhere (exact equality), the loaded composite, repeat runs, and both
     timed forms against the ``torch`` oracles.
  3  the main paths, each with the launch counters set to 0 just before and
     read just after: ``run --backend cuda`` over the working-set ladder
     32 KiB .. 2 GiB for the six first mixes, then for the rw ladder, float32
     then bfloat16; ``latency --backend cuda`` (idle and loaded); the result
     JSON is read back and checked; ``compare`` of ``torch`` vs ``cuda``.
  4  the measurement is real: doubling ``passes`` doubles the time, no GB/s
     above the card's memory rate at 2 GiB, mxu below the float32 peak; the
     chase at least 5 ns per dependent step, loaded latency not below idle.
  5  one JSON line listing every kernel with its time, its plain version's,
     the library call's, and its bound.

The last line of the output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX and nothing of the JAX reference package.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False — this script "
          "needs one CUDA device", file=sys.stderr)
    sys.exit(2)

import numpy as np  # noqa: E402

from repro_torch.bench import cli  # noqa: E402
from repro_torch.bench.mixes import (GEN_SWEEPS_PER_PASS,  # noqa: E402
                                     get_mix, rw_name)
from repro_torch.bench.result import BenchResult  # noqa: E402
from repro_torch.core import instruction_mix as im  # noqa: E402
from repro_torch.core.buffers import working_set  # noqa: E402
from repro_torch.kernels.membench import membench as mb  # noqa: E402
from repro_torch.kernels.membench import ops as mb_ops  # noqa: E402

DEV = torch.device("cuda", 0)
# the plain mxu version must multiply in exact float32, as the kernel does
torch.backends.cuda.matmul.allow_tf32 = False
KiB, MiB, GiB = 2**10, 2**20, 2**30

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): the
# yardsticks of ``bound_ms`` and of phase 4.
HBM_BYTES_PER_S = 3.35e12
# One rule for the operations bound of every kernel: the card's peak for the
# kernel's input type computed EXACTLY.  bfloat16 products are exact on the
# tensor cores (989 TFLOP/s).  float32 has no exact tensor-core path: TF32
# (495 TFLOP/s) rounds x to 10 mantissa bits, which is another function than
# the float32 product the reference's kernel returns, so float32 is held to
# the 67 TFLOP/s of the ordinary float32 units.  The mxu rows also print
# ``bound_ms_tf32``, the bound a TF32 product would have, for the reader who
# accepts that rounding.
PEAK_FLOPS = {"float32": 67e12, "bfloat16_tensor": 989e12,
              "tf32_tensor": 495e12}
#: where each Pallas kernel of the reference lives (file:line)
REPLACES = {
    "load_sum": "src/repro/kernels/membench/membench.py:58",
    "load_only": "src/repro/kernels/membench/membench.py:58",
    "fma": "src/repro/kernels/membench/membench.py:58",
    "mxu": "src/repro/kernels/membench/membench.py:52",
    "copy": "src/repro/kernels/membench/membench.py:73",
    "triad": "src/repro/kernels/membench/membench.py:83",
    "rw": "src/repro/kernels/membench/membench.py:88",
    "chase": "src/repro/kernels/membench/membench.py:110",
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FMA_DEPTH = 8
#: the kernels of the first slice: the generic loops of phases 2, 4 and 5
#: run them; rw and chase have their own checks
BANDWIDTH_KERNELS = ("load_sum", "load_only", "fma", "mxu", "copy", "triad")
#: the registered R:W ladder the main path runs, and the corners phase 2
#: adds to it
RW_LADDER = ((1, 2), (1, 1), (2, 1), (3, 1), (4, 1))
RW_CORNERS = ((1, 8), (8, 1), (8, 8))
RW_MIXES = ",".join(rw_name(r, w) for r, w in RW_LADDER)
OUT_DIR = ROOT / "artifacts" / "chip_smoke"      # --out-dir replaces it


def say(msg: str = "") -> None:
    """Print a line, and keep it in ``log.txt`` of the output directory."""
    print(msg, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / "log.txt", "a") as f:
        f.write(msg + "\n")


def sync() -> None:
    torch.cuda.synchronize(DEV)


# ---------------------------------------------------------------------------
# tolerances (each with its reason) and the kernel <-> plain pairing
# ---------------------------------------------------------------------------

#: relative tolerance of a float32 sum of same-signed terms: kernel and
#: plain version add the same float32 values in another order, each
#: accumulator takes a few thousand terms per sweep before the fixed-order
#: fold, and its rounding errors (2**-24 relative each, of either sign)
#: add up like a random walk: well under 1e-6 of the sum.  1e-5 leaves
#: room for that and still fails a tile that is skipped or read twice.
SUM_RTOL = 1e-5


def ramp_input(x: torch.Tensor) -> torch.Tensor:
    """A non-cancelling input of x's shape and dtype: ``|x|`` scaled row by
    row from 0.5 to 1.5.  The working set's (v, 1/v, -v, -1/v) cycle sums to
    zero, so on it a sum says nothing of how many tiles were read; on this
    input every row has its own positive sum, and a tile that is skipped,
    read twice or swapped for another moves the result."""
    scale = torch.linspace(0.5, 1.5, x.shape[0], dtype=torch.float32,
                           device=x.device)[:, None]
    return (x.abs().to(torch.float32) * scale).to(x.dtype)


def dense_w(dtype) -> torch.Tensor:
    """A (128, 128) operand with no zero: w[k, j] = ((7k + 3j) % 16 + 1) / 16
    (exact in bfloat16), so every product of the tile matters."""
    k = torch.arange(mb.LANES, device=DEV)
    w = ((7 * k[:, None] + 3 * k[None, :]) % 16 + 1).to(torch.float32) / 16
    return w.to(dtype)


def tolerance(kernel: str, x: torch.Tensor, passes: int, expect,
              cancels: bool, depth: int = FMA_DEPTH) -> float:
    """Max abs error allowed between a kernel and its plain version.

    Sums (load_sum, fma, the mxu checksum) widen to float32 on both sides
    (for bfloat16 too: nothing is rounded to bfloat16 on either side) and add
    the same values in another order.  On the ramp input the terms are
    positive: ``SUM_RTOL`` of the expected value.  On the working set itself
    (``cancels``) the expected sum is about 0 and only an absolute bound has
    a meaning: the reference's own ``n * 1e-7 * 1.3`` per sweep, times the
    chain depth for fma (each link rounds once, and the kernel uses fused
    multiply-adds); that check shows agreement on the benchmark's real data,
    the ramp input shows that every tile is read once.
    load_only and the mxu y[0,0] sum add n_tiles * passes same-signed values
    in another order: ``SUM_RTOL`` on both inputs.  copy moves bits: 0.
    triad rounds once per operation on both sides: 1 ulp of the result
    (2.4e-7 float32, 2**-6 bfloat16 at |value| < 4) covers a double
    rounding."""
    if kernel in ("load_sum", "fma"):
        if not cancels:
            return SUM_RTOL * abs(float(expect))
        link = depth if kernel == "fma" else 1
        return max(x.numel() * 1e-7 * 1.3 * passes * link, 1e-4)
    if kernel == "load_only":
        return SUM_RTOL * abs(float(expect))
    if kernel == "copy":
        return 0.0
    if kernel == "triad":
        return 2.4e-7 if x.dtype == torch.float32 else 2.0**-6
    raise KeyError(kernel)


def run_pair(kernel: str, x, y, w, block_rows, streams, passes, unroll,
             interleave, depth: int = FMA_DEPTH):
    """(kernel result, plain result) for one configuration, on the card."""
    kw = dict(block_rows=block_rows, streams=streams, passes=passes,
              unroll=unroll)
    if kernel == "load_sum":
        return (mb.load_sum(x, interleave=interleave, **kw),
                mb.plain_load_sum(x, passes))
    if kernel == "load_only":
        return mb.load_only(x, **kw), mb.plain_load_only(x, block_rows, passes)
    if kernel == "fma":
        return mb.fma(x, depth, **kw), mb.plain_fma(x, depth, passes)
    if kernel == "mxu":
        return (mb.mxu(x, w, with_checksum=True, **kw),
                mb.plain_mxu(x, w, block_rows, passes))
    if kernel == "copy":
        return (mb.copy(x, interleave=interleave, **kw), mb.plain_copy(x))
    if kernel == "triad":
        return mb.triad(x, y, **kw), mb.plain_triad(x, y)
    raise KeyError(kernel)


def max_err(kernel: str, got, want, x, passes, cancels: bool,
            depth: int = FMA_DEPTH) -> tuple:
    """(max abs error, allowed, |expected value|) for one kernel result
    against its plain version; ``cancels`` says that x is the zero-sum
    working set and not the ramp input."""
    if kernel == "mxu":
        e0 = abs(float(got[0]) - float(want[0]))
        e1 = abs(float(got[1]) - float(want[1]))
        t0 = tolerance("load_only", x, passes, want[0], cancels)
        t1 = tolerance("load_sum", x, passes, want[1], cancels)
        # report the one that uses more of its allowance
        if e0 * t1 >= e1 * t0:
            return e0, t0, abs(float(want[0]))
        return e1, t1, abs(float(want[1]))
    if kernel in ("copy", "triad"):
        err = float((got.to(torch.float32) - want.to(torch.float32))
                    .abs().max())
        return (err, tolerance(kernel, x, passes, None, cancels),
                float(want.to(torch.float32).abs().max()))
    err = abs(float(got) - float(want))
    return (err, tolerance(kernel, x, passes, want, cancels, depth),
            abs(float(want)))


# ---------------------------------------------------------------------------
# phase 1 — device and build
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    say("== phase 1: device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(smi.splitlines()[0])
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    nvcc = subprocess.run([mb.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say("nvcc: " + nvcc[-2].strip() + " / " + nvcc[-1].strip())
    paths = mb.build_all()
    say(f"built {len(paths)} kernel libraries in "
        f"{mb.last_build_seconds:.1f} s -> {mb.build_dir()}")
    for src, path in paths.items():
        log = path.with_suffix(".log")
        regs, spills = [], 0
        if log.exists():
            for line in log.read_text().splitlines():
                if "Used" in line and "registers" in line:
                    regs.append(int(line.split("Used")[1].split()[0]))
                if "bytes spill stores" in line:
                    spills = max(spills, int(
                        line.split("bytes spill stores")[0].split()[-1]))
        say(f"  {src}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)}, "
            f"max spill stores {spills} B")
    props = torch.cuda.get_device_properties(DEV)
    say(f"SMs {props.multi_processor_count}, grid cap "
        f"{mb.CTAS_PER_SM} CTAs/SM x {props.multi_processor_count}")
    return {"smi": smi.splitlines()[0]}


# ---------------------------------------------------------------------------
# phase 2 — kernels against their plain versions
# ---------------------------------------------------------------------------

def _hold(kernel, label, x, y, w, block_rows, streams, passes, unroll,
          interleave, cancels, depth=FMA_DEPTH) -> tuple:
    """Run one kernel and its plain version; raise unless they agree.
    Returns (err, tolerance, |expected|)."""
    got, want = run_pair(kernel, x, y, w, block_rows, streams, passes, unroll,
                         interleave, depth)
    sync()
    err, tol, mag = max_err(kernel, got, want, x, passes, cancels, depth)
    if not err <= tol:
        raise AssertionError(
            f"{kernel} {label} block_rows={block_rows} streams={streams} "
            f"interleave={interleave} unroll={unroll} passes={passes} "
            f"depth={depth}: max abs err {err} > tolerance {tol} "
            f"(|expected| {mag})")
    return err, tol, mag


def phase_kernels(quick: bool) -> None:
    say("== phase 2: kernels against their plain versions on the card")
    sizes = (16 * KiB, 128 * KiB) if quick else (16 * KiB, 128 * KiB, 64 * MiB)
    worst: dict[str, tuple] = {}
    n_cases = 0
    for dname, dtype in DTYPES.items():
        eye = torch.eye(mb.LANES, dtype=dtype, device=DEV)
        dense = dense_w(dtype)
        for nbytes in sizes:
            cyc = working_set(nbytes, dtype=dtype, device=DEV)
            ramp = ramp_input(cyc)
            rows = cyc.shape[0]
            tilings = [(8, 1), (32, 2), (16, 4),
                       (mb.default_block_rows(rows), 1)]
            # (input name, x, y, w, x sums to zero)
            inputs = [("cycle", cyc, cyc * 0.5, eye, True),
                      ("ramp", ramp, ramp.flip(0) * 0.5, eye, False),
                      ("ramp*dense", ramp, None, dense, False)]
            for iname, x, y, w, cancels in inputs:
                for block_rows, streams in tilings:
                    if rows % (block_rows * streams):
                        continue
                    for kernel in BANDWIDTH_KERNELS:
                        if w is dense and kernel != "mxu":
                            continue          # the dense operand is mxu's only
                        ks = ((1, 2, 4) if kernel in ("load_sum", "copy")
                              else (1,))
                        for interleave in ks:
                            if block_rows % interleave:
                                continue
                            for unroll, passes in ((1, 1), (1, 8), (4, 4),
                                                   (4, 8)):
                                err, tol, mag = _hold(
                                    kernel, f"{dname} {nbytes}B {iname}", x,
                                    y, w, block_rows, streams, passes,
                                    unroll, interleave, cancels)
                                n_cases += 1
                                key = f"{kernel}/{dname}/{iname}"
                                frac = err / tol if tol else err
                                if key not in worst or frac > worst[key][0]:
                                    worst[key] = (frac, err, tol, mag, nbytes)
            del cyc, ramp, inputs, x, y
    for key, (_, err, tol, mag, nbytes) in sorted(worst.items()):
        say(f"  {key:30s} worst max_abs_err {err:.3e} (tolerance {tol:.3e}, "
            f"|expected| {mag:.3e}, at {nbytes} B)")
    say(f"  {n_cases} kernel-vs-plain cases agree")

    # the fma chain is as long as asked: at depth 8 the chain moves a value
    # by 1e-6 of itself, less than SUM_RTOL, so a wrong depth is held at a
    # depth where it shows (1024 links: 1.2e-4 of the value)
    for dname, dtype in DTYPES.items():
        x = ramp_input(working_set(128 * KiB, dtype=dtype, device=DEV))
        shallow = float(mb.plain_fma(x, FMA_DEPTH))
        for depth in (1, 1024):
            err, tol, mag = _hold("fma", f"{dname} 128KiB ramp", x, None,
                                  None, 16, 2, 2, 2, 1, False, depth)
        if not abs(mag / 2 - shallow) > 5 * tol:
            raise AssertionError(
                f"fma depth check has no power: depth 1024 gives {mag / 2}, "
                f"depth {FMA_DEPTH} gives {shallow}, tolerance {tol}")
        say(f"  fma/{dname} depth 1024: err {err:.3e} (tolerance {tol:.3e}; "
            f"depth {FMA_DEPTH} would be off by {abs(mag / 2 - shallow):.3e})")

    # determinism: the same launch twice is bit-identical
    for dname, dtype in DTYPES.items():
        x = ramp_input(working_set(sizes[-1], dtype=dtype, device=DEV))
        br = mb.default_block_rows(x.shape[0])
        w = dense_w(dtype)
        for kernel in BANDWIDTH_KERNELS:
            a, _ = run_pair(kernel, x, x * 0.5, w, br, 1, 4, 1, 1)
            b, _ = run_pair(kernel, x, x * 0.5, w, br, 1, 4, 1, 1)
            sync()
            if not torch.equal(a, b):
                raise AssertionError(f"{kernel}/{dname}: two runs differ")
    say("  two runs of every kernel are bit-identical")

    # every stream interleaving visits every tile exactly once: on the ramp
    # input each tile has its own sum, so a tile left out or visited twice
    # moves the result by far more than the tolerance
    x = ramp_input(working_set(64 * KiB, device=DEV))
    want = float(mb.plain_load_sum(x))
    outs = [float(mb.load_sum(x, block_rows=16, streams=s)) for s in (1, 2, 4)]
    if max(abs(o - want) for o in outs) > SUM_RTOL * abs(want):
        raise AssertionError(f"stream orders disagree: {outs} vs {want}")
    say(f"  load_sum over streams 1,2,4: {outs} (plain {want})")

    # the timed forms against the torch backend's oracles (same returned
    # scalar for the same passes / unroll), on a small input
    for dname, dtype in DTYPES.items():
        cyc = working_set(1 * MiB, dtype=dtype, device=DEV)
        for x, cancels in ((cyc, True), (ramp_input(cyc), False)):
            n, br = x.numel(), mb.default_block_rows(x.shape[0])
            for mix in ("load_sum", "fma_8", "mxu", "copy", "triad"):
                # the mxu oracle multiplies the whole buffer as ONE tile
                rows = x.shape[0] if mix == "mxu" else br
                for passes, unroll in ((4, 1), (4, 2)):
                    case = mb_ops.make_timed_kernel(
                        mix, block_rows=rows, passes=passes, unroll=unroll)
                    got = case(x, x * 0.5) if mix == "triad" else case(x)
                    want = im.run_mix(mix, x, passes, unroll=unroll)
                    sync()
                    depth = FMA_DEPTH if mix.startswith("fma") else 1
                    if cancels and mix in ("load_sum", "fma_8"):
                        tol = max(n * 1e-7 * 1.3 * passes * depth, 1e-4)
                    else:
                        # a few same-signed values (copy, triad, mxu) or a
                        # sum of positive terms
                        tol = SUM_RTOL * abs(float(want)) + (
                            (passes + unroll) * 2.0**-6
                            if mix == "triad" and dname == "bfloat16" else 0)
                    err = abs(float(got) - float(want))
                    if not err <= tol:
                        raise AssertionError(
                            f"timed {mix}/{dname} passes={passes} "
                            f"unroll={unroll} cancels={cancels}: "
                            f"{float(got)} vs oracle {float(want)} "
                            f"(tolerance {tol})")
    say("  timed forms agree with the torch backend's oracles")


def chase_buffer(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """The chase path's buffer for x: one ``chase_perm`` cycle per tile."""
    return torch.tensor(im.chase_perm(x.shape, x.shape[0] // block_rows),
                        device=DEV)


def off_cycle_perm(shape, block_rows: int, seed: int) -> torch.Tensor:
    """An int32 buffer whose every tile of m entries holds a permutation
    that is NOT one full cycle: 0 lies on a seeded random cycle of seeded
    length c, m/2 < c <= 3m/4, and the other indices on a second cycle.  A
    walk of k steps from 0 ends k mod c entries along 0's cycle, so the
    walk of m = block_rows * 128 steps ends m - c (m/4 .. m/2) entries
    along it, and a walk of any k not congruent to m mod c (one load per
    tile, a skipped or repeated step, 2m - 1, ...) ends elsewhere; on
    ``chase_perm`` every walk ends at 0, which a kernel doing nothing also
    returns."""
    rng = np.random.default_rng(seed)
    rows, lanes = shape
    m = block_rows * lanes
    flat = np.empty(rows * lanes, dtype=np.int32)
    for t in range(rows // block_rows):
        c = int(rng.integers(m // 2 + 1, 3 * m // 4 + 1))
        rest = rng.permutation(np.arange(1, m))
        seg = np.empty(m, dtype=np.int32)
        for cyc in (np.concatenate([[0], rest[:c - 1]]), rest[c - 1:]):
            seg[cyc] = np.roll(cyc, -1)
        flat[t * m:(t + 1) * m] = seg
    return torch.tensor(flat.reshape(rows, lanes), device=DEV)


def rw_value(x, reads: int) -> torch.Tensor:
    """The value every output of an rw call on x holds (plain version)."""
    return mb.plain_rw(x, *im.rw_streams(x, reads)[1:], writes=1)[0]


def phase_rw_chase(quick: bool) -> None:
    say("== phase 2b: rw and chase against their plain versions on the card")
    sizes = (16 * KiB, 128 * KiB) if quick else (16 * KiB, 128 * KiB, 64 * MiB)
    n_rw = 0
    for dname, dtype in DTYPES.items():
        for nbytes in sizes:
            cyc = working_set(nbytes, dtype=dtype, device=DEV)
            rows = cyc.shape[0]
            tilings = [(8, 1), (32, 2), (16, 4),
                       (mb.default_block_rows(rows), 1)]
            for iname, x in (("cycle", cyc), ("ramp", ramp_input(cyc))):
                for reads, writes in RW_LADDER + RW_CORNERS:
                    ys = im.rw_streams(x, reads)[1:]
                    want = mb.plain_rw(x, *ys, writes=1)[0]
                    for block_rows, streams in tilings:
                        if rows % (block_rows * streams):
                            continue
                        for interleave in (1, 2, 4):
                            if block_rows % interleave:
                                continue
                            for unroll, passes in ((1, 1), (1, 8), (4, 4),
                                                   (4, 8)):
                                outs = mb.rw(
                                    x, *ys, reads=reads, writes=writes,
                                    block_rows=block_rows, streams=streams,
                                    passes=passes, unroll=unroll,
                                    interleave=interleave)
                                sync()
                                # tolerance 0: both sides round once per
                                # operation in the working dtype
                                if not all(torch.equal(o, want)
                                           for o in outs):
                                    raise AssertionError(
                                        f"rw {reads}:{writes} {dname} "
                                        f"{nbytes}B {iname} block_rows="
                                        f"{block_rows} streams={streams} "
                                        f"interleave={interleave} unroll="
                                        f"{unroll} passes={passes}: not "
                                        f"bit-identical to plain_rw")
                                n_rw += 1
                    del ys, want
                # the family generalises copy and triad, bit for bit
                br = mb.default_block_rows(rows)
                (one,) = mb.rw(x, reads=1, writes=1, block_rows=br)
                (two,) = mb.rw(x, x * 0.5, reads=2, writes=1, block_rows=br)
                if not (torch.equal(one, mb.copy(x, block_rows=br))
                        and torch.equal(two, mb.triad(x, x * 0.5,
                                                      block_rows=br))):
                    raise AssertionError(f"rw_1to1 / rw_2to1 differ from "
                                         f"copy / triad ({dname} {nbytes}B "
                                         f"{iname})")
            del cyc, x
    say(f"  {n_rw} rw cases bit-identical to plain_rw (max_abs_err 0); "
        f"rw_1to1 == copy and rw_2to1 == triad bit for bit")

    n_chase = 0
    for nbytes in (16 * KiB, 128 * KiB, 1 * MiB):
        x = working_set(nbytes, device=DEV)
        rows = x.shape[0]
        for block_rows, streams in ((8, 1), (32, 2), (16, 4),
                                    (mb.default_block_rows(rows), 1)):
            if rows % (block_rows * streams):
                continue
            full = chase_buffer(x, block_rows)
            off = off_cycle_perm(x.shape, block_rows, seed=block_rows)
            for unroll, passes in ((1, 1), (1, 8), (4, 4), (4, 8)):
                kw = dict(block_rows=block_rows, streams=streams,
                          passes=passes)
                got = float(mb.chase(full, unroll=unroll, **kw))
                if got != 0.0 or float(mb.plain_chase(full, **kw)) != 0.0:
                    raise AssertionError(f"chase on chase_perm gives {got}, "
                                         f"not 0.0 ({nbytes}B {kw})")
                got = float(mb.chase(off, unroll=unroll, **kw))
                want = float(mb.plain_chase(off, **kw))
                # exact: integers below 2**24, folded in the same order
                if got != want or want == 0.0:
                    raise AssertionError(f"chase on an off-cycle perm: "
                                         f"{got} vs plain {want} "
                                         f"({nbytes}B {kw})")
                n_chase += 2
    say(f"  {n_chase} chase cases: 0.0 on chase_perm, exactly the plain "
        f"value (last: {want}) on off-cycle permutations")

    # the wrapper checks its buffer once, and again after it was written to:
    # an index outside its tile never reaches the kernel
    perm = chase_buffer(working_set(16 * KiB, device=DEV), 8)
    mb.chase(perm, block_rows=8)
    perm[3, 3] = 8 * mb.LANES               # tile 0 now points into tile 1
    try:
        mb.chase(perm, block_rows=8)
    except ValueError:
        pass
    else:
        raise AssertionError("chase launched on a perm with an index "
                             "outside its tile")
    say("  chase refuses a buffer written out of its tile after a first "
        "clean call")

    # the loaded composite: probe + generator sweeps, against the plain
    # composition and the torch oracle, on the non-cancelling generator
    x = working_set(128 * KiB, device=DEV)
    gen = ramp_input(x)
    br = mb.default_block_rows(x.shape[0])
    full, off = chase_buffer(x, br), off_cycle_perm(x.shape, br, seed=7)
    for load in (1, 4):
        for passes, unroll in ((2, 1), (4, 2)):
            case = mb_ops.make_timed_kernel("latency_chase", block_rows=br,
                                            passes=passes, unroll=unroll,
                                            load=load)
            gsum = float(mb.plain_load_sum(gen))
            sweeps = load * GEN_SWEEPS_PER_PASS
            for perm in (full, off):
                got = float(case(perm, gen))
                want = passes * (float(mb.plain_chase(perm, br))
                                 + sweeps * gsum)
                if not abs(got - want) <= SUM_RTOL * abs(want):
                    raise AssertionError(f"loaded composite load={load} "
                                         f"passes={passes}: {got} vs {want}")
            oracle = float(im.k_chase_loaded(
                torch.tensor(im.chase_perm(x.shape), device=DEV), gen,
                passes, unroll, load=load))
            want = passes * sweeps * gsum
            if not abs(oracle - want) <= SUM_RTOL * want:
                raise AssertionError(f"k_chase_loaded load={load}: {oracle} "
                                     f"vs {want}")
    say("  loaded composite (load 1, 4) agrees with the plain composition "
        "and k_chase_loaded to SUM_RTOL")

    # determinism: the same launch twice is bit-identical
    for dname, dtype in DTYPES.items():
        x = ramp_input(working_set(sizes[-1], dtype=dtype, device=DEV))
        br = mb.default_block_rows(x.shape[0])
        ys = im.rw_streams(x, 3)[1:]
        a = mb.rw(x, *ys, reads=3, writes=2, block_rows=br, passes=2)
        b = mb.rw(x, *ys, reads=3, writes=2, block_rows=br, passes=2)
        sync()
        if not all(torch.equal(p, q) for p, q in zip(a, b)):
            raise AssertionError(f"rw/{dname}: two runs differ")
    off = off_cycle_perm(working_set(1 * MiB, device=DEV).shape, 128, seed=3)
    if not torch.equal(mb.chase(off, block_rows=128, passes=2),
                       mb.chase(off, block_rows=128, passes=2)):
        raise AssertionError("chase: two runs differ")
    say("  two runs of rw and of chase are bit-identical")

    # the timed forms against the torch backend's oracles, each with its own
    # convention for the rw scalar (cuda = the reference's Pallas kernel:
    # passes * W * v[0,0] + unroll * W * v[-1,-1]; torch = its xla oracle:
    # passes * v[0,0] + W * unroll * v[-1,-1])
    for dname, dtype in DTYPES.items():
        x = working_set(1 * MiB, dtype=dtype, device=DEV)
        br = mb.default_block_rows(x.shape[0])
        for reads, writes in RW_LADDER:
            mix = rw_name(reads, writes)
            v = rw_value(x, reads).to(torch.float32)
            first, last = float(v[0, 0]), float(v[-1, -1])
            for passes, unroll in ((4, 1), (4, 2)):
                got = float(mb_ops.make_timed_kernel(
                    mix, block_rows=br, passes=passes, unroll=unroll)(
                    x, *im.rw_streams(x, reads)[1:]))
                oracle = float(im.run_mix(mix, x, passes, unroll=unroll))
                for name, value, want in (
                        ("cuda", got, writes * (passes * first
                                                + unroll * last)),
                        ("torch", oracle, passes * first
                         + writes * unroll * last)):
                    if not abs(value - want) <= SUM_RTOL * abs(want) + 1e-6:
                        raise AssertionError(
                            f"timed {mix}/{dname} {name} passes={passes} "
                            f"unroll={unroll}: {value} vs {want}")
        if dname == "float32":
            full = chase_buffer(x, br)
            got = float(mb_ops.make_timed_kernel(
                "latency_chase", block_rows=br, passes=4)(full))
            oracle = float(im.run_mix("latency_chase", x, 4))
            if got != 0.0 or oracle != 0.0:
                raise AssertionError(f"timed latency_chase: cuda {got}, "
                                     f"torch {oracle}, both must be 0.0")
    say("  timed rw and chase forms agree with the torch backend's oracles")


# ---------------------------------------------------------------------------
# phase 3 — the main path
# ---------------------------------------------------------------------------

MAIN_MIXES = "load_only,load_sum,fma_8,mxu,copy,triad"


def _cli(argv: list[str]) -> tuple[int, str]:
    """Run the CLI in this process; returns (exit code, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def read_counts(kernels, path: str) -> dict[str, int]:
    """The launch counters just after a main path ran (they were set to 0
    just before it); raises unless each of ``kernels`` launched."""
    counts = dict(mb.launch_counts)
    say(f"  launches on the main path ({path}): {counts}")
    for name in kernels:
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 f"main path ({path})")
    return counts


def _check_result(path: Path, mixes: list[str], n_sizes: int, dtype: str
                  ) -> BenchResult:
    doc = json.loads(path.read_text())
    for key in ("schema_version", "points", "machine", "spec", "meta"):
        if key not in doc:
            raise AssertionError(f"{path}: result JSON lacks {key!r}")
    if doc["schema_version"] != 6:
        raise AssertionError(f"schema_version {doc['schema_version']} != 6")
    res = BenchResult.from_json(path)
    if len(res.points) != len(mixes) * n_sizes:
        raise AssertionError(f"{len(res.points)} points, expected "
                             f"{len(mixes) * n_sizes}")
    if res.machine.get("device_platform") != "gpu":
        raise AssertionError(f"machine: {res.machine}")
    isz = 4 if dtype == "float32" else 2
    for p in res.points:
        mix = get_mix(p.mix)
        ok = (p.backend == "cuda" and p.dtype == dtype
              and all(math.isfinite(v) and v > 0
                      for v in (p.mean_s, p.min_s, p.gbps))
              and p.bytes_per_call == mix.bytes_per_pass(p.nbytes) * p.passes
              and p.flops_per_call
              == mix.flops_per_pass(p.nbytes // isz) * p.passes
              and len(p.rep_times_s) == p.reps)
        if not ok:
            raise AssertionError(f"bad point: {p}")
        say(f"  {p.backend}/{p.mix}/{p.dtype}/{p.nbytes}B  "
            f"{p.mean_s * 1e6:.2f} us  {p.gbps:.2f} GB/s  "
            f"{p.gflops:.2f} GFLOP/s  passes={p.passes}")
    return res


def phase_main_path(quick: bool) -> dict[str, int]:
    say("== phase 3: the main path (python -m repro_torch.bench run "
        "--backend cuda)")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    mixes = MAIN_MIXES.split(",")
    common = ["--backend", "cuda", "--mixes", MAIN_MIXES, "--force",
              "--history-root", str(OUT_DIR / "BENCH_history")]
    runs = ([("float32", "32K,1M,16M"), ("bfloat16", "16M")] if quick else
            [("float32", "32K,1M,16M,256M,2G"), ("bfloat16", "16M,2G")])
    mb.reset_launch_counts()
    for dtype, sizes in runs:
        out = OUT_DIR / f"run_{dtype}.json"
        t0 = time.perf_counter()
        rc, text = _cli(["run", *common, "--dtype", dtype, "--sizes", sizes,
                         "--out", str(out)])
        sync()
        if rc != 0:
            raise AssertionError(f"run exited {rc}:\n{text}")
        say(f"  run {dtype} {sizes}: {time.perf_counter() - t0:.1f} s")
        _check_result(out, mixes, len(sizes.split(",")), dtype)
    counts = read_counts(BANDWIDTH_KERNELS, "run " + MAIN_MIXES)

    # the same entry point with span tracing on (kept apart from the runs
    # above, whose times are reported)
    rc, text = _cli(["run", *common, "--quick", "--out",
                     str(OUT_DIR / "run_traced.json"), "--trace",
                     str(OUT_DIR / "trace.json")])
    cli.trace.configure(enabled=False)
    if rc != 0 or "# saved trace" not in text:
        raise AssertionError(f"traced run exited {rc}:\n{text}")
    say("  traced run: " + [l for l in text.splitlines()
                            if l.startswith("# saved trace")][0])

    sizes = "1M,16M" if quick else "1M,256M"
    rc, text = _cli(["compare", "--backends", "torch,cuda", "--mixes",
                     MAIN_MIXES, "--sizes", sizes, "--reps", "3", "--force",
                     "--out", str(OUT_DIR / "compare.json")])
    say("  " + text.rstrip().replace("\n", "\n  "))
    if rc != 0:
        raise AssertionError(f"compare exited {rc} (accounting mismatch)")
    if "# skipped torch/load_only" not in text:
        raise AssertionError("compare did not report load_only as skipped "
                             "on torch")
    check_compare(OUT_DIR / "compare.json", skipped_on_torch={"load_only"})
    return counts


def check_compare(path: Path, skipped_on_torch=frozenset()) -> None:
    """Every point of a ``compare --backends torch,cuda`` result has the same
    bytes_per_call / flops_per_call / passes on both backends."""
    both = json.loads(path.read_text())
    tp = {(p["mix"], p["nbytes"], p["load"]): p
          for p in both["torch"]["points"]}
    for p in both["cuda"]["points"]:
        q = tp.get((p["mix"], p["nbytes"], p["load"]))
        if q is None:
            if p["mix"] not in skipped_on_torch:
                raise AssertionError(f"torch lacks {p['mix']}")
            continue
        for k in ("bytes_per_call", "flops_per_call", "passes"):
            if p[k] != q[k]:
                raise AssertionError(f"{p['mix']}/{p['nbytes']}: {k} "
                                     f"{p[k]} != {q[k]}")
    say(f"  torch and cuda agree on bytes_per_call / flops_per_call / passes "
        f"({len(both['cuda']['points'])} points)")


def phase_rw_path(quick: bool) -> dict[str, int]:
    say("== phase 3b: the rw path (python -m repro_torch.bench run --backend "
        "cuda --mixes " + RW_MIXES + ")")
    common = ["--backend", "cuda", "--mixes", RW_MIXES, "--force",
              "--history-root", str(OUT_DIR / "BENCH_history")]
    runs = ([("float32", "32K,1M,16M"), ("bfloat16", "16M")] if quick else
            [("float32", "32K,1M,16M,256M,2G"), ("bfloat16", "16M,2G")])
    mb.reset_launch_counts()
    for dtype, sizes in runs:
        out = OUT_DIR / f"run_rw_{dtype}.json"
        t0 = time.perf_counter()
        rc, text = _cli(["run", *common, "--dtype", dtype, "--sizes", sizes,
                         "--out", str(out)])
        sync()
        if rc != 0:
            raise AssertionError(f"run exited {rc}:\n{text}")
        say(f"  run {dtype} {sizes}: {time.perf_counter() - t0:.1f} s")
        _check_result(out, RW_MIXES.split(","), len(sizes.split(",")), dtype)
    return read_counts(("rw",), "run " + RW_MIXES)


def phase_latency_path(quick: bool) -> dict[str, int]:
    say("== phase 3c: the latency path (python -m repro_torch.bench latency "
        "--backend cuda)")
    out = OUT_DIR / "latency.json"
    mb.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text = _cli(["latency", "--backend", "cuda", "--out", str(out),
                     "--force", "--history-root",
                     str(OUT_DIR / "BENCH_history")]
                    + (["--smoke"] if quick else []))
    sync()
    if rc != 0:
        raise AssertionError(f"latency exited {rc}:\n{text}")
    counts = read_counts(("chase", "load_sum"), "latency")
    say(f"  latency: {time.perf_counter() - t0:.1f} s")
    say("  " + text.rstrip().replace("\n", "\n  "))
    res = BenchResult.from_json(out)
    sizes, loads = ((1,), (0, 1, 2)) if quick else ((2,), (0, 1, 2, 4))
    if len(res.points) != sizes[0] * len(loads) \
            or {p.load for p in res.points} != set(loads):
        raise AssertionError(f"latency result: {len(res.points)} points, "
                             f"loads {sorted({p.load for p in res.points})}")
    idle = {p.nbytes: p for p in res.points if p.load == 0}
    for p in res.points:
        ok = (p.backend == "cuda" and p.mix == "latency_chase"
              and p.latency_ns is not None and p.latency_ns > 0
              and math.isfinite(p.latency_ns)
              and (p.gen_gbps == 0.0 if p.load == 0 else p.gen_gbps > 0)
              and p.bytes_per_call == idle[p.nbytes].bytes_per_call
              * (1 + p.load * GEN_SWEEPS_PER_PASS)
              and len(p.rep_times_s) == p.reps)
        if not ok:
            raise AssertionError(f"bad latency point: {p}")
    if not res.meta.get("loaded_latency", {}).get("fit"):
        raise AssertionError("latency result carries no knee fit")
    say("  latency result: every point has latency_ns > 0, gen_gbps 0 idle "
        "and > 0 loaded, bytes_per_call = idle x (1 + load x 16)")

    rc, text = _cli(["compare", "--backends", "torch,cuda", "--mixes",
                     RW_MIXES + ",latency_chase", "--sizes", "1M", "--reps",
                     "3", "--force", "--out",
                     str(OUT_DIR / "compare_rw_chase.json")])
    say("  " + text.rstrip().replace("\n", "\n  "))
    if rc != 0:
        raise AssertionError(f"compare exited {rc} (accounting mismatch)")
    check_compare(OUT_DIR / "compare_rw_chase.json")
    return counts


# ---------------------------------------------------------------------------
# timing helpers (CUDA events) for phases 4 and 5
# ---------------------------------------------------------------------------

def time_both_ms(fn, n: int, warmup: int = 2) -> tuple[float, float]:
    """(device, host) mean milliseconds per call over ``n`` back-to-back
    calls: CUDA events around the run, and the host's clock around the
    enqueueing loop alone (what the wrapper and the launches cost the host;
    where it exceeds the device's share the run is bound by the host)."""
    for _ in range(warmup):
        fn()
    sync()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    host = (time.perf_counter() - h0) * 1e3 / n
    sync()
    return t0.elapsed_time(t1) / n, host


def time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``n`` back-to-back calls."""
    return time_both_ms(fn, n, warmup)[0]


def kernel_fn(kernel: str, x, y, w, out, passes: int):
    kw = dict(block_rows=mb.default_block_rows(x.shape[0]), passes=passes)
    return {
        "load_sum": lambda: mb.load_sum(x, **kw),
        "load_only": lambda: mb.load_only(x, **kw),
        "fma": lambda: mb.fma(x, FMA_DEPTH, **kw),
        "mxu": lambda: mb.mxu(x, w, **kw),
        "copy": lambda: mb.copy(x, out, **kw),
        "triad": lambda: mb.triad(x, y, out, **kw),
    }[kernel]


def work(kernel: str, x) -> tuple[float, float]:
    """(bytes, flops) of one sweep, from the shared mix registry."""
    name = f"fma_{FMA_DEPTH}" if kernel == "fma" else kernel
    return mb_ops.work_per_call(name, x)


# ---------------------------------------------------------------------------
# phase 4 — the measurement is real
# ---------------------------------------------------------------------------

#: a timed call of phase 4 must last at least this long, so that the host's
#: share of a call (two allocations, two launches: tens of microseconds) is
#: small against the kernel's
REAL_MIN_MS = 2.0


def phase_real(quick: bool) -> None:
    say("== phase 4: the measurement is real")
    sizes = (16 * MiB,) if quick else (16 * MiB, 2 * GiB)
    for nbytes in sizes:
        x = working_set(nbytes, device=DEV)
        y, out = x * 0.5, torch.empty_like(x)
        w = torch.eye(mb.LANES, dtype=x.dtype, device=DEV)
        n = 5 if nbytes <= 16 * MiB else 3
        for kernel in BANDWIDTH_KERNELS:
            # the smallest power-of-two pass count whose call lasts
            # REAL_MIN_MS; at 2 GiB one pass already does
            passes, t1 = 1, time_ms(kernel_fn(kernel, x, y, w, out, 1), n)
            while t1 < REAL_MIN_MS and passes < 2**16:
                passes *= 2
                t1 = time_ms(kernel_fn(kernel, x, y, w, out, passes), n)
            t2 = time_ms(kernel_fn(kernel, x, y, w, out, 2 * passes), n)
            ratio = t2 / t1
            nb, nf = work(kernel, x)
            gbps = nb * 2 * passes / (t2 * 1e-3) / 1e9
            tflops = nf * 2 * passes / (t2 * 1e-3) / 1e12
            say(f"  {kernel:9s} {nbytes:>11d} B  passes {passes}->"
                f"{2 * passes}: {t1:.4f} -> {t2:.4f} ms  ratio {ratio:.3f}  "
                f"{gbps:.1f} GB/s  {tflops:.2f} TFLOP/s")
            if not 1.7 <= ratio <= 2.3:
                raise AssertionError(
                    f"{kernel} at {nbytes} B: time at 2x passes is "
                    f"{ratio:.3f}x the time at 1x (expected 1.7..2.3): the "
                    f"pass loop does not do what it is accounted for")
            if nbytes >= 2 * GiB and gbps > HBM_BYTES_PER_S / 1e9 * 1.02:
                raise AssertionError(
                    f"{kernel} at {nbytes} B reports {gbps:.1f} GB/s, above "
                    f"the card's memory rate: some traffic is not executed")
            if kernel == "mxu" and tflops * 1e12 >= PEAK_FLOPS["float32"]:
                raise AssertionError(
                    f"mxu reports {tflops:.1f} TFLOP/s, above the float32 "
                    f"peak: part of the product is not computed")
        del x, y, out


def doubled(make_fn, n: int, min_ms: float = REAL_MIN_MS
            ) -> tuple[int, float, float]:
    """(passes, ms at passes, ms at 2 x passes) for the smallest power-of-two
    pass count whose call lasts ``min_ms``; ``make_fn(passes)`` gives the
    call."""
    passes, t1 = 1, time_ms(make_fn(1), n)
    while t1 < min_ms and passes < 2**16:
        passes *= 2
        t1 = time_ms(make_fn(passes), n)
    return passes, t1, time_ms(make_fn(2 * passes), n)


def check_ratio(what: str, t1: float, t2: float) -> None:
    if not 1.7 <= t2 / t1 <= 2.3:
        raise AssertionError(
            f"{what}: time at 2x passes is {t2 / t1:.3f}x the time at 1x "
            f"(expected 1.7..2.3): the pass loop does not do what it is "
            f"accounted for")


def phase_real_rw_chase(quick: bool) -> None:
    say("== phase 4b: the rw and chase measurements are real")
    for nbytes in (16 * MiB,) if quick else (16 * MiB, 2 * GiB):
        x = working_set(nbytes, device=DEV)
        br = mb.default_block_rows(x.shape[0])
        n = 5 if nbytes <= 16 * MiB else 3
        for reads, writes in RW_LADDER:
            ys = im.rw_streams(x, reads)[1:]
            outs = tuple(torch.empty_like(x) for _ in range(writes))
            passes, t1, t2 = doubled(lambda p: lambda: mb.rw(
                x, *ys, reads=reads, writes=writes, outs=outs,
                block_rows=br, passes=p), n)
            nb = (reads + writes) * x.numel() * x.element_size()
            gbps = nb * 2 * passes / (t2 * 1e-3) / 1e9
            say(f"  rw_{reads}to{writes} {nbytes:>11d} B  passes {passes}->"
                f"{2 * passes}: {t1:.4f} -> {t2:.4f} ms  ratio "
                f"{t2 / t1:.3f}  {gbps:.1f} GB/s")
            check_ratio(f"rw_{reads}to{writes} at {nbytes} B", t1, t2)
            if nbytes >= 2 * GiB and gbps > HBM_BYTES_PER_S / 1e9 * 1.02:
                raise AssertionError(
                    f"rw_{reads}to{writes} at {nbytes} B reports {gbps:.1f} "
                    f"GB/s, above the card's memory rate: some traffic is "
                    f"not executed")
            del ys, outs
        del x
        torch.cuda.empty_cache()

    # the chase: twice the passes take twice the time, and a step takes at
    # least 5 ns — a dependent load cannot complete faster than an L1 hit
    # (tens of cycles); less would mean that steps overlap.  Every pass is a
    # launch of its own and starts from the same (cold) L1.
    x = working_set(128 * KiB, device=DEV)
    br = mb.default_block_rows(x.shape[0])
    perm, steps = chase_buffer(x, br), x.numel()
    passes, t1, t2 = doubled(lambda p: lambda: mb.chase(
        perm, block_rows=br, passes=p), 5)
    ns = t2 * 1e6 / (2 * passes * steps)
    say(f"  chase {x.numel() * 4:>11d} B  passes {passes}->{2 * passes}: "
        f"{t1:.4f} -> {t2:.4f} ms  ratio {t2 / t1:.3f}  {ns:.3f} ns/step")
    check_ratio("chase", t1, t2)
    if ns < 5.0:
        raise AssertionError(f"chase: {ns:.3f} ns per dependent step, below "
                             f"5 ns: the steps overlap")

    # loaded latency: the time-shared composite at load=4 spends every probe
    # pass's time plus 64 generator sweeps, so per step it is not below idle
    lat = {}
    for load in (0, 4):
        case = mb_ops.make_timed_kernel("latency_chase", block_rows=br,
                                        passes=passes, load=load)
        fn = (lambda: case(perm, x)) if load else (lambda: case(perm))
        lat[load] = time_ms(fn, 5) * 1e6 / (passes * steps)
    say(f"  latency per step at 128 KiB: idle {lat[0]:.3f} ns, load=4 "
        f"{lat[4]:.3f} ns")
    if lat[4] < lat[0]:
        raise AssertionError(f"loaded latency {lat[4]} ns below idle "
                             f"{lat[0]} ns")


# ---------------------------------------------------------------------------
# phase 5 — the kernels line
# ---------------------------------------------------------------------------

def phase_kernels_line(counts: dict[str, int], quick: bool) -> dict:
    say("== phase 5: kernel times, plain versions, library calls, bounds")
    shapes = ([("float32", 16 * MiB)] if quick else
              [("float32", 16 * MiB), ("float32", 2 * GiB),
               ("bfloat16", 2 * GiB)])
    entries = []
    for dname, nbytes in shapes:
        dtype = DTYPES[dname]
        x = working_set(nbytes, dtype=dtype, device=DEV)
        y, out = x * 0.5, torch.empty_like(x)
        w = torch.eye(mb.LANES, dtype=dtype, device=DEV)
        xr = ramp_input(x)
        yr, wd = xr.flip(0) * 0.5, dense_w(dtype)
        br = mb.default_block_rows(x.shape[0])
        n = 20 if nbytes <= 16 * MiB else 3
        plain = {
            "load_sum": lambda: mb.plain_load_sum(x),
            "load_only": lambda: mb.plain_load_only(x, br),
            "fma": lambda: mb.plain_fma(x, FMA_DEPTH),
            "mxu": lambda: mb.plain_mxu(x, w, br),
            "copy": lambda: mb.plain_copy(x, out),
            "triad": lambda: mb.plain_triad(x, y, out),
        }
        # one PyTorch call computing the same function, where there is one;
        # timed here as a yardstick and used nowhere in the package
        library = {
            "load_sum": lambda: x.sum(dtype=torch.float32),
            "load_only": None,
            "fma": None,
            "mxu": lambda: torch.matmul(x, w),
            "copy": lambda: out.copy_(x),
            "triad": lambda: torch.add(x, y, alpha=1.5, out=out),
        }
        for kernel in BANDWIDTH_KERNELS:
            # held on the working set the timed runs use (its sums cancel:
            # absolute bound) and on the ramp input with mxu's dense operand
            # (relative bound; the error and tolerance the line reports)
            label = f"{dname} {nbytes}B"
            _hold(kernel, label + " cycle", x, y, w, br, 1, 1, 1, 1, True)
            err, tol, mag = _hold(kernel, label + " ramp", xr, yr, wd, br,
                                  1, 1, 1, 1, False)
            ms, host_ms = time_both_ms(kernel_fn(kernel, x, y, w, out, 1), n)
            plain_ms = time_ms(plain[kernel], n)
            lib = library[kernel]
            library_ms = time_ms(lib, n) if lib is not None else None
            nb, nf = work(kernel, x)
            peak = (PEAK_FLOPS["bfloat16_tensor"]
                    if kernel == "mxu" and dname == "bfloat16"
                    else PEAK_FLOPS["float32"])
            t_bytes, t_ops = nb / HBM_BYTES_PER_S, nf / peak
            entries.append({
                "name": kernel, "route": "cuda",
                "source": "src/repro_torch/kernels/membench/csrc/"
                          + mb.SOURCES[kernel],
                "replaces": REPLACES[kernel],
                "launches": counts.get(kernel, 0),
                "max_abs_err": err, "tolerance": tol, "expected_abs": mag,
                "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms,
                **({"bound_ms_tf32": max(
                    t_bytes, nf / PEAK_FLOPS["tf32_tensor"]) * 1e3}
                   if kernel == "mxu" and dname == "float32" else {}),
                "shape": list(x.shape), "dtype": dname, "nbytes": nbytes,
                "block_rows": br, "passes": 1,
            })
            e = entries[-1]
            say(f"  {kernel:9s} {dname:8s} {nbytes:>11d} B  ms {ms:.4f}  "
                f"(host {host_ms:.4f})  bound {e['bound_ms']:.4f} "
                f"({e['bound_by']})  plain {plain_ms:.4f}  library "
                f"{'-' if library_ms is None else f'{library_ms:.4f}'}  "
                f"err {err:.2e} of {mag:.3e} (tolerance {tol:.2e})")
        entries += rw_entries(x, xr, dname, nbytes, n, counts["rw"])
        del x, y, out, xr, yr
        torch.cuda.empty_cache()
    for nbytes in (128 * KiB,) if quick else (128 * KiB, 16 * MiB):
        entries.append(chase_entry(nbytes, counts["chase"]))
    return {"kernels": entries}


def rw_entries(x, xr, dname: str, nbytes: int, n: int, launches: int
               ) -> list[dict]:
    """One ``kernels`` entry per member of the rw ladder on x (one sweep at
    the default tiling), each held bit for bit on the ramp input xr."""
    br = mb.default_block_rows(x.shape[0])
    entries = []
    for reads, writes in RW_LADDER:
        yrs = im.rw_streams(xr, reads)[1:]
        want = mb.plain_rw(xr, *yrs, writes=1)[0].to(torch.float32)
        err = max(float((o.to(torch.float32) - want).abs().max())
                  for o in mb.rw(xr, *yrs, reads=reads, writes=writes,
                                 block_rows=br))
        if err != 0.0:
            raise AssertionError(f"rw_{reads}to{writes} {dname} {nbytes}B "
                                 f"ramp: max abs err {err}, tolerance 0")
        del yrs, want
        ys = im.rw_streams(x, reads)[1:]
        outs = tuple(torch.empty_like(x) for _ in range(writes))
        ms, host_ms = time_both_ms(lambda: mb.rw(
            x, *ys, reads=reads, writes=writes, outs=outs, block_rows=br), n)
        plain_ms = time_ms(lambda: mb.plain_rw(x, *ys, writes=writes,
                                               outs=outs), n)
        # one PyTorch call computing the same function, where there is one
        lib = {(1, 1): lambda: outs[0].copy_(x),
               (2, 1): lambda: torch.add(x, ys[0], alpha=1.5, out=outs[0]),
               }.get((reads, writes))
        library_ms = time_ms(lib, n) if lib is not None else None
        mix = get_mix(rw_name(reads, writes))
        nb = mix.bytes_per_pass(x.numel() * x.element_size())
        t_bytes = nb / HBM_BYTES_PER_S
        t_ops = mix.flops_per_pass(x.numel()) / PEAK_FLOPS["float32"]
        entries.append({
            "name": "rw", "mix": mix.name, "route": "cuda",
            "source": "src/repro_torch/kernels/membench/csrc/rw.cu",
            "replaces": REPLACES["rw"], "launches": launches,
            "max_abs_err": err, "tolerance": 0.0,
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "shape": list(x.shape), "dtype": dname, "nbytes": nbytes,
            "block_rows": br, "passes": 1,
        })
        e = entries[-1]
        say(f"  {mix.name:9s} {dname:8s} {nbytes:>11d} B  ms {ms:.4f}  "
            f"(host {host_ms:.4f})  bound {e['bound_ms']:.4f} "
            f"({e['bound_by']})  plain {plain_ms:.4f}  library "
            f"{'-' if library_ms is None else f'{library_ms:.4f}'}  "
            f"err {err:.1f}")
        del ys, outs
    return entries


def chase_entry(nbytes: int, launches: int) -> dict:
    """The ``kernels`` entry of the idle chase on a float32 working set of
    ``nbytes`` (one pass at the default tiling), held exactly against its
    plain version on an off-cycle permutation.  Its bound is the load
    latency, which no data-sheet rate states: ``bound_ms`` is the bytes rule
    (the int32 buffer read once at the memory rate), far below it, and
    ``ns_per_step`` is what the walk measured."""
    x = working_set(nbytes, device=DEV)
    br = mb.default_block_rows(x.shape[0])
    perm = chase_buffer(x, br)
    off = off_cycle_perm(x.shape, br, seed=11)
    got, want = float(mb.chase(off, block_rows=br)), \
        float(mb.plain_chase(off, br))
    if got != want:
        raise AssertionError(f"chase {nbytes}B off-cycle: {got} vs {want}")
    n = 5 if nbytes <= 128 * KiB else 3
    ms, host_ms = time_both_ms(lambda: mb.chase(perm, block_rows=br), n)
    plain_ms = time_ms(lambda: mb.plain_chase(perm, br), n)
    nb = perm.numel() * perm.element_size()
    e = {
        "name": "chase", "mix": "latency_chase", "route": "cuda",
        "source": "src/repro_torch/kernels/membench/csrc/chase.cu",
        "replaces": REPLACES["chase"], "launches": launches,
        "max_abs_err": abs(got - want), "tolerance": 0.0, "expected_abs": want,
        "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
        "bound_ms": nb / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bound_note": "load latency, one dependent load per step; the bytes "
                      "rule is far below it",
        "ns_per_step": ms * 1e6 / perm.numel(),
        "library_ms": None,
        "shape": list(perm.shape), "dtype": "int32", "nbytes": nbytes,
        "block_rows": br, "passes": 1,
    }
    say(f"  chase     int32    {nbytes:>11d} B  ms {ms:.4f}  (host "
        f"{host_ms:.4f})  {e['ns_per_step']:.3f} ns/step  bound "
        f"{e['bound_ms']:.4f} (bytes)  plain {plain_ms:.4f}  library -  "
        f"err {e['max_abs_err']:.1f} of {want:.1f}")
    return e


def main(argv=None) -> int:
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small sizes only: a first check that the kernels "
                         "build, launch and agree")
    ap.add_argument("--out-dir", default=None,
                    help=f"directory for result JSON, traces and log.txt "
                         f"(default: {OUT_DIR.relative_to(ROOT)})")
    args = ap.parse_args(argv)
    if args.out_dir:
        OUT_DIR = Path(args.out_dir).resolve()
    t0 = time.perf_counter()
    (OUT_DIR / "log.txt").unlink(missing_ok=True)
    info = phase_device()
    phase_kernels(args.quick)
    phase_rw_chase(args.quick)
    counts = phase_main_path(args.quick)
    counts["rw"] = phase_rw_path(args.quick)["rw"]
    counts["chase"] = phase_latency_path(args.quick)["chase"]
    phase_real(args.quick)
    phase_real_rw_chase(args.quick)
    line = phase_kernels_line(counts, args.quick)
    say(f"== all phases passed in {time.perf_counter() - t0:.1f} s")
    say(info["smi"])
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
