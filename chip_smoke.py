#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one NVIDIA
GPU, and hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py            # everything; needs one CUDA device
    python3 chip_smoke.py --quick    # small sizes only (a first build check)
    python3 chip_smoke.py --out-dir DIR   # where results and log.txt go
                                          # (default: artifacts/chip_smoke)

Phases (any failure raises and the script exits non-zero):

  1  device: card name and power limit, torch / CUDA / nvcc versions, and the
     build of the kernels from ``src/repro_torch/kernels/*/csrc`` (membench,
     flash_attention, ssd_scan), one ``nvcc`` per source, all together, each
     kernel that spills registers named; the SASS of mxu.cu and flash_attn.cu
     shows tensor-core instructions in their bfloat16 routes and none in
     their float32 routes; every kernel of acc.cu and copy.cu holds global
     loads (LDG, LDGSTS: each load_only kernel's cp.async copies, matched
     as whole opcodes) and none spills.
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
     timed forms against the ``torch`` oracles.  2c: flash attention
     against ``plain_flash`` (the reference test's shapes, head dims 80 and
     128, causal and not, float32 and bfloat16, block-shape invariance) and
     the SSD against ``plain_ssd`` (the reference test's shapes, chunk
     invariance, stride-0 B/C views), both also at the serving shapes.
  3  the main paths, each with the launch counters set to 0 just before and
     read just after: ``run --backend cuda`` over the working-set ladder
     32 KiB .. 2 GiB for the six first mixes, then for the rw ladder, float32
     then bfloat16; ``latency --backend cuda`` (idle and loaded); the result
     JSON is read back and checked; ``compare`` of ``torch`` vs ``cuda``.
     3d: ``python -m repro_torch.launch.serve --arch zamba2-2.7b --batch 4
     --prompt-len 512 --gen 16`` at full width (9 flash and 54 SSD launches
     in its one prefill, no membench launch), then in process the kernel
     route's prefill against the plain route's, and two decode steps.
  4  the measurement is real: doubling ``passes`` doubles the time (also
     for acc.cu and copy.cu at 32 KiB and 1 MiB), no GB/s above the card's
     memory rate at 2 GiB nor above the SMs' load/store rate (128 B a clock
     an SM) at any size, mxu below the float32 peak and,
     on the bfloat16 working set, below the bf16 tensor-core peak; the chase
     at least 5 ns per dependent step, loaded latency not below idle.
  5  one JSON line listing every kernel with its time, its plain version's,
     the library call's, and its bound (flash_attn and ssd_scan at the
     serving shapes; bytes at the SMs' load/store rate where a call's
     buffers fit the L2, at the HBM rate above it, ``bytes_bound``); every
     membench kernel and rw ladder member, and flash_attn, and their library
     calls, also by device time (the calls enqueued behind a device-side
     sleep); the membench kernels and the rw ladder also at the Runner's
     small points, 32 KiB x 2048 passes and 1 MiB x 64, float32, each held
     against its plain version there, at 8 passes and (all but fma) at the
     timed pass count.

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
import re
import subprocess
import sys
import time
from dataclasses import replace
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
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core import instruction_mix as im  # noqa: E402
from repro_torch.core.buffers import working_set  # noqa: E402
from repro_torch.kernels.build import build_libraries, find_nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.membench import membench as mb  # noqa: E402
from repro_torch.kernels.membench import ops as mb_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as sk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.common import (apply_mlp, apply_norm,  # noqa: E402
                                       embed_tokens, init_params)
from repro_torch.models.hybrid import _index as layer_params  # noqa: E402
from repro_torch.models.registry import build, make_batch  # noqa: E402
from repro_torch.models.variant import BASELINE  # noqa: E402

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
# Where a call's buffers fit the L2 together, a timed call finds them on
# chip (the calls run back to back, and many-pass calls reread them from the
# SMs' L1s), and the HBM rate is no bound: the bytes time is taken at the
# SMs' load/store path instead, 128 bytes a clock an SM (32 lanes x 4 bytes:
# the L1 / shared-memory width of NVIDIA's Volta-to-Hopper SM white papers)
# x the SM count x the card's top SM clock, read on the card (phase 1).  No
# byte a kernel loads or stores passes into or out of an SM faster.  The L2
# itself has no published rate: this bound is loose where the L2 serves.
SM_PATH_BYTES_PER_CLOCK = 128
#: {"bytes_per_s": on-chip rate, "l2": L2 bytes}, set by phase 1
ON_CHIP: dict = {}
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
    "flash_attn": "src/repro/kernels/flash_attention/flash_attention.py:21",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:22",
}
#: every kernel package of the port, built together in phase 1
LIBRARIES = (mb.LIBRARY, fa.LIBRARY, sk.LIBRARY)
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


def exact_input(x: torch.Tensor) -> torch.Tensor:
    """x's shape and dtype, 1 at the even flat indices and 0 between: every
    16-byte vector and every tile's element [0,0] holds a one, so a vector
    or tile left out or read twice moves a sum, and while the sum of a call
    stays below 2**24 every partial sum is an integer that float32 holds
    exactly, whatever the order of the adds: load_sum, load_only and the
    mxu sums must then equal their plain versions to the bit, at any pass
    count."""
    flat = torch.arange(x.numel(), device=x.device) % 2 == 0
    return flat.to(x.dtype).reshape(x.shape)


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
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say("nvcc: " + nvcc[-2].strip() + " / " + nvcc[-1].strip())
    # one nvcc per source of every kernel package, all started together
    built = build_libraries(LIBRARIES)
    paths = {f"{pkg}/{src}": path for pkg, by_src in built.items()
             for src, path in by_src.items()}
    say(f"built {len(paths)} kernel libraries in "
        f"{max(lib.last_build_seconds for lib in LIBRARIES):.1f} s -> "
        f"{mb.LIBRARY.build_dir.parent}")
    for src, path in paths.items():
        log = path.with_suffix(".log")
        regs, spills, spilled, fn = [], 0, [], ""
        if log.exists():
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1] if "'" in line else line
                if "Used" in line and "registers" in line:
                    regs.append(int(line.split("Used")[1].split()[0]))
                if "bytes spill stores" in line:
                    n = int(line.split("bytes spill stores")[0].split()[-1])
                    spills = max(spills, n)
                    if n:
                        spilled.append(f"{fn} {n} B")
        say(f"  {src}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)}, "
            f"max spill stores {spills} B")
        for k in spilled:
            say(f"    spills: {k}")
        if src in NO_SPILL and (spilled or not regs):
            raise AssertionError(f"{src} must build with no spill (and its "
                                 f"-Xptxas -v log must list its kernels): "
                                 f"{spilled or 'no kernels in the log'}")
    check_tensor_core_routes(built)
    check_global_loads(built)
    props = torch.cuda.get_device_properties(DEV)
    say(f"SMs {props.multi_processor_count}, grid cap "
        f"{mb.CTAS_PER_SM} CTAs/SM x {props.multi_processor_count}")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    ON_CHIP.update(bytes_per_s=SM_PATH_BYTES_PER_CLOCK
                   * props.multi_processor_count * mhz * 1e6,
                   l2=props.L2_cache_size)
    say(f"bytes bound of a call whose buffers fit the L2 "
        f"({props.L2_cache_size} B): {props.multi_processor_count} SMs x "
        f"{SM_PATH_BYTES_PER_CLOCK} B x {mhz:.0f} MHz = "
        f"{ON_CHIP['bytes_per_s'] / 1e12:.2f} TB/s; above it "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s (HBM)")
    return {"smi": smi.splitlines()[0]}


def bytes_bound(moved: float, footprint: float) -> dict:
    """The bytes time of a call that moves ``moved`` bytes over buffers of
    ``footprint`` bytes: at the SMs' load/store path where the buffers fit
    the L2 (``ON_CHIP``), else at the HBM rate; with the rate it used."""
    on_chip = footprint <= ON_CHIP["l2"]
    rate = ON_CHIP["bytes_per_s"] if on_chip else HBM_BYTES_PER_S
    return {"t_bytes": moved / rate,
            "bytes_rate": {"level": "sm_load_store" if on_chip else "hbm",
                           "bytes_per_s": rate}}


def bound_fields(b: dict, t_ops: float) -> dict:
    """``bound_ms`` (the larger of the bytes and operations times),
    ``bound_by`` and the bytes rate behind it, for a ``kernels`` entry."""
    t_bytes = b["t_bytes"]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_rate": b["bytes_rate"]}


def bound_note(e: dict) -> str:
    return (f"bound {e['bound_ms']:.4f} ({e['bound_by']}; bytes at "
            f"{e['bytes_rate']['bytes_per_s'] / 1e12:.2f} TB/s "
            f"{e['bytes_rate']['level']})")


#: kernels (by a fragment of their mangled name) that must, or must not,
#: run on the tensor cores: the bfloat16 routes multiply there (exact:
#: bf16 products fit float32), the float32 routes may not (TF32 would round
#: x to 10 mantissa bits)
TENSOR_CORE_ROUTES = {
    ("membench", "mxu.cu"): {"MxuBf16": True, "MxuF32": False},
    ("flash_attention", "flash_attn.cu"): {"flash_fwd_tc": True,
                                           "9flash_fwd": False},
    ("ssd_scan", "ssd_scan.cu"): {"ssd_fwd_tc": True, "7ssd_fwdI": False},
}
#: libraries that must build with no spill (redesigned for Hopper with a
#: register budget: a spill there is a fault of the design)
NO_SPILL = ("ssd_scan/ssd_scan.cu", "membench/triad.cu", "membench/acc.cu",
            "membench/copy.cu")
#: libraries every kernel of which must issue global loads: a load whose
#: value is never used may be deleted by ptxas (inline asm or not), so the
#: SASS, not the source, shows that the timed traffic is executed
GLOBAL_LOADS = (("membench", "acc.cu"), ("membench", "copy.cu"))


def sass_of(path: Path) -> dict[str, list[str]]:
    """Kernel name -> its SASS lines (``cuobjdump -sass``)."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    kernels: dict[str, list[str]] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = []
        elif name:
            kernels[name].append(line)
    return kernels


def sass_ops(lines: list[str]) -> list[tuple[int, str, str]]:
    """(address, opcode, instruction) of each SASS instruction: the opcode
    is the instruction's first word after any predicate, without its
    modifiers (``@P0 LDG.E.128 R4, ...`` -> ``LDG``)."""
    ops = []
    for ln in lines:
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)"
                     r"([^;]*)", ln)
        if m:
            ops.append((int(m.group(1), 16), m.group(2),
                        m.group(2) + m.group(3)))
    return ops


#: the opcodes of a global load: a load into registers, and cp.async's
#: global -> shared copy (not LDGDEPBAR, which only waits for copies)
GLOBAL_LOAD_OPS = ("LDG", "LDGSTS")


def loads_in_loops(ops: list[tuple[int, str, str]]) -> int:
    """Global loads of a kernel's SASS that lie inside a loop: between a
    backward branch and its target."""
    loads, loops = [], []
    for addr, op, ins in ops:
        if op in GLOBAL_LOAD_OPS:
            loads.append(addr)
        b = re.findall(r"0x([0-9a-f]+)", ins) if op == "BRA" else None
        if b and int(b[-1], 16) <= addr:
            loops.append((int(b[-1], 16), addr))
    return sum(any(lo <= a <= hi for lo, hi in loops) for a in loads)


def acc_mix_of(name: str) -> int | None:
    """The MIX template argument of an acc.cu kernel's mangled name
    (``acc_win<T, U, K, MIX, ...>``, ``acc_np<T, K, MIX, ...>``; 0 load_sum,
    1 load_only, 2 fma), None for another kernel."""
    m = re.search(r"(acc_win|acc_np)I(?:f|13__nv_bfloat16)((?:Li-?\d+E)+)",
                  name)
    if not m:
        return None
    ints = [int(v) for v in re.findall(r"Li(-?\d+)E", m.group(2))]
    return ints[2] if m.group(1) == "acc_win" else ints[1]


def check_global_loads(built: dict) -> None:
    """Raise unless every kernel of GLOBAL_LOADS issues global loads (LDG
    or LDGSTS, matched as whole opcodes), the persistent ones (``*_win``,
    whose pass loop is inside) in a loop, and each of acc.cu's load_only
    kernels issues its cp.async copies (LDGSTS); print the counts and how
    many loads are 16 bytes wide."""
    for pkg, src in GLOBAL_LOADS:
        kernels = sass_of(built[pkg][src])
        if not kernels:
            raise AssertionError(f"{pkg}/{src}: no kernel in the SASS")
        counts, load_only = {}, 0
        for name, lines in kernels.items():
            ops = sass_ops(lines)
            ldg = sum(op == "LDG" for _, op, _ in ops)
            ldgsts = sum(op == "LDGSTS" for _, op, _ in ops)
            wide = sum(op in GLOBAL_LOAD_OPS and ".128" in ins
                       for _, op, ins in ops)
            counts[name] = (ldg, ldgsts, wide)
            if ldg + ldgsts == 0:
                raise AssertionError(f"{pkg}/{src}: kernel {name} issues no "
                                     f"global load (LDG / LDGSTS)")
            if "_win" in name and not loads_in_loops(ops):
                raise AssertionError(f"{pkg}/{src}: persistent kernel {name} "
                                     f"has no global load inside a loop")
            if src == "acc.cu" and acc_mix_of(name) == 1:
                load_only += 1
                if not ldgsts:
                    raise AssertionError(
                        f"acc.cu: load_only kernel {name} issues no cp.async "
                        f"copy (LDGSTS): its data movement is gone")
        if src == "acc.cu" and not load_only:
            raise AssertionError("acc.cu: no load_only kernel found in the "
                                 "SASS by its mangled name")
        say(f"  {pkg}/{src}: {len(counts)} kernels, each with global loads "
            f"(the persistent ones inside their loops); "
            f"LDG per kernel {min(c[0] for c in counts.values())}.."
            f"{max(c[0] for c in counts.values())} (16-byte loads "
            f"{min(c[2] for c in counts.values())}.."
            f"{max(c[2] for c in counts.values())}), LDGSTS in "
            f"{sum(c[1] > 0 for c in counts.values())} kernels"
            + (f" (all {load_only} load_only kernels)" if load_only else ""))


def check_tensor_core_routes(built: dict) -> None:
    """Count tensor-core instructions (HMMA, HGMMA) per kernel in the SASS
    of the built libraries (``cuobjdump -sass``); raise unless every
    bfloat16 route has some and no float32 route has any."""
    for (pkg, src), want in TENSOR_CORE_ROUTES.items():
        counts = {name: sum("HMMA" in ln or "HGMMA" in ln for ln in lines)
                  for name, lines in sass_of(built[pkg][src]).items()}
        for frag, tensor in want.items():
            hits = {n: c for n, c in counts.items() if frag in n}
            if not hits or any((c > 0) != tensor for c in hits.values()):
                raise AssertionError(
                    f"{pkg}/{src}: kernels matching {frag!r} must "
                    f"{'' if tensor else 'not '}issue tensor-core "
                    f"instructions; SASS counts {hits}")
            say(f"  {pkg}/{src} {frag}: {len(hits)} kernels, tensor-core "
                f"instructions per kernel {sorted(set(hits.values()))}")


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
    # 16 MiB: acc.cu and copy.cu run their persistent loop with several
    # blocks a CTA (acc_walk, acc_linear, copy_win's group loop) at every
    # tiling, interleave and stream count below (the smaller sizes take one
    # block a CTA, acc_fixed / copy_fixed); 64 MiB: the non-persistent grid
    sizes = ((16 * KiB, 128 * KiB) if quick
             else (16 * KiB, 128 * KiB, 16 * MiB, 64 * MiB))
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
                        ks = ((1, 2, 4, 8) if kernel in ("load_sum", "copy")
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
    # 16 MiB: acc.cu and copy.cu run their persistent loop with several
    # blocks a CTA (acc_walk, acc_linear, copy_win's group loop) at every
    # tiling, interleave and stream count below (the smaller sizes take one
    # block a CTA, acc_fixed / copy_fixed); 64 MiB: the non-persistent grid
    sizes = ((16 * KiB, 128 * KiB) if quick
             else (16 * KiB, 128 * KiB, 16 * MiB, 64 * MiB))
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
# phase 2c — the model kernels (flash attention, SSD) against their plain
# versions
# ---------------------------------------------------------------------------

#: the serving path: zamba2-2.7b at full width, 4 prompts of 512 tokens, 16
#: generated
SERVE_B, SERVE_P, SERVE_G = 4, 512, 16
SERVE_ARGV = ["--arch", "zamba2-2.7b", "--batch", str(SERVE_B),
              "--prompt-len", str(SERVE_P), "--gen", str(SERVE_G)]
#: the kernels' shapes on that path: flash (B, S, H, KV, D), bf16, causal;
#: SSD (B, H, S, P, N, chunk), bf16 x/B/C, B and C shared by a row's heads
FLASH_SERVE = (SERVE_B, SERVE_P, 32, 32, 80)
SSD_SERVE = (SERVE_B, 80, SERVE_P, 64, 64, 256)
#: tests/test_kernels.py's flash shapes, plus the serving head dim 80 (G 1
#: and G 4) and 128
FLASH_SHAPES = [(2, 128, 8, 4, 64), (1, 256, 4, 4, 32), (2, 128, 8, 2, 64),
                (1, 128, 16, 16, 32), (1, 128, 4, 4, 80), (2, 64, 8, 2, 80),
                (1, 128, 4, 2, 128)]
#: the reference's flash tolerances (rtol = atol, test_flash_vs_ref)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: tests/test_kernels.py's SSD shapes (BH, S, P, N, chunk), and its
#: tolerance (rtol = atol): the chunked kernel and the token recurrence sum
#: in another order, in float32
SSD_SHAPES = [(4, 128, 32, 16, 32), (2, 256, 64, 32, 64), (1, 64, 16, 8, 16)]
SSD_TOL = 2e-4


def _randn(shape, dtype, gen, scale=1.0) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def flash_inputs(B, S, H, KV, D, dtype, seed) -> tuple:
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (_randn((B, S, H, D), dtype, g), _randn((B, S, KV, D), dtype, g),
            _randn((B, S, KV, D), dtype, g))


def hold_flash(q, k, v, causal: bool, label: str) -> float:
    """The kernel against plain_flash on the card; raises unless every
    element is within the reference's tolerance.  Returns the max abs
    error."""
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.plain_flash(q, k, v, causal=causal).float()
    sync()
    tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
    diff = (got.float() - want).abs()
    if not bool((diff <= tol + tol * want.abs()).all()):
        raise AssertionError(f"flash {label} causal={causal}: max abs err "
                             f"{float(diff.max())} beyond rtol=atol={tol}")
    return float(diff.max())


def ssd_inputs(BH, S, P, N, dtype, seed) -> tuple:
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (_randn((BH, S, P), dtype, g, 0.5),
            -_randn((BH, S), torch.float32, g, 0.3).abs(),
            _randn((BH, S, N), dtype, g, 0.5), _randn((BH, S, N), dtype, g, 0.5))


def hold_ssd(xdt, dA, Bm, Cm, chunk: int, label: str) -> float:
    """The kernel against plain_ssd on the card (B/C may be (B, H, S, N)
    views; the plain version gets them materialised per head).  y within
    SSD_TOL, plus 2**-8 of |y| (the unit roundoff) when y comes back in bf16;
    the float32 state within SSD_TOL.  Returns the max abs error of y."""
    BH, S, P = xdt.shape
    y, st = sk.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk)
    wy, wst = sk.plain_ssd(xdt, dA, Bm.reshape(BH, S, -1),
                           Cm.reshape(BH, S, -1))
    sync()
    rounding = 2.0**-8 if y.dtype == torch.bfloat16 else 0.0
    dy, ds = (y.float() - wy).abs(), (st - wst).abs()
    if not (bool((dy <= SSD_TOL + (SSD_TOL + rounding) * wy.abs()).all())
            and bool((ds <= SSD_TOL + SSD_TOL * wst.abs()).all())):
        raise AssertionError(f"ssd {label} chunk={chunk}: max abs err y "
                             f"{float(dy.max())}, state {float(ds.max())}")
    return float(dy.max())


def serve_ssd_inputs(seed: int = 64) -> tuple:
    """The SSD's inputs at the serving shape, laid out as the model's kernel
    route lays them out: x and dA per head (B*H, S, ·), B and C one (S, N)
    matrix per batch row expanded over its H heads with stride 0."""
    B, H, S, P, N, _ = SSD_SERVE
    g = torch.Generator(device=DEV).manual_seed(seed)
    xdt = _randn((B * H, S, P), torch.bfloat16, g, 0.5)
    dA = -_randn((B * H, S), torch.float32, g, 0.3).abs()
    Bm = _randn((B, S, N), torch.bfloat16, g, 0.5)
    Cm = _randn((B, S, N), torch.bfloat16, g, 0.5)
    return (xdt, dA, Bm.unsqueeze(1).expand(B, H, S, N),
            Cm.unsqueeze(1).expand(B, H, S, N))


def phase_model_kernels(quick: bool) -> dict[str, float]:
    """Returns the max abs error of each kernel at the serving shape."""
    say("== phase 2c: flash attention and SSD against their plain versions "
        "on the card")
    worst: dict[str, float] = {}
    n = 0
    for shape in FLASH_SHAPES[:5] if quick else FLASH_SHAPES:
        for dname, dtype in DTYPES.items():
            q, k, v = flash_inputs(*shape, dtype, seed=sum(shape))
            for causal in (True, False):
                err = hold_flash(q, k, v, causal, f"{dname} {shape}")
                key = f"flash/{dname}"
                worst[key] = max(worst.get(key, 0.0), err)
                n += 1
    # the reference's block-shape invariance: the wrapper's q_block /
    # kv_block keep its checks and change nothing in the kernel's tiling
    q, k, v = flash_inputs(1, 256, 4, 4, 32, torch.float32, seed=9)
    a = fa_ops.flash(q, k, v, causal=True, q_block=256, kv_block=256)
    b = fa_ops.flash(q, k, v, causal=True, q_block=32, kv_block=64)
    if not torch.equal(a, b):
        raise AssertionError("flash: q_block/kv_block changed the output")
    # the serving shape
    q, k, v = flash_inputs(*FLASH_SERVE, torch.bfloat16, seed=80)
    serve_flash = hold_flash(q, k, v, True, f"serve {FLASH_SERVE}")
    if not torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention(q, k, v)):
        raise AssertionError("flash: two runs differ")
    del q, k, v
    say(f"  {n} flash cases within the reference's tolerances; worst max "
        f"abs err {worst}; serving shape {FLASH_SERVE} bf16 causal: "
        f"{serve_flash:.3e} (tolerance {FLASH_TOL['bfloat16']} + "
        f"{FLASH_TOL['bfloat16']}|value|); block-shape invariant, "
        f"repeatable")

    n = 0
    for BH, S, P, N, Q in SSD_SHAPES:
        for dname, dtype in DTYPES.items():
            err = hold_ssd(*ssd_inputs(BH, S, P, N, dtype, seed=BH + S), Q,
                           f"{dname} {(BH, S, P, N)}")
            worst[f"ssd/{dname}"] = max(worst.get(f"ssd/{dname}", 0.0), err)
            n += 1
    # a bf16 shape the tensor-core route does not take (P not a multiple
    # of 8): route 0 on inputs widened to float32
    if sk.launch_plan(2, 12, 8, 16, torch.bfloat16)["route"] != 0:
        raise AssertionError("ssd: P 12 should take route 0")
    err = hold_ssd(*ssd_inputs(2, 64, 12, 8, torch.bfloat16, seed=12), 16,
                   "bfloat16 (2, 64, 12, 8) route 0")
    worst["ssd/bfloat16"] = max(worst["ssd/bfloat16"], err)
    n += 1
    routes = {dname: sorted({sk.launch_plan(BH, P, N, Q, dtype)["route"]
                             for BH, S, P, N, Q in SSD_SHAPES})
              for dname, dtype in DTYPES.items()}
    if routes != {"float32": [0], "bfloat16": [1]}:
        raise AssertionError(f"ssd: SSD_SHAPES took routes {routes}")
    # chunk invariance (the reference's test): chunks of 32 and 128 agree,
    # on both routes (bf16: y1 and y2 each rounded to bf16, 2**-8 of |y|)
    for dname, dtype in DTYPES.items():
        args = ssd_inputs(2, 128, 16, 8, dtype, seed=5)
        (y1, s1), (y2, s2) = (sk.ssd_scan(*args, chunk=q) for q in (32, 128))
        y1, y2 = y1.float(), y2.float()
        rel = SSD_TOL + (2 * 2.0**-8 if dtype == torch.bfloat16 else 0.0)
        if not (bool(((y1 - y2).abs() <= SSD_TOL + rel * y2.abs()).all())
                and bool(((s1 - s2).abs()
                          <= SSD_TOL + SSD_TOL * s2.abs()).all())):
            raise AssertionError(f"ssd {dname}: chunks 32 and 128 disagree")
    # stride-0 B/C views give what materialised per-head copies give
    xdt, dA, Bv, Cv = serve_ssd_inputs()
    BH, S = dA.shape
    ya, sa = sk.ssd_scan(xdt, dA, Bv, Cv, chunk=SSD_SERVE[-1])
    yb, sb = sk.ssd_scan(xdt, dA, Bv.reshape(BH, S, -1).contiguous(),
                         Cv.reshape(BH, S, -1).contiguous(),
                         chunk=SSD_SERVE[-1])
    if not (torch.equal(ya, yb) and torch.equal(sa, sb)):
        raise AssertionError("ssd: stride-0 B/C views differ from copies")
    serve_ssd = hold_ssd(xdt, dA, Bv, Cv, SSD_SERVE[-1],
                         f"serve {SSD_SERVE}")
    plan = sk.launch_plan(BH, xdt.shape[-1], Bv.shape[-1], SSD_SERVE[-1],
                          xdt.dtype, sms=torch.cuda.get_device_properties(
                              DEV).multi_processor_count)
    del xdt, dA, Bv, Cv, ya, yb
    say(f"  {n} ssd cases within the reference's tolerance (routes "
        f"{routes}); worst max abs err "
        f"{({k: e for k, e in worst.items() if k.startswith('ssd')})}; "
        f"chunk-invariant on both routes; stride-0 B/C views bit-identical "
        f"to copies; serving shape {SSD_SERVE} bf16: {serve_ssd:.3e} (route "
        f"{plan['route']}, {plan['grid']} CTAs, {plan['ctas_per_sm']} an SM, "
        f"{plan['waves']:.2f} waves, last {plan['last_wave']} of "
        f"{plan['slots']})")
    return {"flash_attn": serve_flash, "ssd_scan": serve_ssd}


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


#: the kernel route against the plain route, at full width.  The routes
#: round at different places by design (the kernels keep the SSD's CB*L,
#: decays and carried state and the attention probabilities in float32, the
#: plain route rounds them to bf16, ROADMAP Queue C).  LAYER_TOL holds each
#: site's attention output and each Mamba layer's update and state, both
#: routes fed the SAME input (the reference's bf16 attention tolerance, on
#: the relative RMS); SERVE_LOGITS_RMS_TOL holds the prefill logits after 54
#: layers, where each layer's difference feeds the next (relative RMS
#: 0.0852 measured at these seeds on an H100 80GB HBM3, 700 W).
LAYER_TOL = 2e-2
SERVE_LOGITS_RMS_TOL = 0.15


def _rms_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt())


def layerwise_routes(model, params, tokens) -> dict[str, float]:
    """Both routes from the same input at every attention site and Mamba
    layer, following the plain route's activations: the worst relative RMS
    difference of the site attention outputs, of the Mamba layers' updates
    (output minus input) and of their final states."""
    cfg = model.cfg
    S = tokens.shape[1]
    kern = replace(BASELINE, use_pallas=True)
    shared = params["shared"]
    pos = torch.arange(S, device=DEV)
    inv_freq = attention.rope_freqs(cfg.resolved_head_dim, cfg.rope_pct,
                                    cfg.rope_theta, device=DEV)
    worst = {"attention": 0.0, "mamba update": 0.0, "mamba state": 0.0}
    x = embed_tokens(params["embed"], tokens)
    for site in range(model.n_sites):
        h = apply_norm(cfg, layer_params(params["site_norms"], site), x)
        h1 = apply_norm(cfg, shared["ln1"], h)
        q, k, v = attention.gqa_project_qkv(cfg, shared["attn"], h1, pos,
                                            inv_freq)
        o = attention.chunked_attention(q, k, v, causal=True, kv_block=S)
        worst["attention"] = max(worst["attention"], _rms_rel(
            fa_ops.flash(q, k, v, causal=True), o))
        h = h + attention.out_proj(o, shared["attn"]["wo"]).to(x.dtype)
        x = x + h + apply_mlp(cfg, shared["mlp"],
                              apply_norm(cfg, shared["ln2"], h))
        for layer in range(cfg.attn_every):
            p = layer_params(params["mamba"], site, layer)
            xk, ek = model._mamba_prefill(p, x, kern)
            xp, ep = model._mamba_prefill(p, x, BASELINE)
            worst["mamba update"] = max(worst["mamba update"],
                                        _rms_rel(xk - x, xp - x))
            worst["mamba state"] = max(worst["mamba state"],
                                       _rms_rel(ek["state"], ep["state"]))
            x = xp
    return worst


def device_busy_ms(fn) -> tuple:
    """(milliseconds of kernel time in one call of ``fn`` — the device's
    busy time, one stream — from ``torch.profiler``, or None where the
    profiler records no device time; fn's result).  Only the device's own
    events are summed: a CPU op's device time is its kernels' again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return (us / 1e3 if us > 0 else None), out


def wall_ms(fn) -> tuple:
    """(wall milliseconds of one call of ``fn``, synchronised; its result)."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3, out


def phase_serve_path(quick: bool) -> dict[str, int]:
    say("== phase 3d: the serving path (python -m repro_torch.launch.serve "
        + " ".join(SERVE_ARGV) + (" --reduced" if quick else "") + ")")
    cfg = get_arch("zamba2-2.7b")
    if quick:
        cfg = reduced(cfg)
    model = build(cfg)
    mb.reset_launch_counts()
    fa.reset_launch_counts()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(SERVE_ARGV + (["--reduced"] if quick else []))
    sync()
    lines = buf.getvalue().strip().splitlines()
    counts = {**fa.launch_counts, **sk.launch_counts}
    say(f"  serve: exit {rc}, {time.perf_counter() - t0:.1f} s")
    for line in lines:
        say("  | " + line)
    say(f"  launches on the serving path: {counts}; membench "
        f"{sum(mb.launch_counts.values())}")
    if rc != 0 or len(lines) != 4:
        raise AssertionError(f"serve exited {rc} with {len(lines)} lines")
    # one prefill: the flash kernel once per attention site, the SSD kernel
    # once per Mamba layer; decode runs neither
    want = {"flash_attn": model.n_sites, "ssd_scan": cfg.n_layers}
    if counts != want:
        raise AssertionError(f"serve launched {counts}, expected {want}")
    if any(mb.launch_counts.values()):
        raise AssertionError(f"serve launched membench kernels: "
                             f"{mb.launch_counts}")

    # in process, one parameter set and one prompt batch (serve's seeds):
    # the kernel route against the plain route
    params = init_params(model.param_specs(),
                         torch.Generator(device=DEV).manual_seed(0))
    tokens = make_batch(cfg, (SERVE_B, SERVE_P), torch.Generator(
        device=DEV).manual_seed(1))["tokens"]
    V = cfg.vocab_size
    kern = replace(BASELINE, use_pallas=True)
    with torch.inference_mode():
        layers = layerwise_routes(model, params, tokens)
        say(f"  every site and layer fed the same input, kernel route vs "
            f"plain route, worst relative RMS: {layers} (tolerance "
            f"{LAYER_TOL})")
        if not all(e <= LAYER_TOL for e in layers.values()):
            raise AssertionError(f"a layer's routes disagree: {layers}")
        lk, ck = model.prefill(params, tokens, None, kern)
        lp, cp = model.prefill(params, tokens, None, BASELINE)
        sync()
        lk, lp = lk[:, :V], lp[:, :V]
        rms = _rms_rel(lk, lp)
        leaves = {f"{k}": _rms_rel(ck[k], cp[k]) for k in ("k", "v")}
        leaves.update({f"ssm/{k}": _rms_rel(ck["ssm"][k], cp["ssm"][k])
                       for k in ck["ssm"]})
        tk, tp = lk.argmax(-1), lp.argmax(-1)
        say(f"  prefill logits, kernel route vs plain route "
            f"({cfg.n_layers} layers deep): relative RMS {rms:.4e} (tolerance "
            f"{SERVE_LOGITS_RMS_TOL}), max abs "
            f"{float((lk - lp).abs().max()):.3e} of largest "
            f"{float(lp.abs().max()):.3e}; cache leaves relative RMS "
            f"{leaves}")
        if not rms <= SERVE_LOGITS_RMS_TOL or not bool(lk.isfinite().all()):
            raise AssertionError(f"prefill routes disagree: relative RMS "
                                 f"{rms} > {SERVE_LOGITS_RMS_TOL}")
        for row in range(SERVE_B):
            a, b = int(tk[row]), int(tp[row])
            if a == b:
                say(f"  row {row}: first greedy token {a} on both routes")
            else:
                say(f"  row {row}: first greedy token differs: kernel route "
                    f"{a}, plain route {b}; plain-route margin "
                    f"{float(lp[row, b] - lp[row, a]):.4f}, kernel-route "
                    f"margin {float(lk[row, a] - lk[row, b]):.4f}")
        del cp
        # where the time goes, warm (serve's own prefill above was the
        # process's first): wall time and the device's busy time per call
        for name, variant in (("kernel route", kern), ("plain route",
                                                        BASELINE)):
            run = lambda v=variant: model.prefill(params, tokens, None, v)
            wall, _ = wall_ms(run)
            busy, _ = device_busy_ms(run)
            say(f"  warm prefill, {name}: {wall:.1f} ms wall, device busy "
                f"{'not measured' if busy is None else f'{busy:.1f} ms'}")
        # decode from the kernel route's cache: finite logits
        for key in ("k", "v"):
            ck[key] = torch.nn.functional.pad(ck[key], (0, 0, 0, 0, 0, 3))
        tok = tk[:, None]
        for i in range(3):
            # each call advances the cache: run every step once
            step = lambda: model.decode_step(params, ck, tok, SERVE_P + i)
            if i < 2:
                wall, (logits, _) = wall_ms(step)
            else:
                busy, (logits, _) = device_busy_ms(step)
            if not bool(logits.isfinite().all()):
                raise AssertionError(f"decode step {i}: non-finite logits")
            tok = logits[:, :, :V].argmax(-1)
    say(f"  decode steps from the kernel route's cache: finite logits; one "
        f"step {wall:.1f} ms wall, device busy "
        f"{'not measured' if busy is None else f'{busy:.1f} ms'}")
    del params, ck, lk, lp
    torch.cuda.empty_cache()
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


def device_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``n`` back-to-back calls,
    free of the host's pace: the calls are enqueued behind a device-side
    sleep long enough for the host to enqueue them all, so that the CUDA
    events around them time the device alone (a call whose checks,
    allocations and launches outlast its kernels would otherwise be timed
    at the host's pace).  The sleep is lengthened until the first event is
    still pending when the last call has been enqueued."""
    for _ in range(warmup):
        fn()
    sync()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    cycles = 10**7
    for _ in range(6):
        torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(n):
            fn()
        covered = not t0.query()
        t1.record()
        sync()
        if covered:
            return t0.elapsed_time(t1) / n
        cycles *= 4
    raise AssertionError("device_ms: the host did not get ahead of the "
                         "device")


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

#: the kernels whose walk is cut into vector blocks (acc.cu, copy.cu), held
#: to the doubling rule at 32 KiB and 1 MiB too
SMALL_POINT_KERNELS = ("load_sum", "load_only", "fma", "copy")
#: the Runner's small points (float32 bytes, passes a call) phase 5 times
SMALL_POINTS = ((32 * KiB, 2048), (1 * MiB, 64))
#: buffers of x's size a call of each kernel reads or writes (its footprint
#: for ``bytes_bound``; mxu's 128 x 128 operand is left out)
BUFFERS = {"load_sum": 1, "load_only": 1, "fma": 1, "mxu": 1, "copy": 2,
           "triad": 3}
#: a timed call of phase 4 must last at least this long, so that the host's
#: share of a call (two allocations, two launches: tens of microseconds) is
#: small against the kernel's
REAL_MIN_MS = 2.0


def phase_real(quick: bool) -> None:
    """Every first-slice kernel on the float32 working set, and mxu on the
    bfloat16 one too: its tensor-core route is held to the bf16 peak."""
    say("== phase 4: the measurement is real")
    # the vector-block kernels at the Runner's small points, where a buffer
    # spans a few SMs and a pass takes tens of nanoseconds
    for nbytes in (32 * KiB,) if quick else (32 * KiB, 1 * MiB):
        x = working_set(nbytes, device=DEV)
        out = torch.empty_like(x)
        for kernel in SMALL_POINT_KERNELS:
            real_point(kernel, "float32", nbytes, x, None, None, out, 5)
        del x, out
    sizes = (16 * MiB,) if quick else (16 * MiB, 2 * GiB)
    for dname, kernels in (("float32", BANDWIDTH_KERNELS),
                           ("bfloat16", ("mxu",))):
        for nbytes in sizes[-1:] if dname == "bfloat16" else sizes:
            x = working_set(nbytes, dtype=DTYPES[dname], device=DEV)
            y, out = x * 0.5, torch.empty_like(x)
            w = torch.eye(mb.LANES, dtype=x.dtype, device=DEV)
            n = 5 if nbytes <= 16 * MiB else 3
            for kernel in kernels:
                real_point(kernel, dname, nbytes, x, y, w, out, n)
            del x, y, out
            torch.cuda.empty_cache()


def real_point(kernel: str, dname: str, nbytes: int, x, y, w, out,
               n: int) -> None:
    """Time one kernel at the smallest power-of-two pass count whose call
    lasts REAL_MIN_MS (at 2 GiB one pass already does) and at twice that;
    raise unless the time doubles, the GB/s stays under the card's memory
    rate at 2 GiB, and mxu's TFLOP/s stays under the peak of its route (the
    float32 units for float32, the tensor cores for bfloat16)."""
    passes, t1, t2 = doubled(
        lambda p: kernel_fn(kernel, x, y, w, out, p), n)
    ratio = t2 / t1
    nb, nf = work(kernel, x)
    gbps = nb * 2 * passes / (t2 * 1e-3) / 1e9
    tflops = nf * 2 * passes / (t2 * 1e-3) / 1e12
    say(f"  {kernel:9s} {dname:8s} {nbytes:>11d} B  passes {passes}->"
        f"{2 * passes}: {t1:.4f} -> {t2:.4f} ms  ratio {ratio:.3f}  "
        f"{gbps:.1f} GB/s  {tflops:.2f} TFLOP/s")
    check_ratio(f"{kernel} {dname} at {nbytes} B", t1, t2)
    check_on_chip_rate(f"{kernel} {dname} at {nbytes} B", gbps)
    if nbytes >= 2 * GiB and gbps > HBM_BYTES_PER_S / 1e9 * 1.02:
        raise AssertionError(
            f"{kernel} {dname} at {nbytes} B reports {gbps:.1f} GB/s, above "
            f"the card's memory rate: some traffic is not executed")
    peak = "bfloat16_tensor" if dname == "bfloat16" else "float32"
    if kernel == "mxu" and tflops * 1e12 >= PEAK_FLOPS[peak]:
        raise AssertionError(
            f"mxu {dname} reports {tflops:.1f} TFLOP/s, above the {peak} "
            f"peak: part of the product is not computed")


def doubled(make_fn, n: int, min_ms: float = REAL_MIN_MS
            ) -> tuple[int, float, float]:
    """(passes, ms at passes, ms at 2 x passes) for the smallest power-of-two
    pass count whose call lasts ``min_ms``; ``make_fn(passes)`` gives the
    call.  Each of the two times is the least of three timings: noise (a
    clock change, a neighbour on the host) only ever adds time, and one
    slow timing of the shorter call once read as a pass loop that does not
    double."""
    passes, t1 = 1, time_ms(make_fn(1), n)
    while t1 < min_ms and passes < 2**16:
        passes *= 2
        t1 = time_ms(make_fn(passes), n)
    t1 = min(t1, *(time_ms(make_fn(passes), n) for _ in range(2)))
    t2 = min(time_ms(make_fn(2 * passes), n) for _ in range(3))
    return passes, t1, t2


def check_on_chip_rate(what: str, gbps: float) -> None:
    """No byte enters or leaves an SM faster than its load/store path
    (``ON_CHIP``): a point above that rate did not execute its traffic."""
    if gbps > ON_CHIP["bytes_per_s"] / 1e9 * 1.02:
        raise AssertionError(
            f"{what} reports {gbps:.1f} GB/s, above the SMs' load/store "
            f"rate {ON_CHIP['bytes_per_s'] / 1e9:.1f} GB/s: some traffic is "
            f"not executed")


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
            check_on_chip_rate(f"rw_{reads}to{writes} at {nbytes} B", gbps)
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
    # (dtype, bytes, passes a call): the one-pass shapes, then the Runner's
    # small points, where many passes a call time the cache level
    shapes = ([("float32", 16 * MiB, 1), ("float32", 32 * KiB, 2048)]
              if quick else
              [("float32", 16 * MiB, 1), ("float32", 2 * GiB, 1),
               ("bfloat16", 2 * GiB, 1)]
              + [("float32", nb, ps) for nb, ps in SMALL_POINTS])
    entries = []
    for dname, nbytes, passes in shapes:
        dtype = DTYPES[dname]
        x = working_set(nbytes, dtype=dtype, device=DEV)
        y, out = x * 0.5, torch.empty_like(x)
        w = torch.eye(mb.LANES, dtype=dtype, device=DEV)
        xr = ramp_input(x)
        yr, wd = xr.flip(0) * 0.5, dense_w(dtype)
        br = mb.default_block_rows(x.shape[0])
        n = 5 if passes > 1 else 20 if nbytes <= 16 * MiB else 3
        plain = {
            "load_sum": lambda: mb.plain_load_sum(x, passes),
            "load_only": lambda: mb.plain_load_only(x, br, passes),
            "fma": lambda: mb.plain_fma(x, FMA_DEPTH, passes),
            "mxu": lambda: mb.plain_mxu(x, w, br, passes),
            "copy": lambda: mb.plain_copy(x, out, passes),
            "triad": lambda: mb.plain_triad(x, y, out, passes),
        }
        # one PyTorch call computing the same function, where there is one
        # (none computes many passes); timed here as a yardstick and used
        # nowhere in the package
        library = {
            "load_sum": lambda: x.sum(dtype=torch.float32),
            "load_only": None,
            "fma": None,
            "mxu": lambda: torch.matmul(x, w),
            "copy": lambda: out.copy_(x),
            "triad": lambda: torch.add(x, y, alpha=1.5, out=out),
        } if passes == 1 else dict.fromkeys(BANDWIDTH_KERNELS)
        for kernel in BANDWIDTH_KERNELS:
            # held on the working set the timed runs use (its sums cancel:
            # absolute bound) and on the ramp input with mxu's dense operand
            # (relative bound; the error and tolerance the line reports)
            # (at most 8 passes: both sides add a pass's value passes
            # times, and from one rounding binade to the next such a sum
            # rounds the same way each time, up to passes x 2**-26 of the
            # value on either side; at 8 passes a vector of the 2048 of a
            # 32 KiB buffer left out or read twice still moves the sum by
            # 50x SUM_RTOL); at the timed pass count too, by
            # hold_all_passes
            hp = min(passes, 8)
            label = f"{dname} {nbytes}B x{hp}"
            _hold(kernel, label + " cycle", x, y, w, br, 1, hp, 1, 1, True)
            err, tol, mag = _hold(kernel, label + " ramp", xr, yr, wd, br,
                                  1, hp, 1, 1, False)
            if passes > hp:
                hold_all_passes(kernel, x, xr, yr, wd, br, passes)
            fn = kernel_fn(kernel, x, y, w, out, passes)
            ms, host_ms = time_both_ms(fn, n)
            plain_ms = time_ms(plain[kernel], n)
            lib = library[kernel]
            library_ms = time_ms(lib, n) if lib is not None else None
            # also by device time, which the host's share of a short call
            # does not blur
            dev = {"device_ms": device_ms(fn, n),
                   "library_device_ms": (device_ms(lib, n)
                                         if lib is not None else None)}
            nb, nf = (passes * v for v in work(kernel, x))
            peak = (PEAK_FLOPS["bfloat16_tensor"]
                    if kernel == "mxu" and dname == "bfloat16"
                    else PEAK_FLOPS["float32"])
            b = bytes_bound(nb, BUFFERS[kernel] * x.numel()
                            * x.element_size())
            t_bytes, t_ops = b["t_bytes"], nf / peak
            entries.append({
                "name": kernel, "route": "cuda",
                "source": "src/repro_torch/kernels/membench/csrc/"
                          + mb.SOURCES[kernel],
                "replaces": REPLACES[kernel],
                "launches": counts.get(kernel, 0),
                "max_abs_err": err, "tolerance": tol, "expected_abs": mag,
                "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                **bound_fields(b, t_ops),
                "library_ms": library_ms, **dev,
                **({"bound_ms_tf32": max(
                    t_bytes, nf / PEAK_FLOPS["tf32_tensor"]) * 1e3}
                   if kernel == "mxu" and dname == "float32" else {}),
                "shape": list(x.shape), "dtype": dname, "nbytes": nbytes,
                "block_rows": br, "passes": passes,
            })
            e = entries[-1]
            say(f"  {kernel:9s} {dname:8s} {nbytes:>11d} B x{passes:<4d} "
                f"ms {ms:.4f}  "
                f"(host {host_ms:.4f})  {bound_note(e)}  plain "
                f"{plain_ms:.4f}  library "
                f"{'-' if library_ms is None else f'{library_ms:.4f}'}  "
                f"err {err:.2e} of {mag:.3e} (tolerance {tol:.2e})"
                + device_note(dev))
        entries += rw_entries(x, xr, dname, nbytes, n, counts["rw"],
                              passes)
        del x, y, out, xr, yr
        torch.cuda.empty_cache()
    for nbytes in (128 * KiB,) if quick else (128 * KiB, 16 * MiB):
        entries.append(chase_entry(nbytes, counts["chase"]))
    return {"kernels": entries}


def hold_all_passes(kernel: str, x, xr, yr, wd, br: int, passes: int
                    ) -> None:
    """Hold a kernel against its plain version at the timed pass count of
    a many-pass point, the very launch that is timed: copy and triad on the
    ramp input (their output does not depend on the pass count), load_sum,
    load_only and mxu exactly on ``exact_input`` (fma's chain has no exact
    input: it is held at 8 passes only)."""
    if kernel in ("copy", "triad"):
        _hold(kernel, f"{x.numel() * x.element_size()}B x{passes} ramp", xr,
              yr, wd, br, 1, passes, 1, 1, False)
        return
    if kernel == "fma":
        return
    xe = exact_input(x)
    if not x.numel() // 2 * passes < 2**24:
        raise AssertionError(f"{kernel}: {passes} passes over {x.numel()} "
                             f"elements leave float32's exact integers")
    eye = torch.eye(mb.LANES, dtype=x.dtype, device=DEV)
    got, want = run_pair(kernel, xe, None, eye, br, 1, passes, 1, 1)
    sync()
    if not torch.equal(got, want):
        raise AssertionError(
            f"{kernel} {x.numel() * x.element_size()}B x{passes} exact "
            f"input: {got.tolist()} vs plain {want.tolist()}, must be equal")


def device_note(dev: dict) -> str:
    lib = dev["library_device_ms"]
    return (f"  device {dev['device_ms']:.4f} vs library "
            f"{'-' if lib is None else f'{lib:.4f}'}")


def rw_entries(x, xr, dname: str, nbytes: int, n: int, launches: int,
               passes: int = 1) -> list[dict]:
    """One ``kernels`` entry per member of the rw ladder on x (``passes``
    sweeps a call at the default tiling), each held bit for bit on the ramp
    input xr."""
    br = mb.default_block_rows(x.shape[0])
    entries = []
    for reads, writes in RW_LADDER:
        yrs = im.rw_streams(xr, reads)[1:]
        want = mb.plain_rw(xr, *yrs, writes=1)[0].to(torch.float32)
        err = max(float((o.to(torch.float32) - want).abs().max())
                  for o in mb.rw(xr, *yrs, reads=reads, writes=writes,
                                 block_rows=br, passes=passes))
        if err != 0.0:
            raise AssertionError(f"rw_{reads}to{writes} {dname} {nbytes}B "
                                 f"ramp: max abs err {err}, tolerance 0")
        del yrs, want
        ys = im.rw_streams(x, reads)[1:]
        outs = tuple(torch.empty_like(x) for _ in range(writes))
        ms, host_ms = time_both_ms(lambda: mb.rw(
            x, *ys, reads=reads, writes=writes, outs=outs, block_rows=br,
            passes=passes), n)
        plain_ms = time_ms(lambda: mb.plain_rw(x, *ys, writes=writes,
                                               outs=outs, passes=passes), n)
        # one PyTorch call computing the same function, where there is one
        lib = {(1, 1): lambda: outs[0].copy_(x),
               (2, 1): lambda: torch.add(x, ys[0], alpha=1.5, out=outs[0]),
               }.get((reads, writes)) if passes == 1 else None
        library_ms = time_ms(lib, n) if lib is not None else None
        dev = {"device_ms": device_ms(lambda: mb.rw(
                   x, *ys, reads=reads, writes=writes, outs=outs,
                   block_rows=br, passes=passes), n),
               "library_device_ms": (device_ms(lib, n)
                                     if lib is not None else None)}
        mix = get_mix(rw_name(reads, writes))
        nb = mix.bytes_per_pass(x.numel() * x.element_size()) * passes
        b = bytes_bound(nb, (reads + writes) * x.numel() * x.element_size())
        t_ops = (mix.flops_per_pass(x.numel()) * passes
                 / PEAK_FLOPS["float32"])
        entries.append({
            "name": "rw", "mix": mix.name, "route": "cuda",
            "source": "src/repro_torch/kernels/membench/csrc/rw.cu",
            "replaces": REPLACES["rw"], "launches": launches,
            "max_abs_err": err, "tolerance": 0.0,
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            **bound_fields(b, t_ops),
            "library_ms": library_ms, **dev,
            "shape": list(x.shape), "dtype": dname, "nbytes": nbytes,
            "block_rows": br, "passes": passes,
        })
        e = entries[-1]
        say(f"  {mix.name:9s} {dname:8s} {nbytes:>11d} B x{passes:<4d} "
            f"ms {ms:.4f}  "
            f"(host {host_ms:.4f})  {bound_note(e)}  plain "
            f"{plain_ms:.4f}  library "
            f"{'-' if library_ms is None else f'{library_ms:.4f}'}  "
            f"err {err:.1f}" + device_note(dev))
        del ys, outs
    return entries


def chase_entry(nbytes: int, launches: int) -> dict:
    """The ``kernels`` entry of the idle chase on a float32 working set of
    ``nbytes`` (one pass at the default tiling), held exactly against its
    plain version on an off-cycle permutation.  Its bound is the load
    latency, which no data-sheet rate states: ``bound_ms`` is the bytes rule
    (the int32 buffer read once, ``bytes_bound``), far below it, and
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
        **bound_fields(bytes_bound(nb, nb), 0.0),
        "bound_note": "load latency, one dependent load per step; the bytes "
                      "rule is far below it",
        "ns_per_step": ms * 1e6 / perm.numel(),
        "library_ms": None,
        "shape": list(perm.shape), "dtype": "int32", "nbytes": nbytes,
        "block_rows": br, "passes": 1,
    }
    say(f"  chase     int32    {nbytes:>11d} B  ms {ms:.4f}  (host "
        f"{host_ms:.4f})  {e['ns_per_step']:.3f} ns/step  "
        f"{bound_note(e)}  plain {plain_ms:.4f}  library -  "
        f"err {e['max_abs_err']:.1f} of {want:.1f}")
    return e


def model_kernel_entries(counts: dict[str, int], errs: dict[str, float]
                         ) -> list[dict]:
    """The ``kernels`` entries of flash_attn and ssd_scan at the serving
    shapes: kernel ms (CUDA events, back to back) and device ms (the calls
    enqueued behind a device-side sleep), plain ms, the library call's ms
    (flash: ``scaled_dot_product_attention`` on the same bf16 tensors, timed
    here and used nowhere in the port; the SSD has no single library call),
    and the bound.  Bounds: operations per the reference's
    ``flops`` at the card's peak for the input type (bf16: 989 TFLOP/s),
    against each input read once and each output written once
    (``bytes_bound``: both fit the L2, so at the SMs' load/store path; B
    and C of the SSD are counted as the storage their stride-0 views
    cover)."""
    entries = []
    q, k, v = flash_inputs(*FLASH_SERVE, torch.bfloat16, seed=80)
    ms, host_ms = time_both_ms(lambda: fa.flash_attention(q, k, v), 20)
    plain_ms = time_ms(lambda: fa.plain_flash(q, k, v), 5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    library_ms = time_ms(sdpa, 20)
    dev = {"device_ms": device_ms(lambda: fa.flash_attention(q, k, v), 20),
           "library_device_ms": device_ms(sdpa, 20)}
    nb = 2 * (q.numel() + k.numel() + v.numel()) + 2 * q.numel()
    nf = fa_ops.flops(q, k, True)
    b, t_ops = bytes_bound(nb, nb), nf / PEAK_FLOPS["bfloat16_tensor"]
    entries.append({
        "name": "flash_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attn.cu",
        "replaces": REPLACES["flash_attn"],
        "launches": counts.get("flash_attn", 0),
        "max_abs_err": errs["flash_attn"], "tolerance": FLASH_TOL["bfloat16"],
        "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
        **bound_fields(b, t_ops),
        "library_ms": library_ms, **dev, "flops": nf, "bytes": nb,
        "shape": list(FLASH_SERVE), "dtype": "bfloat16", "causal": True,
    })
    del q, k, v, qt, kt, vt
    xdt, dA, Bv, Cv = serve_ssd_inputs()
    chunk = SSD_SERVE[-1]
    BH, S, P = xdt.shape
    N = Bv.shape[-1]
    ms, host_ms = time_both_ms(lambda: sk.ssd_scan(xdt, dA, Bv, Cv,
                                                   chunk=chunk), 20)
    B3, C3 = Bv.reshape(BH, S, N), Cv.reshape(BH, S, N)
    plain_ms = time_ms(lambda: sk.plain_ssd(xdt, dA, B3, C3), 3)
    dev = {"device_ms": device_ms(lambda: sk.ssd_scan(xdt, dA, Bv, Cv,
                                                      chunk=chunk), 20)}
    nb = (2 * xdt.numel() * xdt.element_size()                # x in, y out
          + dA.numel() * 4 + 2 * 2 * SSD_SERVE[0] * S * N     # dA, B, C
          + BH * N * P * 4)                                   # state out
    nf = ssd_ops.flops(BH, S, P, N, chunk)
    b, t_ops = bytes_bound(nb, nb), nf / PEAK_FLOPS["bfloat16_tensor"]
    entries.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": REPLACES["ssd_scan"],
        "launches": counts.get("ssd_scan", 0),
        "max_abs_err": errs["ssd_scan"], "tolerance": SSD_TOL,
        "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
        **bound_fields(b, t_ops),
        "library_ms": None, **dev, "flops": nf, "bytes": nb,
        "shape": list(SSD_SERVE), "dtype": "bfloat16",
    })
    for e in entries:
        lib = "-" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
        say(f"  {e['name']:10s} {e['dtype']:8s} {e['shape']}  ms "
            f"{e['ms']:.4f}  (host {e['host_ms']:.4f})  {bound_note(e)} "
            f"({e['flops'] / 1e9:.2f} GFLOP, {e['bytes'] / 1e6:.2f} MB)  "
            f"plain {e['plain_ms']:.4f}  "
            f"library {lib}  err {e['max_abs_err']:.2e}"
            + (f"  device {e['device_ms']:.4f}" if "device_ms" in e else "")
            + (f" vs library {e['library_device_ms']:.4f}"
               if "library_device_ms" in e else ""))
    return entries


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
    errs = phase_model_kernels(args.quick)
    counts = phase_main_path(args.quick)
    counts["rw"] = phase_rw_path(args.quick)["rw"]
    counts["chase"] = phase_latency_path(args.quick)["chase"]
    counts.update(phase_serve_path(args.quick))
    phase_real(args.quick)
    phase_real_rw_chase(args.quick)
    line = phase_kernels_line(counts, args.quick)
    line["kernels"] += model_kernel_entries(counts, errs)
    say(f"== all phases passed in {time.perf_counter() - t0:.1f} s")
    say(info["smi"])
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
