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
     as whole opcodes) and none spills (the SASS read by
     ``repro_torch.istream.extract``); every template instance
     ``membench.launch_record`` predicts for the registry is in the SASS.
  2  every kernel against its plain version on the card, over dtypes, sizes,
     tilings (with 8 address streams, and the default tiling of each
     stream count fig1 runs), interleave, unroll and passes, on the
     benchmark's working set
     (whose sums cancel) and on a non-cancelling ramp input with a relative
     tolerance (mxu also against a dense operand); the fma chain's depth;
     bit-identical repeat runs; streams 1, 2, 4 and 8 give the same
     load_sum (also at fig1's 32 KiB, one tile a stream at 8); the
     timed forms against the plain oracles of the ``torch`` backend.  The rw
     kernel over the R:W ladder (and 1:8, 8:1, 8:8) bit for bit against its
     plain version, and equal to copy / triad at 1:1 / 2:1; the chase on
     ``chase_perm`` (exactly 0.0) and on permutations whose walk ends
     elsewhere (exact equality), the loaded composite, repeat runs, and both
     timed forms against the ``torch`` oracles.  2c: flash attention
     against ``plain_flash`` (the reference test's shapes, head dims 80 and
     128, causal and not, float32 and bfloat16, block-shape invariance) and
     the SSD against ``plain_ssd`` (the reference test's shapes, chunk
     invariance, stride-0 B/C views, route 0 at N 128 in float32, route 2
     at width 64 on a chunk of 672 that route 1 cannot stage), both
     also at the serving shapes;
     flash also at the five dense / vlm serving shapes, (4, 512, H, KV, D)
     bf16: granite (32, 8, 64), stablelm (32, 32, 80), phi3 (40, 10, 128),
     internlm2 (48, 8, 128), chameleon (64, 8, 128).  Then the ssm / encdec
     / mla shapes: flash with value heads of their own width, (D, Dv) =
     (192, 128), at small shapes (float32 and bfloat16, causal and not)
     and at deepseek's (4, 512, 128, 128) bf16 causal; Sq != Sk with a
     ragged tail both ways; whisper's encoder (4, 1500, 16, 16, 64) and
     cross-attention (4, 256 against 1500, 16, 16, 64), non-causal, float32
     and bfloat16, with whole-sequence blocks; the SSD at mamba2's serving
     shape (4 x 80 heads, 512, P 64, N 128, chunk 256) on route 2.  Then
     both kernels at a rank's shapes of a ``model`` axis of 2 and 4, as the
     tensor-parallel prefills launch them (``rank_shapes``, bf16): flash at
     granite's (4, 512, 16, 4, 64) / (4, 512, 8, 2, 64), zamba2's site
     (16 / 8 heads of 80), deepseek's 64 / 32 heads of (192, 128),
     whisper's encoder (4, 1500, 8 / 4 heads, 64) non-causal; the SSD at
     zamba2's and mamba2's 40 / 20 SSD heads (mamba2's N 128 on route 2).
     Then flash with a causal query offset, as a rank of a ``model`` axis
     of 16 launches it where the heads do not divide and the attention
     splits its queries' sequence (``sharding.Heads.seq``): train_4k's
     block of 16 x 256 queries against the keys up to its end (Sk 256 (r
     + 1), q_offset 256 r) for phi3-medium-14b (40 / 10 heads) and
     arctic-480b (56 / 8), D 128, ranks 0 and 15, bf16: against
     ``plain_flash`` with the offset, and bit for bit against those rows
     of the whole sequence's launch without one.
  3  the main paths, each with the launch counters set to 0 just before and
     read just after: ``run --backend cuda`` over the working-set ladder
     32 KiB .. 2 GiB for the six first mixes, then for the rw ladder, float32
     then bfloat16; ``latency --backend cuda`` (idle and loaded); the result
     JSON is read back and checked; ``compare`` of ``torch`` vs ``cuda``.
     3d: ``python -m repro_torch.launch.serve --arch zamba2-2.7b --batch 4
     --prompt-len 512 --gen 16`` at full width (9 flash and 54 SSD launches
     in its one prefill, the SSD's all on route 1, counted by route; no
     membench launch), then in process the kernel
     route's prefill against the plain route's, and two decode steps.
     Then the dense / vlm families: ``serve --arch granite-3-2b`` on the
     same batch at full width (40 flash launches, no SSD, no membench), in
     process every layer's attention on both routes from the same input,
     the prefill logits on both routes, warm prefill and decode times; then
     stablelm-3b, phi3-medium-14b, internlm2-20b and chameleon-34b at full
     width cut to 2 layers through ``serve.run`` (2 flash launches each),
     their routes held the same way.  Then the ssm, encdec and moe
     families: ``serve --arch mamba2-2.7b`` (full width and depth: 64 SSD
     launches, all on route 2; no flash) and ``serve --arch whisper-medium --prompt-len
     256`` (full width and depth: 24 encoder + 24 self + 24 cross = 72
     flash launches, no SSD), deepseek-v2-236b at full width cut to 2
     layers (2 flash launches at (192, 128)) and arctic-480b reduced
     through ``serve.run``; each with its routes held layer by layer and
     whole, warm prefill and decode times (mamba2's whole prefill also
     beside a third route, its SSD by the kernel's plain version in
     float32: at 64 layers the model's own sensitivity to rounding exceeds
     the logits tolerance, and the kernel route is then held to that
     sensitivity, ``SENSITIVITY_RATIO``).
     3e: ``python -m repro_torch.bench characterize --smoke --backend cuda
     --compare nvidia-h100-sxm`` (host-paced: the reference's preset), then
     a device-paced characterization through the API (the ``--full``
     preset's mixes and grid at CHARACTERIZE_TARGET_BYTES a call, every
     call >= 1 ms, >= 2 levels) and a device-paced copy sweep on the same
     grid, acc.cu / copy.cu launches equal to points x (reps + warmup) in
     each, then ``history`` and a self-``diff`` of the ledger.
     3f: ``audit --backend cuda`` (the live audit of the whole registry and
     knob grid over the SASS of this build: exit 0, every waiver listed),
     ``audit --write-goldens`` into the output directory (every file equal
     to ``tests/data_torch/sass``, or the diff is printed and the phase
     fails), ``istream --smoke --backend cuda`` (copy.cu and rw.cu; every
     point labelled; launches = points x (reps + warmup)) and ``latency
     --smoke --backend cuda`` (chase.cu and acc.cu; four checked audits).
     3g: the multi-device bench, chase.cu (the mesh's chase probe on a
     CUDA shard) the one kernel launched: ``run --backend sharded
     --devices 1`` beside ``run --backend torch`` for every torch mix at 16
     MiB and 256 MiB (latency_chase at 16 MiB only: the torch oracle walks
     on the host) — the same accounting, the same returned scalar on the
     same buffer, every dispatch a mesh of 1 on cuda:0; ``--devices 2``
     exits 2 naming the one visible device; ``launch --processes 1`` on
     NCCL; ``launch --processes 2 --devices-per-process 2 --device cpu`` on
     gloo (the straggler merge checked); ``launch --processes 2`` on CUDA
     refused before anything is spawned; ``core.scaling.scaling_curve`` at
     devices 1; chase.cu at the probe's one-tile 16 MiB shape exactly
     equal to the plain walk on an off-cycle permutation; the mesh probe's
     latency_ns at 16 MiB within MESH_PROBE_TOL of chase.cu's walking the
     same buffer alone.
     3h: the paper's figures — ``python -m benchmarks_torch.run --only
     <entry>`` for bench, fig1-fig7 and table1 at the quick grids on the
     ``cuda`` backend (in this process, so that the launches are counted;
     table1 also as a program): every row the declarations give and no
     other, every GB/s under the SMs' load/store rate, every latency >= 5
     ns and loaded >= idle (to within LOADED_NOISE), fig3's kernel check
     and SASS profiles; then fig2's points by device time (behind a
     device-side sleep, and ``torch.profiler``'s) beside their wall and
     CUDA-event times.
     3i: the collective and straggler studies —
     ``benchmarks_torch.collective_bench_main --mesh 1x1`` through
     ``launch_local`` (one NCCL rank: exit 0, nothing to measure); the five
     collectives on a one-rank NCCL group at 8 MiB, each equal to the
     host's value, with their times; ``ft.stragglers.probe_devices`` on the
     card (acc.cu's load_sum, reps + 1 launches; its scalar against the
     plain load_sum); ``examples_torch/characterize_machine.py``.
     3j: training — ``Trainer`` on granite-3-2b at full width (2.53 G
     float32 parameters, remat full), batch 4 x 512, 8 steps of AdamW: every
     loss printed and finite, the last below the first; step wall and
     device-busy time, tokens/s, model TFLOP/s, peak memory, one AdamW
     update alone; training's last-position logits (``hidden_states``)
     against the serving prefill on the same weights and tokens (plain
     route within 1e-2, kernel route within 3d's 0.15); the card against
     the CPU at full width on 2 layers (loss and every gradient leaf within
     2e-2); one step of each of the ten archs reduced; a checkpoint round at
     reduced width restored bit for bit and resumed; one step at 2 layers
     through a ``ShardCtx`` over a one-rank NCCL world (the held
     parameters, the pipeline's block, the mesh step) bit for bit the
     ``ctx=None`` step's (the 4-GPU half: ``tools/mesh_check.py --steps
     train``).  Training launches
     neither model kernel (the reference's are forward only): 0 flash, 0
     SSD, 0 membench launches, ``launches_train`` in the kernels line.
     3k: serving on a mesh, its one-card half, through ``make_smoke_ctx()``
     and the held layout (``shard_params``: on one position the whole
     leaves) — zamba2-2.7b at full width, batch 1: a 1 x 512 prefill through
     ``make_prefill_step`` (9 flash, 54 SSD launches, ``launches_mesh_serve``
     in the kernels line) fills the first rows of a 131,072-token KV cache
     a site (12.08 GB: a GPU's share of long_500k over 4), a seed the rest;
     16 greedy tokens through ``make_decode_step(seq_shard_decode=True)``,
     the plain decode fed the same tokens on a copy (logits within 3d's
     0.15, ms a token both ways), and at each position one step both ways
     from the same state (``tools/mesh_check.hold_decode_at``: every
     site's attention within 2e-2, the cache update bit for bit); then
     ``moe_layer`` through the one-device ctx against no ctx at
     deepseek-v2-236b's layer shapes, bit for bit.  The 4-GPU half is
     ``tools/mesh_check.py --steps flash_decode,moe_ep``.
     3l: the dry run and the roofline — ``python -m
     repro_torch.launch.dryrun`` and ``launch.probe`` (host only: meta
     tensors on a fake world of 256 ranks; started with phase 1 in
     subprocesses of their own, at low priority, one thread each, beside
     the builds and the checks of phase 2, which time nothing, and waited
     for before phase 3's first timed run) for
     granite-3-2b x train_4k and phi3-medium-14b x prefill_32k on the
     single-pod mesh: status ok, the probe's parts equal to the whole
     step, the rank's state within 80 GB; phi3's record lists the
     ``act_heads`` fallback and its rank's attention FLOPs are at most
     (2n - 1) / n**2 of one device's.  Then the roofline of the one-card
     paths timed above, by the same counts (``FlopCounterMode`` on meta
     tensors, ``roofline.model_bytes.analytic_bytes`` on one device):
     3j's granite-3-2b train step and 3d's granite-3-2b prefill (kernel
     route; counted on the plain route, whose one masked attention block
     at 512 tokens holds the kernel's products and more), t_compute,
     t_memory and the larger over the measured device-busy ms: a share
     above 1.0 fails (the count would be wrong).  No new timed run.
  4  the measurement is real: doubling ``passes`` doubles the time (also
     for acc.cu and copy.cu at 32 KiB and 1 MiB), no GB/s above the card's
     memory rate at 2 GiB nor above the SMs' load/store rate (128 B a clock
     an SM) at any size, mxu below the float32 peak and,
     on the bfloat16 working set, below the bf16 tensor-core peak; the chase
     at least 5 ns per dependent step, loaded latency not below idle.
  5  one JSON line listing every kernel with its time, its plain version's,
     the library call's, and its bound (flash_attn and ssd_scan at the
     serving shapes; bytes at the SMs' load/store rate where a call's
     buffers fit the L2, at the HBM rate above it, ``bytes_bound``; the
     SSD's operations those the function needs, ``ssd_ops.work_flops``);
     every
     membench kernel and rw ladder member, and flash_attn, and their library
     calls, also by device time (the calls enqueued behind a device-side
     sleep; flash also at granite-3-2b's shape, under ``dense``, and as
     entries of their own at deepseek's (192, 128) shape and whisper's
     encoder and cross-attention shapes; the SSD also at mamba2's shape);
     the membench kernels and the rw ladder also at the Runner's
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
import os
import re
import shutil
import subprocess
import sys
import time
import types
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "tools"))       # mesh_check (phase 3k)

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False — this script "
          "needs one CUDA device", file=sys.stderr)
    sys.exit(2)

import numpy as np  # noqa: E402

from repro_torch.bench import cli  # noqa: E402
from repro_torch.bench.mixes import (GEN_SWEEPS_PER_PASS,  # noqa: E402
                                     get_mix, mix_names, rw_name)
from repro_torch.bench.result import BenchResult  # noqa: E402
from repro_torch.bench.runner import Runner  # noqa: E402
from repro_torch.characterize import (FittedMachineModel,  # noqa: E402
                                      adaptive_sweep, characterize,
                                      render_markdown)
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core import instruction_mix as im  # noqa: E402
from repro_torch.core.buffers import (working_set,  # noqa: E402
                                     working_set_shape)
from repro_torch.core.machine_model import get_spec  # noqa: E402
from repro_torch.istream.extract import (GLOBAL_LOAD_OPS,  # noqa: E402
                                         loads_in_loops, sass_of, sass_ops)
from repro_torch.kernels.build import build_libraries, find_nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.membench import membench as mb  # noqa: E402
from repro_torch.kernels.membench import ops as mb_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as sk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models.common import (apply_mlp, apply_norm,  # noqa: E402
                                       embed_tokens, init_params, lm_logits)
from repro_torch.models.common import (  # noqa: E402
    tree_index as layer_params)
from repro_torch.models.registry import build, make_batch  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.ssm import mamba_prefill  # noqa: E402
from repro_torch.models.variant import BASELINE  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    spec_map, tree_leaves, tree_leaves_with_paths)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

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
#: device-busy ms of the timed runs 3l's roofline reads: 3d's granite
#: prefill (kernel route) and 3j's further train step
BUSY_MS: dict[str, float | None] = {}


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
    check_launch_names(built)
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


def check_launch_names(built: dict) -> None:
    """Raise unless every template instance ``membench.launch_record``
    predicts (every registry mix, float32 and bfloat16, every unroll and
    interleave the kernels are compiled for, a 32 KiB and a 2 GiB buffer:
    both grid shapes) is in the SASS of its built library."""
    sass = {src: set(sass_of(path)) for src, path in built["membench"].items()}
    props = torch.cuda.get_device_properties(DEV)
    sms, l2 = props.multi_processor_count, props.L2_cache_size
    seen = set()
    for name in mix_names("cuda"):
        mix = get_mix(name)
        for dtype in ("float32", "bfloat16"):
            for nbytes in (32 * 2**10, 2 * 2**30):
                rows = nbytes // (128 * (4 if dtype == "float32" else 2))
                for unroll in mb.UNROLLS:
                    for k in (mb.INTERLEAVES if name in ("load_sum", "copy")
                              or mix.rw else (1,)):
                        knobs = {"unroll": unroll, "interleave": k,
                                 "load": 1 if mix.chase else 0}
                        for r in mb.launch_record(name, dtype, (rows, 128),
                                                  knobs, unroll, sms, l2):
                            if r["kernel"] not in sass[r["source"]]:
                                raise AssertionError(
                                    f"launch_record names {r['kernel']} "
                                    f"({name}, {dtype}, {nbytes} B, {knobs})"
                                    f", which {r['source']}'s SASS does not "
                                    f"hold")
                            seen.add(r["kernel"])
    say(f"  launch_record: {len(seen)} template instances predicted for the "
        f"registry (both grid shapes, every unroll / interleave, float32 and "
        f"bfloat16), each found in its library's SASS")


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


def stream_tilings(rows: int) -> list[tuple[int, int]]:
    """The (block_rows, streams) tilings phase 2 holds every kernel at on a
    buffer of ``rows`` rows: fixed ones, and the default tiling for each
    stream count the figures run (``default_block_rows(rows, streams)``,
    which fig1's streams ladder reaches on the cuda backend)."""
    fixed = [(8, 1), (32, 2), (16, 4), (8, 8)]
    default = [(mb.default_block_rows(rows, s), s) for s in (1, 2, 4, 8)]
    return list(dict.fromkeys(fixed + default))


def phase_kernels(quick: bool) -> None:
    say("== phase 2: kernels against their plain versions on the card")
    t0 = time.perf_counter()
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
            tilings = stream_tilings(rows)
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
    # (64 KiB, 16-row tiles: at streams 8 one tile a stream), and at fig1's
    # 32 KiB on the default tiling of each stream count (8 tiles of 8 rows
    # at streams 8)
    for nbytes in (64 * KiB, 32 * KiB):
        x = ramp_input(working_set(nbytes, device=DEV))
        want = float(mb.plain_load_sum(x))
        outs = [float(mb.load_sum(
            x, streams=s, block_rows=(16 if nbytes == 64 * KiB else
                                      mb.default_block_rows(x.shape[0], s))))
            for s in (1, 2, 4, 8)]
        if max(abs(o - want) for o in outs) > SUM_RTOL * abs(want):
            raise AssertionError(f"stream orders disagree at {nbytes} B: "
                                 f"{outs} vs {want}")
        say(f"  load_sum over streams 1,2,4,8 at {nbytes} B: {outs} "
            f"(plain {want})")

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
    say(f"  phase 2: {time.perf_counter() - t0:.1f} s")


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
#: the dense / vlm serving path: granite-3-2b at full width (40 layers) on
#: the hybrid's batch, prompt and generation, then the other four configs
#: of the families at full width cut to DENSE_DEPTH layers (at full depth
#: internlm2-20b and chameleon-34b do not fit 80 GB in float32); every
#: real attention shape of the families stays on the card
DENSE_SERVE = "granite-3-2b"
DENSE_CUT = ("stablelm-3b", "phi3-medium-14b", "internlm2-20b",
             "chameleon-34b")
DENSE_DEPTH = 2
DENSE_ARGV = ["--arch", DENSE_SERVE, "--batch", str(SERVE_B),
              "--prompt-len", str(SERVE_P), "--gen", str(SERVE_G)]
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


#: phase 3d's other families, one H100: mamba2-2.7b (ssm, 11.33 GB of
#: float32 weights) and whisper-medium (encdec, 3.25 GB; prompts of 256:
#: its text context is 448 tokens, and 256 keeps the flash block rule) at
#: full width and depth; deepseek-v2-236b (moe + mla) at full width cut to
#: DENSE_DEPTH layers (36.6 GB, and a per-call bf16 copy of a layer's 160
#: experts, 7.5 GB); arctic-480b (moe + dense residual) reduced: one
#: full-width layer is 56.3 GB in float32 and its 128 experts' bf16 copy
#: 26.8 GB more, so no full-width layer fits one card (expert parallelism,
#: ROADMAP Queue A 8)
SSM_SERVE, ENCDEC_SERVE, ENCDEC_P = "mamba2-2.7b", "whisper-medium", 256
MLA_SERVE, MOE_REDUCED = "deepseek-v2-236b", "arctic-480b"
SSM_ARGV = ["--arch", SSM_SERVE, "--batch", str(SERVE_B), "--prompt-len",
            str(SERVE_P), "--gen", str(SERVE_G)]
ENCDEC_ARGV = ["--arch", ENCDEC_SERVE, "--batch", str(SERVE_B),
               "--prompt-len", str(ENCDEC_P), "--gen", str(SERVE_G)]
#: flash's value heads of their own width at small shapes (B, Sq, Sk, H,
#: KV, D, Dv), both dtypes, both causal flags; and Sq != Sk, a ragged
#: tail both ways
DV_FLASH_SHAPES = [(2, 128, 128, 8, 4, 192, 128), (1, 200, 200, 4, 4, 192, 128),
                   (2, 300, 100, 4, 2, 192, 128), (2, 100, 300, 4, 2, 64, 64)]


def family_shapes() -> dict:
    """The kernels' shapes on the ssm / encdec / mla serving paths: flash
    (B, Sq, Sk, H, KV, D, Dv) with its causal flag, bf16; the SSD (B, H, S,
    P, N, chunk)."""
    ds, wh, mb2 = get_arch(MLA_SERVE), get_arch(ENCDEC_SERVE), \
        get_arch(SSM_SERVE)
    m, s = ds.mla, mb2.ssm
    A, hd = wh.n_audio_ctx, wh.resolved_head_dim
    return {
        "mla": ((SERVE_B, SERVE_P, SERVE_P, ds.n_heads, ds.n_heads,
                 m.nope_head_dim + m.rope_head_dim, m.v_head_dim), True),
        "encoder": ((SERVE_B, A, A, wh.n_heads, wh.n_kv_heads, hd, hd),
                    False),
        "cross": ((SERVE_B, ENCDEC_P, A, wh.n_heads, wh.n_kv_heads, hd, hd),
                  False),
        "ssd": (SERVE_B, s.expand * mb2.d_model // s.head_dim, SERVE_P,
                s.head_dim, s.d_state, s.chunk_size),
    }


def dense_flash_shape(arch: str) -> tuple:
    """flash's (B, S, H, KV, D) on the dense serving path of ``arch``."""
    cfg = get_arch(arch)
    return (SERVE_B, SERVE_P, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim)


def _randn(shape, dtype, gen, scale=1.0) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def flash_inputs(B, S, H, KV, D, dtype, seed) -> tuple:
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (_randn((B, S, H, D), dtype, g), _randn((B, S, KV, D), dtype, g),
            _randn((B, S, KV, D), dtype, g))


def flash_qkv(B, Sq, Sk, H, KV, D, Dv, dtype, seed) -> tuple:
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (_randn((B, Sq, H, D), dtype, g), _randn((B, Sk, KV, D), dtype, g),
            _randn((B, Sk, KV, Dv), dtype, g))


def hold_flash(q, k, v, causal: bool, label: str, q_offset: int = 0
               ) -> float:
    """The kernel against plain_flash on the card; raises unless every
    element is within the reference's tolerance.  Returns the max abs
    error.  The blocks are encdec's rule (256, or the whole sequence where
    256 does not divide it): they change nothing in the kernel's tiling."""
    got = fa.flash_attention(q, k, v, causal=causal,
                             q_block=encdec_mod.flash_block(q.shape[1]),
                             kv_block=encdec_mod.flash_block(k.shape[1]),
                             q_offset=q_offset)
    want = fa.plain_flash(q, k, v, causal=causal, q_offset=q_offset).float()
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


def serve_ssd_inputs(seed: int = 64, shape: tuple = SSD_SERVE) -> tuple:
    """The SSD's inputs at a serving shape (B, H, S, P, N, chunk), laid out
    as the model's kernel route lays them out: x and dA per head (B*H, S,
    ·), B and C one (S, N) matrix per batch row expanded over its H heads
    with stride 0."""
    B, H, S, P, N, _ = shape
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
    # the dense / vlm serving shapes (phase 3d): head dims 64, 80 and 128,
    # GQA groups 1, 4, 6 and 8
    dense = {}
    for arch in (DENSE_SERVE,) + DENSE_CUT:
        shape = dense_flash_shape(arch)
        q, k, v = flash_inputs(*shape, torch.bfloat16, seed=sum(shape))
        dense[arch] = hold_flash(q, k, v, True, f"{arch} {shape}")
        del q, k, v
    say(f"  flash at the dense / vlm serving shapes, bf16 causal, max abs "
        f"err: " + "; ".join(f"{a} {dense_flash_shape(a)} {e:.3e}"
                             for a, e in dense.items()))

    n = 0
    for BH, S, P, N, Q in SSD_SHAPES:
        for dname, dtype in DTYPES.items():
            err = hold_ssd(*ssd_inputs(BH, S, P, N, dtype, seed=BH + S), Q,
                           f"{dname} {(BH, S, P, N)}")
            worst[f"ssd/{dname}"] = max(worst.get(f"ssd/{dname}", 0.0), err)
            n += 1
    # a bf16 shape the tensor-core routes do not take (P not a multiple
    # of 8): route 0 on inputs widened to float32
    if sk.launch_plan(2, 12, 8, 16, torch.bfloat16)["route"] != 0:
        raise AssertionError("ssd: P 12 should take route 0")
    err = hold_ssd(*ssd_inputs(2, 64, 12, 8, torch.bfloat16, seed=12), 16,
                   "bfloat16 (2, 64, 12, 8) route 0")
    worst["ssd/bfloat16"] = max(worst["ssd/bfloat16"], err)
    n += 1
    # route 0 at N 128 (float32: mamba2's width, which bfloat16 sends to
    # route 2)
    if sk.launch_plan(2, 32, 128, 64, torch.float32)["route"] != 0:
        raise AssertionError("ssd: float32 at N 128 should take route 0")
    err = hold_ssd(*ssd_inputs(2, 256, 32, 128, torch.float32, seed=128), 64,
                   "float32 (2, 256, 32, 128) route 0")
    worst["ssd/float32"] = max(worst["ssd/float32"], err)
    n += 1
    # route 2 at width 64: a chunk too long for route 1 to stage
    if sk.launch_plan(2, 64, 64, 672, torch.bfloat16)["route"] != 2:
        raise AssertionError("ssd: bf16 N 64 at chunk 672 should take "
                             "route 2")
    err = hold_ssd(*ssd_inputs(2, 672, 64, 64, torch.bfloat16, seed=672),
                   672, "bfloat16 (2, 672, 64, 64) chunk 672 route 2")
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
    return {"flash_attn": serve_flash, "ssd_scan": serve_ssd,
            "flash_attn_dense": dense}


def phase_family_kernels(quick: bool) -> dict[str, float]:
    """2c for the ssm / encdec / mla paths: flash with Dv != D ((192, 128),
    small shapes, float32 and bfloat16, both causal flags; deepseek's mla
    shape), Sq != Sk and a sequence of 1500 with whole-sequence blocks
    (whisper's encoder and cross-attention, float32 and bfloat16); the SSD
    at mamba2's serving shape on route 2 (N 128 is wider than route 1
    takes).  Returns the max abs error of each serving shape (bf16)."""
    say("== phase 2c (ssm / encdec / mla): flash at (D, Dv) = (192, 128), "
        "Sq != Sk, 1500 frames; the SSD at mamba2's shape")
    shapes = family_shapes()
    worst: dict[str, float] = {}
    n = 0
    for shape in DV_FLASH_SHAPES[:2] if quick else DV_FLASH_SHAPES:
        for dname, dtype in DTYPES.items():
            q, k, v = flash_qkv(*shape, dtype, seed=sum(shape))
            for causal in (True, False):
                err = hold_flash(q, k, v, causal, f"{dname} {shape}")
                worst[f"small/{dname}"] = max(worst.get(f"small/{dname}",
                                                        0.0), err)
                n += 1
    errs = {}
    for key in ("mla", "encoder", "cross"):
        shape, causal = shapes[key]
        for dname in ("float32", "bfloat16") if key != "mla" else \
                ("bfloat16",):
            q, k, v = flash_qkv(*shape, DTYPES[dname], seed=sum(shape))
            err = hold_flash(q, k, v, causal, f"{key} {shape} {dname}")
            if dname == "bfloat16":
                errs[key] = err
            else:
                worst[f"{key}/float32"] = err
            n += 1
            del q, k, v
    say(f"  {n} flash cases within the reference's tolerances; small shapes "
        f"and float32 worst max abs err {worst}; at the serving shapes, bf16: "
        + "; ".join(f"{key} {shapes[key][0]} causal={shapes[key][1]} "
                    f"{errs[key]:.3e}" for key in errs))
    shape = shapes["ssd"]
    xdt, dA, Bv, Cv = serve_ssd_inputs(seed=128, shape=shape)
    BH, S = dA.shape
    plan = sk.launch_plan(BH, xdt.shape[-1], Bv.shape[-1], shape[-1],
                          xdt.dtype, sms=torch.cuda.get_device_properties(
                              DEV).multi_processor_count)
    if plan["route"] != 2:
        raise AssertionError(f"ssd at mamba2's shape {shape}: route "
                             f"{plan['route']}, expected 2 (N 128)")
    errs["ssd"] = hold_ssd(xdt, dA, Bv, Cv, shape[-1], f"mamba2 {shape}")
    del xdt, dA, Bv, Cv
    say(f"  ssd at mamba2's serving shape {shape} bf16: {errs['ssd']:.3e} "
        f"(tolerance {SSD_TOL}; route {plan['route']}, {plan['grid']} CTAs, "
        f"{plan['smem_bytes']} B of shared memory, {plan['ctas_per_sm']} an "
        f"SM, {plan['waves']:.2f} waves, last {plan['last_wave']} of "
        f"{plan['slots']})")
    torch.cuda.empty_cache()
    return errs


#: tensor parallelism over ``model``: the archs whose prefill kernels run
#: at a rank's heads, and the model axis sizes held
RANK_TP = (2, 4)
RANK_FLASH = (DENSE_SERVE, "zamba2-2.7b", MLA_SERVE, ENCDEC_SERVE)
RANK_SSD = ("zamba2-2.7b", SSM_SERVE)


def rank_shapes(tp: int) -> tuple[dict, dict]:
    """The kernels' shapes at rank 0 of a ``model`` axis of ``tp``
    (``sharding.rank_heads``, ``rank_block``): flash (B, Sq, Sk, H, KV,
    D, Dv) with its causal flag for the dense, hybrid, mla and encoder
    prefills (KV the heads the rank's query heads read: its own, or one a
    query head where ``kv_heads`` falls back to whole); the SSD (B, H, S,
    P, N, chunk) at the rank's SSD heads."""
    from repro_torch.distributed.sharding import (AbstractMesh, ShardCtx,
                                                  rank_block, rank_heads)
    ctx = ShardCtx(AbstractMesh((1, 1, tp), ("pod", "data", "model")))
    flash, ssd = {}, {}
    for arch in RANK_FLASH:
        cfg = get_arch(arch)
        kv = cfg.n_heads if cfg.mla is not None else cfg.n_kv_heads
        h = rank_heads(ctx, cfg.n_heads, kv, 0)
        nkv = h.nq if h.kv_of_q is not None else h.nkv
        if cfg.mla is not None:
            m = cfg.mla
            d, dv = m.nope_head_dim + m.rope_head_dim, m.v_head_dim
        else:
            d = dv = cfg.resolved_head_dim
        S = cfg.n_audio_ctx if cfg.family == "encdec" else SERVE_P
        flash[arch] = ((SERVE_B, S, S, h.nq, nkv, d, dv),
                       cfg.family != "encdec")
    for arch in RANK_SSD:
        cfg = get_arch(arch)
        s = cfg.ssm
        H = s.expand * cfg.d_model // s.head_dim
        ssd[arch] = (SERVE_B, rank_block(ctx, "heads", H, 0)[1], SERVE_P,
                     s.head_dim, s.d_state, s.chunk_size)
    return flash, ssd


def phase_rank_kernels(quick: bool) -> dict[str, dict]:
    """2c at a rank's shapes: ``flash_attn.cu`` and ``ssd_scan.cu`` as a
    rank of a ``model`` axis of 2 and 4 launches them in the prefills
    (granite-3-2b's 16 / 8 query heads, zamba2's site, deepseek's 32 heads
    of (192, 128), whisper's encoder at 1500 frames; the SSD at zamba2's
    and mamba2's 40 / 20 SSD heads, mamba2's N 128 on route 2), bf16,
    against their plain versions.  Returns the max abs error at each."""
    say("== phase 2c (a rank's shapes): flash and the SSD as a rank of a "
        "model axis of " + " and ".join(map(str, RANK_TP)) + " launches "
        "them")
    errs: dict[str, dict] = {"flash_attn": {}, "ssd_scan": {}}
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    for tp in RANK_TP[-1:] if quick else RANK_TP:
        flash, ssd = rank_shapes(tp)
        for arch, (shape, causal) in flash.items():
            q, k, v = flash_qkv(*shape, torch.bfloat16, seed=sum(shape))
            errs["flash_attn"][f"{arch} tp{tp} {shape}"] = hold_flash(
                q, k, v, causal, f"{arch} tp {tp} {shape}")
            del q, k, v
        for arch, shape in ssd.items():
            xdt, dA, Bv, Cv = serve_ssd_inputs(seed=sum(shape), shape=shape)
            plan = sk.launch_plan(dA.shape[0], shape[3], shape[4],
                                  shape[-1], xdt.dtype, sms=sms)
            if plan["route"] != (2 if shape[4] == 128 else 1):
                raise AssertionError(f"ssd {arch} tp {tp} {shape}: route "
                                     f"{plan['route']}")
            errs["ssd_scan"][f"{arch} tp{tp} {shape} route "
                             f"{plan['route']}"] = hold_ssd(
                xdt, dA, Bv, Cv, shape[-1], f"{arch} tp {tp} {shape}")
            del xdt, dA, Bv, Cv
    torch.cuda.empty_cache()
    for name, e in errs.items():
        say(f"  {name} at a rank's shapes, bf16, max abs err: "
            + "; ".join(f"{k} {v:.3e}" for k, v in e.items()))
    return errs


#: 2c's query-offset launches: a rank of train_4k's production mesh,
#: (data 16, model 16), where the heads do not divide 16 and the attention
#: splits its queries' sequence (``sharding.Heads.seq``): the rank's 16 of
#: 256 sequences, its 256 of 4096 positions, against the keys up to its
#: block's end; ranks 0 and 15
OFFSET_TP, OFFSET_B, OFFSET_S = 16, 16, 4096
OFFSET_ARCHS = ("phi3-medium-14b", "arctic-480b")
OFFSET_RANKS = (0, OFFSET_TP - 1)


def offset_shapes() -> list[tuple]:
    """[(arch, rank, (B, Sq, Sk, H, KV, D, Dv), q_offset)] of 2c's
    query-offset launches."""
    sq = OFFSET_S // OFFSET_TP
    out = []
    for arch in OFFSET_ARCHS:
        cfg = get_arch(arch)
        d = cfg.resolved_head_dim
        for r in OFFSET_RANKS:
            out.append((arch, r, (OFFSET_B, sq, sq * (r + 1), cfg.n_heads,
                                  cfg.n_kv_heads, d, d), sq * r))
    return out


def phase_offset_kernels(quick: bool) -> dict[str, float]:
    """2c, the query offset: ``flash_attn.cu`` at ``offset_shapes()``,
    bf16, against ``plain_flash`` with the same offset, and bit for bit
    against the same rows of the whole sequence's launch at offset 0 (the
    CTAs tile the rows alike, so the offset moves only the mask).  Returns
    the max abs error at each, and the launches these comparisons made
    (``launches``)."""
    say("== phase 2c (a rank's query block): flash with a causal query "
        f"offset at train_4k's rank shapes on a model axis of {OFFSET_TP} "
        f"(the act_seq fallback), ranks {OFFSET_RANKS}")
    errs: dict[str, float] = {}
    before = fa.launch_counts["flash_attn"]
    offsets_before = fa.offset_launch_counts["flash_attn"]
    cases = offset_shapes()[:2] if quick else offset_shapes()
    for arch, r, shape, q0 in cases:
        B, Sq, Sk, H, KV, D, Dv = shape
        qf, k, v = flash_qkv(B, Sk, Sk, H, KV, D, Dv, torch.bfloat16,
                             seed=sum(shape))
        q = qf[:, q0:].contiguous()
        label = f"{arch} rank {r} {shape} q_offset {q0}"
        errs[label] = hold_flash(q, k, v, True, label, q_offset=q0)
        whole = fa.flash_attention(qf, k, v)[:, q0:]
        block = fa.flash_attention(q, k, v, q_offset=q0)
        if not torch.equal(whole, block):
            raise AssertionError(f"flash {label}: the offset launch differs "
                                 f"from the whole launch's rows")
        del qf, q, k, v, whole, block
    torch.cuda.empty_cache()
    errs["launches"] = fa.launch_counts["flash_attn"] - before
    # the held launch and the block's launch of each case with an offset
    offsets = fa.offset_launch_counts["flash_attn"] - offsets_before
    if offsets != 2 * sum(1 for c in cases if c[3]):
        raise AssertionError(f"flash's offset launches counted {offsets} "
                             f"for {cases}")
    say("  flash with a query offset, bf16, max abs err (tolerance "
        f"{FLASH_TOL['bfloat16']}): " + "; ".join(
            f"{k} {v:.3e}" for k, v in errs.items() if k != "launches")
        + "; each equal to the whole sequence's launch in its rows")
    return errs


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
# phase 3f — the accounting audit and istream on the SASS
# ---------------------------------------------------------------------------

#: the committed SASS goldens (``audit --write-goldens`` writes them here)
GOLDENS = ROOT / "tests" / "data_torch" / "sass"


def _golden_diff() -> list[str]:
    """Write the goldens into the output directory and compare every file
    with the committed ones; returns the differences (a unified diff, cut
    to 40 lines a file)."""
    import difflib
    fresh = OUT_DIR / "goldens"
    shutil.rmtree(fresh, ignore_errors=True)
    rc, text = _cli(["audit", "--write-goldens", str(fresh)])
    if rc != 0:
        raise AssertionError(f"audit --write-goldens exited {rc}:\n{text}")
    say("  " + text.strip())
    diffs = []
    names = sorted({p.name for p in fresh.iterdir()}
                   | {p.name for p in GOLDENS.iterdir() if p.is_file()})
    for name in names:
        a, b = GOLDENS / name, fresh / name
        if not a.exists() or not b.exists():
            diffs.append(f"{name}: only in "
                         f"{'the fresh goldens' if b.exists() else 'the repo'}")
            continue
        if a.read_text() != b.read_text():
            d = list(difflib.unified_diff(a.read_text().splitlines(),
                                          b.read_text().splitlines(),
                                          f"committed/{name}",
                                          f"fresh/{name}", lineterm="", n=1))
            diffs.append("\n".join(d[:40]))
    return diffs


def phase_audit_path(quick: bool) -> dict[str, int]:
    """The live cuda audit of the whole registry and knob grid (exit 0, every
    waiver listed), the goldens regenerated and held against the committed
    ones, ``istream --smoke --backend cuda`` (copy.cu and rw.cu launched,
    every point labelled, launches = points x (reps + warmup)), and
    ``latency --smoke --backend cuda`` (chase.cu and acc.cu launched, four
    checked audits).  Returns the launches of the two timed runs: copy and
    rw from istream's, chase and load_sum from latency's."""
    say("== phase 3f: the accounting audit and istream on the kernels' SASS")
    t0 = time.perf_counter()
    out = OUT_DIR / "audit_cuda.json"
    rc, text = _cli(["audit", "--backend", "cuda", "--out", str(out),
                     "--force"])
    (OUT_DIR / "audit_cuda.txt").write_text(text)
    doc = json.loads(out.read_text())
    for line in text.splitlines():
        if line.startswith("# waived") or "cases:" in line:
            say("  audit --backend cuda " + line)
    if rc != 0 or not doc["ok"] or doc["summary"]["violations"]:
        bad = [c for c in doc["cases"] if not c["ok"]]
        raise AssertionError(f"live cuda audit exited {rc}: "
                             f"{json.dumps(bad)[:4000]}")
    if doc["summary"]["skipped"]:
        raise AssertionError(f"live cuda audit skipped cases: "
                             f"{doc['skipped']}")
    say(f"  {doc['summary']} over {len(doc['cases'])} cases in "
        f"{time.perf_counter() - t0:.1f} s")
    for c in doc["cases"]:
        exp = c["expected"] or {}
        say(f"    {c['backend']}/{c['mix']} {c['knobs']}: observed "
            f"{c['observed'].get('loads', 0):.0f} / "
            f"{c['observed'].get('stores', 0):.0f} / "
            f"{c['observed'].get('arith', 0):.0f} vs expected "
            f"{exp.get('loads', 0):.0f} / {exp.get('stores', 0):.0f} / "
            f"{exp.get('arith', 0):.0f} loads / stores / arith elems a pass")

    diffs = _golden_diff()
    if diffs:
        raise AssertionError("the regenerated goldens differ from "
                             "tests/data_torch/sass (a kernel changed: "
                             "commit new goldens):\n" + "\n".join(diffs))
    say(f"  goldens: every file of {GOLDENS.relative_to(ROOT)} equals the "
        f"one written from this checkout's build")

    mb.reset_launch_counts()
    t1 = time.perf_counter()
    out = OUT_DIR / "istream_smoke.json"
    rc, text = _cli(["istream", "--smoke", "--backend", "cuda", "--out",
                     str(out), "--force", "--history-root",
                     str(OUT_DIR / "BENCH_history")])
    sync()
    counts = read_counts(("copy", "rw"), "istream --smoke")
    (OUT_DIR / "istream_smoke.txt").write_text(text)
    if rc != 0:
        raise AssertionError(f"istream --smoke exited {rc}:\n{text}")
    res = BenchResult.from_json(out)
    unlabelled = [p for p in res.points if not p.istream
                  or p.istream.get("label") not in ("bandwidth-bound",
                                                    "issue-bound")]
    if not res.points or unlabelled:
        raise AssertionError(f"istream --smoke: {len(unlabelled)} of "
                             f"{len(res.points)} points carry no label")
    warmup = (res.spec.get("many") or [res.spec])[0]["warmup"]
    for kernel, mix in (("copy", "copy"), ("rw", "rw_2to1")):
        pts = [p for p in res.points if p.mix == mix]
        want = sum(p.reps + warmup for p in pts)
        if not pts or counts[kernel] != want:
            raise AssertionError(f"istream --smoke: {counts[kernel]} "
                                 f"{kernel} launches, want {len(pts)} points"
                                 f" x (reps + warmup) = {want}")
    say("  " + text.rstrip().replace("\n", "\n  "))
    say(f"  istream --smoke: {len(res.points)} points, every one labelled, "
        f"launches {counts['copy']} copy + {counts['rw']} rw = points x "
        f"(reps + warmup), {time.perf_counter() - t1:.1f} s")

    mb.reset_launch_counts()
    rc, text = _cli(["latency", "--smoke", "--backend", "cuda", "--out",
                     str(OUT_DIR / "latency_smoke.json"), "--force",
                     "--history-root", str(OUT_DIR / "BENCH_history")])
    sync()
    read_counts(("chase", "load_sum"), "latency --smoke")
    audits = [ln for ln in text.splitlines() if ln.startswith("# audit ")]
    say("  " + "\n  ".join(audits))
    if rc != 0 or len(audits) != 4 or not all(ln.endswith(": ok")
                                               for ln in audits):
        raise AssertionError(f"latency --smoke exited {rc} with audits "
                             f"{audits}:\n{text}")
    doc = json.loads((OUT_DIR / "latency_smoke.json").read_text())
    if [a["source"] for a in doc["meta"]["audit"]] != ["live"] * 4:
        raise AssertionError(f"latency --smoke audits were not all live: "
                             f"{doc['meta']['audit']}")
    say(f"  phase 3f: {time.perf_counter() - t0:.1f} s")
    counts["chase"] = mb.launch_counts["chase"]
    counts["load_sum"] = mb.launch_counts["load_sum"]
    return counts


# ---------------------------------------------------------------------------
# phase 3g — the multi-device bench (sharded, distributed, launch, scaling)
# ---------------------------------------------------------------------------

#: the sizes of 3g's ``run --backend torch`` / ``--backend sharded`` pair.
#: latency_chase runs at the first only: the torch oracle walks the chain on
#: the host (4.2e6 dependent steps a pass at 16 MiB, 6.7e7 at 256 MiB).
MESH_SIZES = ("16M", "256M")
#: how far the mesh probe's latency_ns may lie from chase.cu's walking the
#: same one-tile buffer back to back (the Runner's call adds a sync and the
#: pass sum's add to calls of ~0.1 s or more)
MESH_PROBE_TOL = 0.10


def _cli_both(argv: list[str]) -> tuple[int, str, str]:
    """Run the CLI in this process; returns (exit code, stdout, stderr) —
    a launch's workers stream into the stderr captured here."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _all_launches() -> dict[str, int]:
    return {**mb.launch_counts, **fa.launch_counts, **sk.launch_counts}


def _mesh_tol(mix: str, n: int, passes: int, value: float) -> float:
    """The torch oracle's own bound at one shard (the tolerances of
    ``tests/test_torch_oracles.py`` and ``test_torch_rw.py``): sums n x
    1.3e-7 x passes x depth (floor 1e-4), element checksums 1e-6 |v| +
    1e-6, rw 1e-6 |v| + (R-1) ulp(4) (passes + W), the chase exactly."""
    if mix == "latency_chase":
        return 0.0
    if mix in ("copy", "triad", "mxu"):
        return 1e-6 * abs(value) + 1e-6
    if mix.startswith("rw_"):
        reads, writes = get_mix(mix).rw
        ulp = float(np.spacing(np.float32(4.0)))
        return 1e-6 * abs(value) + (reads - 1) * ulp * (passes + writes)
    depth = int(mix.split("_")[1]) if mix.startswith("fma_") else 1
    return max(n * 1.3e-7 * passes * depth, 1e-4)


def _mesh_points(path: Path) -> dict:
    return {(p.mix, p.nbytes): p for p in BenchResult.from_json(path).points}


def phase_mesh_path(quick: bool) -> None:
    """(a) ``run --backend sharded --devices 1`` beside ``run --backend
    torch`` for every torch mix: same accounting, the same returned scalar
    on the same buffer, the mesh [1] on cuda:0; (b) ``--devices 2`` on one
    card exits 2 naming the visible count; (c) ``launch --processes 1`` on
    NCCL; (d) ``launch --processes 2 --devices-per-process 2 --device cpu``
    on gloo, the straggler merge checked; (e) ``launch --processes 2`` on
    CUDA refused before anything is spawned; (f) ``scaling_curve`` at
    devices 1; (g) the mesh's chase probe: ``latency_ns`` of ``sharded
    --devices 1`` at 16 MiB against ``chase.cu`` walking the same buffer as
    one tile, and below the torch oracle's host walk.  The one kernel of the
    port that runs here is ``chase.cu``, the probe of a CUDA shard: every
    other launch counter stays at 0, chase's counts the launches of the
    chase points."""
    say("== phase 3g: the multi-device bench (run --backend sharded, launch, "
        "scaling_curve)")
    from repro_torch.bench.backends import get_backend
    from repro_torch.bench.spec import BenchSpec
    from repro_torch.core.scaling import scaling_curve
    t0 = time.perf_counter()
    for mod in (mb, fa, sk):
        mod.reset_launch_counts()
    mixes = mix_names("torch")
    sizes = ("1M",) if quick else MESH_SIZES
    hist = ["--history-root", str(OUT_DIR / "BENCH_history")]

    # (a) the mesh of one beside the torch backend, in turns: torch,
    # sharded, sharded, torch, then sharded traced (its dispatch events are
    # read); the chase, whose oracle walks on the host, in the first torch
    # turn and the traced one only
    turns = (("torch", "a", False), ("sharded", "a", False),
             ("sharded", "b", False), ("torch", "b", False),
             ("sharded", "traced", True))
    for backend, tag, traced in turns:
        for i, size in enumerate(sizes):
            names = [m for m in mixes if m != "latency_chase"
                     or (i == 0 and (backend, tag) in (("torch", "a"),
                                                       ("sharded",
                                                        "traced")))]
            out = OUT_DIR / f"mesh_{backend}_{tag}_{size}.json"
            argv = ["run", "--backend", backend, "--devices", "1",
                    "--mixes", ",".join(names), "--sizes", size, "--reps",
                    "3", "--force", "--out", str(out), *hist]
            if traced:
                argv += ["--trace", str(OUT_DIR / f"mesh_trace_{size}.json")]
            rc, text, err = _cli_both(argv)
            cli.trace.configure(enabled=False)
            sync()
            if rc != 0:
                raise AssertionError(f"run --backend {backend} exited {rc}:"
                                     f"\n{text}\n{err}")
    card = f"one H100, mesh of 1 ({torch.cuda.get_device_name(0)})"
    say(f"  {card}, GB/s in turns: torch / sharded / sharded / torch / "
        f"sharded traced")
    for size in sizes:
        runs = [_mesh_points(OUT_DIR / f"mesh_{b}_{tag}_{size}.json")
                for b, tag, _ in turns]
        for p in sorted(runs[0].values(), key=lambda p: mixes.index(p.mix)):
            pts = [r.get((p.mix, p.nbytes)) for r in runs]
            q = pts[0]
            for (backend, _, _), r in zip(turns, pts):
                if r is None:
                    continue
                if (r.bytes_per_call, r.flops_per_call, r.passes) != \
                        (q.bytes_per_call, q.flops_per_call, q.passes) \
                        or r.devices != 1 or r.backend != backend \
                        or not (math.isfinite(r.gbps) and r.gbps > 0):
                    raise AssertionError(f"{r} against torch {q}")
            if pts[-1] is None:
                raise AssertionError(f"the traced sharded turn lacks {p}")
            say(f"    {p.mix:13s} {p.nbytes:>10d} B  "
                + " / ".join("-" if r is None else f"{r.gbps:.2f}"
                             for r in pts)
                + f"  passes {p.passes}")
        events = json.loads((OUT_DIR / f"mesh_trace_{size}.json")
                            .read_text())["traceEvents"]
        shapes = {tuple(e["args"]["mesh_shape"]) for e in events
                  if e["name"] == "backend.dispatch"}
        places = {tuple(e["args"]["devices"]) for e in events
                  if e["name"] == "mesh.place"}
        if shapes != {(1,)} or places != {(str(DEV),)}:
            raise AssertionError(f"dispatch mesh shapes {shapes}, "
                                 f"placements {places}")
    say(f"  torch and sharded agree on bytes_per_call / flops_per_call / "
        f"passes; every dispatch is mesh_shape [1], placed on {DEV}")

    worst = 0.0
    for size in sizes:
        nbytes = cli._parse_sizes(size)[0]
        x = working_set(nbytes, device=DEV)
        for name in mixes:
            if name == "latency_chase" and size != sizes[0]:
                continue
            passes = 1 if name == "latency_chase" else 2
            mix = get_mix(name)
            spec = BenchSpec(mixes=(name,), sizes=(nbytes,), passes=passes)
            want = float(get_backend("torch").build(
                spec, mix, x, passes)())
            got = float(get_backend("sharded").build(
                spec.replace(backend="sharded"), mix, x, passes)())
            tol = _mesh_tol(name, x.numel(), passes, want) \
                + float(np.finfo(np.float32).eps) * abs(want)
            worst = max(worst, abs(got - want))
            if not abs(got - want) <= tol:
                raise AssertionError(f"sharded {name} at {size}: {got} "
                                     f"against torch {want} (tol {tol})")
        del x
        torch.cuda.empty_cache()
    say(f"  returned scalars: sharded at devices 1 equals torch on the same "
        f"buffer for {len(mixes)} mixes at {', '.join(sizes)} (largest "
        f"difference {worst:.3e})")

    # (b) more devices than the card has
    rc, text, err = _cli_both(["run", "--backend", "sharded", "--devices",
                               "2", "--mixes", "load_sum", "--sizes", "16M",
                               "--no-ledger"])
    if rc != 2 or "devices=2 exceeds the 1 visible device(s)" not in err:
        raise AssertionError(f"sharded --devices 2 exited {rc}:\n{err}")
    say("  --devices 2 on one card: exit 2, " + err.strip())

    # (c) one process on NCCL
    out = OUT_DIR / "launch_nccl.json"
    out.unlink(missing_ok=True)
    t1 = time.perf_counter()
    rc, text, err = _cli_both(["launch", "--processes", "1",
                               "--devices-per-process", "1", "--mixes",
                               "load_sum,copy", "--sizes", "16M", "--reps",
                               "3", "--timeout", "300", "--out", str(out),
                               *hist])
    if rc != 0:
        raise AssertionError(f"launch on NCCL exited {rc}:\n{text}\n{err}")
    doc = json.loads(out.read_text())
    if doc["machine"]["process_count"] != 1 \
            or doc["machine"]["device_platform"] != "gpu" \
            or [p["devices"] for p in doc["points"]] != [1, 1] \
            or {p["backend"] for p in doc["points"]} != {"distributed"}:
        raise AssertionError(f"launch on NCCL: {doc['machine']} "
                             f"{doc['points']}")
    for p in doc["points"]:
        say(f"  launch --processes 1 (NCCL, one H100): {p['mix']} "
            f"{p['nbytes']} B  {p['gbps']:.2f} GB/s")
    say(f"  launch on NCCL: {time.perf_counter() - t1:.1f} s")

    # (d) two processes of two logical CPU devices on gloo
    out = OUT_DIR / "launch_gloo.json"
    out.unlink(missing_ok=True)
    t1 = time.perf_counter()
    rc, text, err = _cli_both(["launch", "--processes", "2",
                               "--devices-per-process", "2", "--device",
                               "cpu", "--mixes", "load_sum,copy", "--sizes",
                               "1M", "--reps", "2", "--timeout", "300",
                               "--out", str(out), *hist])
    if rc != 0 or "[p1] # process 1/2 done" not in err:
        raise AssertionError(f"launch on gloo exited {rc}:\n{text}\n{err}")
    doc = json.loads(out.read_text())
    m, rows = doc["machine"], doc["meta"]["per_process_mean_s"]
    if (m["process_count"], m["local_device_counts"], m["device_count"]) \
            != (2, [2, 2], 4) or len(rows) != 2 \
            or any(p["devices"] != 4 for p in doc["points"]):
        raise AssertionError(f"launch on gloo: {m} {doc['points']}")
    for i, p in enumerate(doc["points"]):
        if p["mean_s"] != max(r[i] for r in rows) or not math.isclose(
                p["gbps"], p["bytes_per_call"] / p["mean_s"] / 1e9):
            raise AssertionError(f"straggler merge: {p} against {rows}")
    say(f"  launch --processes 2 --devices-per-process 2 --device cpu "
        f"(gloo): local_device_counts [2, 2], each point the slowest "
        f"process's, {time.perf_counter() - t1:.1f} s")

    # (e) more GPUs than the card has: refused before anything is spawned
    out = OUT_DIR / "launch_refused.json"
    out.unlink(missing_ok=True)
    rc, text, err = _cli_both(["launch", "--processes", "2",
                               "--devices-per-process", "1", "--mixes",
                               "load_sum", "--sizes", "16M", "--out",
                               str(out), "--no-ledger"])
    if rc == 0 or "needs 2 GPUs; 1 visible" not in err or out.exists() \
            or "[p0]" in err:
        raise AssertionError(f"launch of 2 on one card exited {rc}:\n{err}")
    say("  launch --processes 2 on one card: exit 2, " + err.strip())

    # (f) the scaling view at devices 1
    pts = scaling_curve(16 * 2**20, device_counts=[1], runner=Runner())
    if len(pts) != 1 or pts[0].devices != 1 or pts[0].speedup != 1.0 \
            or not pts[0].gbps > 0:
        raise AssertionError(f"scaling_curve: {pts}")
    say(f"  scaling_curve(16 MiB, [1]) ({card}): {pts[0].gbps:.2f} GB/s, "
        f"speedup {pts[0].speedup}")

    # the chase points: the traced sharded turn's (passes x (reps +
    # warmup) launches) and the scalar check's one pass
    (chase_pt,) = [p for p in BenchResult.from_json(
        OUT_DIR / f"mesh_sharded_traced_{sizes[0]}.json").points
        if p.mix == "latency_chase"]
    want = {"chase": chase_pt.passes * (chase_pt.reps
                                        + BenchSpec().warmup) + 1}
    launched = {k: v for k, v in _all_launches().items() if v}
    if launched != want:
        raise AssertionError(f"phase 3g launched {launched}; the mesh's "
                             f"chase probe alone accounts for {want}")
    say(f"  launches: {launched}, all of them the mesh's chase probe")

    # (g) the probe's latency against chase.cu's on the same buffer
    nbytes = cli._parse_sizes(sizes[0])[0]
    mb.reset_launch_counts()
    (pt,) = Runner(device=DEV).run(BenchSpec(
        mixes=("latency_chase",), sizes=(nbytes,), backend="sharded",
        devices=1, reps=3, warmup=1)).points
    if dict(mb.launch_counts, chase=0) != dict.fromkeys(mb.launch_counts, 0) \
            or mb.launch_counts["chase"] != pt.passes * (pt.reps + 1):
        raise AssertionError(f"the mesh probe's launches: {mb.launch_counts}"
                             f" for {pt.passes} passes x {pt.reps + 1} calls")
    rows, lanes = working_set_shape(nbytes)
    perm = torch.tensor(im.chase_perm((rows, lanes)), device=DEV)
    direct_ms = time_ms(lambda: mb.chase(perm, block_rows=rows,
                                         passes=pt.passes), 3, warmup=1)
    direct_ns = direct_ms * 1e6 / (pt.passes * rows * lanes)
    host = [p for p in BenchResult.from_json(
        OUT_DIR / f"mesh_torch_a_{sizes[0]}.json").points
        if p.mix == "latency_chase"][0]
    # the probe's one-tile shape (one thread walks the whole shard) against
    # the plain walk on an off-cycle permutation, where a skipped, repeated
    # or early-ended step moves the result (on chase_perm both give 0.0);
    # the plain walk runs on a host copy, one gather a step
    off = off_cycle_perm((rows, lanes), rows, seed=5)
    t1 = time.perf_counter()
    got = float(mb.chase(off, block_rows=rows, passes=1))
    want = float(mb.plain_chase(off.cpu(), block_rows=rows, passes=1))
    if got != want or want == 0.0:
        raise AssertionError(f"chase.cu at the probe's one-tile shape "
                             f"({nbytes} B): {got} vs plain {want}")
    say(f"  chase.cu at the probe's one-tile shape ({rows * lanes} steps) on "
        f"an off-cycle permutation: {got}, exactly the plain walk's "
        f"({time.perf_counter() - t1:.1f} s)")
    del off
    say(f"  mesh probe (sharded --devices 1, {nbytes} B, one tile): "
        f"{pt.latency_ns:.2f} ns a step; chase.cu on the same buffer "
        f"{direct_ns:.2f} ns; the torch oracle's host walk "
        f"{host.latency_ns:.2f} ns")
    if not (abs(pt.latency_ns - direct_ns) <= MESH_PROBE_TOL * direct_ns
            and 5 <= pt.latency_ns < host.latency_ns):
        raise AssertionError(f"mesh probe {pt.latency_ns} ns against "
                             f"chase.cu's {direct_ns} ns (tolerance "
                             f"{MESH_PROBE_TOL:.0%}) and the host walk's "
                             f"{host.latency_ns} ns")
    del perm
    say(f"  phase 3g: {time.perf_counter() - t0:.1f} s")


#: the entries of ``python -m benchmarks_torch.run`` phase 3h runs, fig2
#: first (table1 reads its model)
FIGURE_ENTRIES = ("fig2", "table1", "bench", "fig1", "fig3", "fig4", "fig5",
                  "fig6", "fig7")
FIGURE_ROW = re.compile(r"^([a-z0-9_]+/[^,]+),(-?[0-9.]+),(.*)$")
#: a point whose device time is below this share of its wall time is paced
#: by the host
HOST_PACED_SHARE = 0.5
#: how far below its idle point a fig7 point may read.  Time-shared, the
#: quick grid's generators add under 1 % to a probe pass (16 load_sum
#: sweeps of 128 KiB against 32768 dependent steps), so loaded and idle
#: differ by the measurement's noise: over four runs of this phase the
#: loaded points read from 1.8 % below to 1.4 % above idle (NVIDIA H100
#: 80GB HBM3, 700 W; PERF.md §6).  At this grid the check cannot tell a
#: working composite from one whose generators did nothing; it catches only
#: gross faults, a composite whose probe steps overlapped or were skipped,
#: which reads far lower.
LOADED_NOISE = 0.05


def figure_rows(entry: str) -> list[str]:
    """The row names an entry must print at its quick grid: every point of
    its declared grid (``tests/test_torch_figures*.py`` hold the
    declarations and the names equal to the reference's, the backend names
    mapped by ``repro_torch.convert``), named by the script's own
    ``row_name``, on the ``cuda`` backend and one card."""
    from benchmarks_torch import (fig1_addressing as f1, fig2_hierarchy as f2,
                                  fig3_blockshape as f3, fig4_scaling as f4,
                                  fig5_rw_ratio as f5, fig6_istream as f6,
                                  fig7_loaded_latency as f7, table1_machine)

    def real(n: int) -> int:
        rows, lanes = working_set_shape(n)
        return rows * lanes * 4

    def grid(spec, name):
        return [name(m, real(n)) for n in spec.sizes for m in spec.mixes]
    if entry == "bench":
        return grid(cli.quick_spec(backend="cuda"),
                    lambda m, n: cli.row_name("cuda", m, n))
    if entry == "fig1":
        return [f1.row_name(s.streams, real(n))
                for s in f1.specs(True) for n in s.sizes]
    if entry == "fig2":
        return grid(f2.spec_for(True), f2.row_name)
    if entry == "fig3":
        (n,) = f3.spec_for(True).sizes
        rows = [r for r in f3.rows_for(True)       # the rows that divide it
                if working_set_shape(n)[0] % r == 0]
        return [f3.row_name(r, real(n)) for r in rows] \
            + [f3.ecm_row_name(r) for r in rows]
    if entry == "fig4":
        return [f4.row_name("fig4", 1), f4.triad_row_name("fig4", 1)]
    if entry == "fig5":
        return grid(f5.spec_for(True, device=DEV), f5.row_name)
    if entry == "fig6":
        g = f6.grid(True)
        return [f6.row_name(b, m, u, i, real(n)) for b in f6.BACKENDS
                for m in f6.MIXES for n in g["sizes"] for u in g["unrolls"]
                for i in g["interleaves"]]
    if entry == "fig7":
        g = f7.grid(True)
        return [f7.row_name("cuda", real(n), load) for n in g["sizes"]
                for load in g["loads"]]
    if entry == "table1":
        return [table1_machine.ROW]
    raise KeyError(entry)


def check_figure(entry: str, text: str) -> list[tuple]:
    """An entry's printed rows against ``figure_rows`` and the validity
    limits of PERF.md §2: every GB/s under the SMs' load/store rate, every
    latency >= 5 ns, loaded latency >= idle at each size (to within
    LOADED_NOISE); fig3's kernel check printed and its profiles extracted.
    Returns the rows as (name, us, derived)."""
    rows = [m.groups() for m in map(FIGURE_ROW.match, text.splitlines())
            if m]
    names = [r[0] for r in rows]
    want = figure_rows(entry)
    if sorted(names) != sorted(want):
        raise AssertionError(
            f"{entry}: rows {sorted(set(names) ^ set(want))} differ from the "
            f"declarations ({len(names)} printed, {len(want)} declared)")
    limit = ON_CHIP["bytes_per_s"] / 1e9
    idle = {}
    for name, _, derived in rows:
        for gbps in re.findall(r"([0-9.]+)GB/s", derived):
            if not 0 <= float(gbps) <= limit:
                raise AssertionError(f"{entry}: {name} {derived}: above the "
                                     f"SMs' {limit:.0f} GB/s")
        lat = re.match(r"([0-9.]+)ns;", derived)
        if lat:
            ns = float(lat.group(1))
            if ns < 5:
                raise AssertionError(f"{name}: {ns} ns a dependent step")
            size, load = name.split("/")[2], int(name.split("load")[-1])
            if load == 0:
                idle[size] = ns
            elif ns < idle[size] * (1 - LOADED_NOISE):
                raise AssertionError(f"{name}: loaded {ns} ns below idle "
                                     f"{idle[size]} ns by more than "
                                     f"{LOADED_NOISE:.0%}")
    if entry == "fig3":
        if "# ecm: profile extraction failed" in text:
            raise AssertionError("fig3: the SASS profile failed:\n" + text)
        if "verified vs oracle (acc.cu on cuda" not in text:
            raise AssertionError("fig3: no kernel check printed:\n" + text)
    return rows


def fig2_device_times() -> list[str]:
    """Each fig2 point of ``artifacts/torch/fig2_sweep.json`` again: its
    case's device time (``device_ms``: calls enqueued behind a device-side
    sleep) beside the Runner's mean wall time, CUDA events' mean over calls
    back to back and the kernel time ``torch.profiler`` records in one call
    (where it records any); the point is host-paced where the device's
    share of its wall time is below HOST_PACED_SHARE."""
    from benchmarks_torch import fig2_hierarchy
    from repro_torch.bench.backends import get_backend
    from repro_torch.bench.spec import BenchSpec
    res = BenchResult.from_json(fig2_hierarchy.ART / "fig2_sweep.json")
    lines = [f"    {'mix':8s} {'bytes':>10s} {'passes':>6s} {'wall us':>9s} "
             f"{'event us':>9s} {'device us':>9s} {'profiler us':>12s}  "
             f"paced by"]
    for p in res.points:
        x = working_set(p.nbytes, device=DEV)
        spec = BenchSpec(mixes=(p.mix,), sizes=(p.nbytes,), backend="cuda",
                         passes=p.passes)
        fn = get_backend("cuda").build(spec, get_mix(p.mix), x, p.passes)
        dev_us = device_ms(fn, 5) * 1e3
        ev_us = time_ms(fn, 5) * 1e3
        prof_ms, _ = device_busy_ms(fn)
        paced = ("host" if dev_us < HOST_PACED_SHARE * p.mean_s * 1e6
                 else "device")
        lines.append(f"    {p.mix:8s} {p.nbytes:10d} {p.passes:6d} "
                     f"{p.mean_s * 1e6:9.1f} {ev_us:9.1f} {dev_us:9.1f} "
                     + (f"{'not measured':>12s}" if prof_ms is None else
                        f"{prof_ms * 1e3:12.1f}") + f"  {paced}")
        del x, fn
    return lines


def phase_figures_path(quick: bool) -> dict[str, int]:
    """``python -m benchmarks_torch.run --only <entry>`` for every entry at
    its quick grid on the card (``--backend cuda``, fig4 at the one card):
    table1 as a program, every entry in this process through the same
    ``main`` (so that its launches are counted), each entry's counters set
    to 0 just before it and read just after.  Fails on a non-zero exit, a
    ``FAILED`` line, a row the declarations do not give, or a broken
    validity limit (``check_figure``).  Then fig2's points by device
    time."""
    say("== phase 3h: the paper's figures and Table 1 (python -m "
        "benchmarks_torch.run --only <entry>)")
    from benchmarks_torch import run as figures_run
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    total: dict[str, int] = {}
    for entry in FIGURE_ENTRIES:
        t1 = time.perf_counter()
        mb.reset_launch_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = figures_run.main(["--only", entry])
        sync()
        text = out.getvalue()
        (OUT_DIR / f"figures_{entry}.txt").write_text(text)
        if rc != 0 or "FAILED" in text:
            raise AssertionError(f"benchmarks_torch.run --only {entry} "
                                 f"exited {rc}:\n{text}")
        rows = check_figure(entry, text)
        counts = {k: v for k, v in mb.launch_counts.items() if v}
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        say(f"  {entry}: {len(rows)} rows as declared, "
            f"{time.perf_counter() - t1:.1f} s, launches {counts}")
    for line in text.splitlines():
        if "# " in line and ("idle" in line or "knee" in line):
            say("  fig7 " + line.strip())
    # the module entry point itself, as a program
    r = subprocess.run([sys.executable, "-m", "benchmarks_torch.run",
                        "--only", "table1"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0 or "FAILED" in r.stdout:
        raise AssertionError(f"python -m benchmarks_torch.run --only table1 "
                             f"exited {r.returncode}:\n{r.stdout}{r.stderr}")
    check_figure("table1", r.stdout)
    systems = [line for line in r.stdout.splitlines()
               if line.startswith("## ") and not line.startswith("## table1")]
    say(f"  python -m benchmarks_torch.run --only table1: exit 0, "
        f"{len(systems)} systems")
    for line in r.stdout.splitlines():
        if line.startswith("## ") or "measured(best mix)" in line:
            say("    " + line.strip())
    say("  fig2's points by device time (calls behind a device-side sleep; "
        "torch.profiler, one call) beside the Runner's wall time and CUDA "
        "events:")
    for line in fig2_device_times():
        say(line)
    say(f"  phase 3h: {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


# ---------------------------------------------------------------------------
# phase 3i — the collective and straggler studies
# ---------------------------------------------------------------------------

#: the collective study's global buffer: the reference's full size
COLLECTIVE_BYTES = 8 * MiB


def phase_collectives_path(quick: bool) -> dict[str, int]:
    """3i: ``benchmarks_torch.collective_bench_main --mesh 1x1`` through
    ``launch_local`` (one NCCL rank; its one axis has one device, so it
    measures nothing and says so); the five collectives through
    ``bench_collective`` on a one-rank NCCL group, each output equal to the
    host's (n = 1: every op returns its input); ``probe_devices`` on the
    card (acc.cu load_sum, reps + 1 launches) and its scalar against the
    plain load_sum on the benchmark's working set and the ramp input;
    ``examples_torch/characterize_machine.py``.  Returns acc.cu's
    launches by the probe."""
    import torch.distributed as tdist

    from repro_torch.bench import distributed as dist
    from repro_torch.core import collective_bench as cb
    from repro_torch.ft import stragglers
    from repro_torch.launch.mesh import make_mesh
    say("== phase 3i: the collective and straggler studies")
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "benchmarks_torch.collective_bench_main", "--mesh",
                        "1x1"] + (["--quick"] if quick else []), cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    if r.returncode != 0 or "has two devices; nothing measured" \
            not in r.stdout:
        raise AssertionError(f"collective_bench_main --mesh 1x1 exited "
                             f"{r.returncode}:\n{r.stdout}\n"
                             f"{r.stderr[-4000:]}")
    say(f"  collective_bench_main --mesh 1x1 (one NCCL rank through "
        f"launch_local): exit 0 in {time.perf_counter() - t0:.1f} s: "
        f"{r.stdout.strip().splitlines()[-1]}")

    own = not tdist.is_initialized()
    if own:
        dist.initialize(f"127.0.0.1:{dist.pick_free_port()}", 1, 0, DEV)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=DEV)
        host = cb.global_input(1, COLLECTIVE_BYTES, device="cpu")
        for op in cb.OPS:
            fn, arg, payload = cb.collective_case(mesh, "model", op,
                                                  COLLECTIVE_BYTES)
            got = fn(arg).cpu()
            if not torch.equal(got, cb.plain_output(op, host, 0)):
                raise AssertionError(f"{op} on a one-rank NCCL group: not "
                                     f"the host's value")
            res = cb.bench_collective(mesh, "model", op, COLLECTIVE_BYTES)
            say(f"  {op:14s} one rank, {payload / MiB:.0f} MiB: equal to the "
                f"host's; {res.mean_s * 1e6:.1f} us (σ "
                f"{res.std_s * 1e6:.1f}), algo {res.algo_gbps:.1f} GB/s "
                f"(a copy on one card; link {res.link_gbps:.1f})")
    finally:
        if own:
            dist._shutdown()

    mb.reset_launch_counts()
    nbytes, passes, reps = 4 * MiB, 4, 5
    probes = stragglers.probe_devices(nbytes=nbytes, passes=passes, reps=reps,
                                      device=DEV)
    launched = dict(mb.launch_counts)
    want = {k: (reps + 1 if k == "load_sum" else 0) for k in launched}
    if launched != want or len(probes) != torch.cuda.device_count():
        raise AssertionError(f"probe_devices launched {launched}, expected "
                             f"{want}")
    x = working_set(nbytes, device=DEV)
    for label, buf, cancels in (("working set", x, True),
                                ("ramp", ramp_input(x), False)):
        got = float(stragglers.load_sum_fn(buf, passes)())
        want_v = mb.plain_load_sum(buf, passes)
        err, tol, _ = max_err("load_sum", got, want_v, buf, passes, cancels)
        if not err <= tol:
            raise AssertionError(f"probe scalar on the {label}: {got} vs "
                                 f"{float(want_v)}, err {err} > {tol}")
        say(f"  probe scalar ({label}, {passes} passes): {got:.6g} against "
            f"the plain {float(want_v):.6g}, err {err:.3e} (tolerance "
            f"{tol:.3e})")
    say(f"  probe_devices({nbytes // MiB} MiB, {passes} passes, {reps} "
        f"reps): " + "; ".join(f"{p.device} {p.gbps:.1f} GB/s "
                               f"z={p.z_score:+.2f}" for p in probes)
        + f"; acc.cu launches {launched['load_sum']}")

    t0 = time.perf_counter()
    out = OUT_DIR / "characterize_machine"
    r = subprocess.run([sys.executable, str(ROOT / "examples_torch" /
                                            "characterize_machine.py"),
                        "--out-dir", str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    files = sorted(f.name for f in out.glob("*.json"))
    if r.returncode != 0 or len(files) != 3:
        raise AssertionError(f"characterize_machine.py exited "
                             f"{r.returncode}, wrote {files}:\n"
                             f"{r.stderr[-4000:]}")
    probe_line = [line for line in r.stdout.splitlines()
                  if line.strip().startswith("cuda:")]
    say(f"  examples_torch/characterize_machine.py: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s, wrote {files}; "
        + "; ".join(line.strip() for line in probe_line))
    say(f"  phase 3i: {time.perf_counter() - t_phase:.1f} s")
    return {"load_sum": launched["load_sum"]}


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
#: mamba2-2.7b's 64 layers amplify any bf16 rounding past SERVE_LOGITS_RMS_TOL:
#: a third route, the SSD by its plain version in float32 throughout
#: (``exact_ssd``), lies 0.2295 from the plain route and 0.2373 from the
#: kernel route after 64 layers, the kernel route 0.2321 from the plain one
#: (each layer within 1.0 %; the three residual streams part by ~0.004 a
#: layer; H100 80GB HBM3, 700 W).  A bound that an exact-arithmetic SSD
#: fails tells nothing of the kernel, so where the model's own sensitivity
#: (float32 SSD against plain route) exceeds SERVE_LOGITS_RMS_TOL, the
#: kernel route is held to lie no further from the float32 SSD route than
#: SENSITIVITY_RATIO times the plain route does, and its distance to the
#: plain route to SENSITIVITY_RATIO times that sensitivity.
SENSITIVITY_RATIO = 1.1


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
            xk, ek = mamba_prefill(cfg, p, x, kern)
            xp, ep = mamba_prefill(cfg, p, x, BASELINE)
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
    # one prefill: the flash kernel once per attention site, the SSD kernel
    # once per Mamba layer; decode runs neither
    counts = serve_cli(SERVE_ARGV + (["--reduced"] if quick else []),
                       {"flash_attn": model.n_sites,
                        "ssd_scan": cfg.n_layers},
                       {ssd_serve_route(cfg): cfg.n_layers})

    # in process, one parameter set and one prompt batch (serve's seeds):
    # the kernel route against the plain route
    params, tokens = serve_inputs(cfg, model, SERVE_P)
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
        # process's first), and decode from the kernel route's cache
        warm_times(model, params, tokens, ck, lk, SERVE_P)
    del params, ck, lk, lp
    torch.cuda.empty_cache()
    return counts


def decoder_layerwise_routes(model, params, tokens) -> float:
    """``DecoderLM``: both attention routes from the same input at every
    layer (GQA, or mla's expanded q/k of 192 and v of 128 dims at full
    width), following the plain route's activations (the layer's MLP or
    MoE on the plain route): the worst relative RMS difference of the
    attention outputs."""
    cfg = model.cfg
    S = tokens.shape[1]
    pos = torch.arange(S, device=DEV)
    inv_freq = (mla_mod.mla_rope_freqs(cfg, DEV) if model.is_mla else
                attention.rope_freqs(cfg.resolved_head_dim, cfg.rope_pct,
                                     cfg.rope_theta, device=DEV))
    worst = 0.0
    x = embed_tokens(params["embed"], tokens)
    for layer in range(cfg.n_layers):
        p = layer_params(params["blocks"], layer)
        h = apply_norm(cfg, p["ln1"], x)
        if model.is_mla:
            q, k, v, _, _ = mla_mod.mla_expand(cfg, p["attn"], h, pos,
                                               inv_freq)
        else:
            q, k, v = attention.gqa_project_qkv(cfg, p["attn"], h, pos,
                                                inv_freq)
        o = attention.chunked_attention(q, k, v, causal=True, kv_block=S)
        worst = max(worst, _rms_rel(fa_ops.flash(q, k, v, causal=True), o))
        x = x + attention.out_proj(o, p["attn"]["wo"]).to(x.dtype)
        x = x + model._ffn(p, apply_norm(cfg, p["ln2"], x), BASELINE)
    return worst


@contextlib.contextmanager
def exact_ssd():
    """The kernel route's SSD computed by the kernel's plain version instead
    (``plain_ssd``: the token recurrence, float32 throughout; the same
    inputs, laid out as the kernel route lays them out)."""
    saved = ssm_mod.ssd_ops

    def ssd(xdt, dA, Bm, Cm, chunk):
        BH, S, _ = xdt.shape
        return sk.plain_ssd(xdt, dA, Bm.reshape(BH, S, -1),
                            Cm.reshape(BH, S, -1))
    ssm_mod.ssd_ops = types.SimpleNamespace(ssd=ssd)
    try:
        yield
    finally:
        ssm_mod.ssd_ops = saved


def ssm_layerwise_routes(model, params, tokens) -> tuple[dict, dict]:
    """``SSMLM``: both routes of every Mamba layer from the same input,
    following the plain route's activations: the worst relative RMS
    difference of the layers' updates and of their final states.  Beside
    it, three whole trajectories (kernel route, plain route, and the SSD
    by its plain version, float32 throughout: ``exact_ssd``) are carried
    through the layers, and their residual streams' relative RMS
    differences printed at a few depths, then their logits'.  Returns
    (the worst per-layer differences, the logits' distances)."""
    cfg = model.cfg
    kern = replace(BASELINE, use_pallas=True)
    worst = {"mamba update": 0.0, "mamba state": 0.0}
    x = embed_tokens(params["embed"], tokens)
    xk_run, xe_run = x, x
    depths = {1, 8, 16, 32, 48, cfg.n_layers}
    for layer in range(cfg.n_layers):
        p = layer_params(params["blocks"], layer)
        xk, ek = mamba_prefill(cfg, p, x, kern)
        xp, ep = mamba_prefill(cfg, p, x, BASELINE)
        worst["mamba update"] = max(worst["mamba update"],
                                    _rms_rel(xk - x, xp - x))
        worst["mamba state"] = max(worst["mamba state"],
                                   _rms_rel(ek["state"], ep["state"]))
        x = xp
        xk_run = mamba_prefill(cfg, p, xk_run, kern)[0]
        with exact_ssd():
            xe_run = mamba_prefill(cfg, p, xe_run, kern)[0]
        if layer + 1 in depths:
            say(f"  {cfg.name} after {layer + 1} layers, residual stream "
                f"relative RMS: kernel vs plain route "
                f"{_rms_rel(xk_run, x):.4e}, kernel route vs float32 SSD "
                f"{_rms_rel(xk_run, xe_run):.4e}, plain route vs float32 "
                f"SSD {_rms_rel(x, xe_run):.4e}")
    V = cfg.vocab_size
    logits = {name: lm_logits(cfg, params["embed"], apply_norm(
        cfg, params["ln_f"], h[:, -1:]))[:, 0, :V]
        for name, h in (("kernel", xk_run), ("plain", x), ("exact", xe_run))}
    dist = {"kernel-plain": _rms_rel(logits["kernel"], logits["plain"]),
            "kernel-exact": _rms_rel(logits["kernel"], logits["exact"]),
            "plain-exact": _rms_rel(logits["plain"], logits["exact"])}
    say(f"  {cfg.name} logits relative RMS: kernel vs plain route "
        f"{dist['kernel-plain']:.4e}, kernel route vs float32 SSD "
        f"{dist['kernel-exact']:.4e}, plain route vs float32 SSD "
        f"{dist['plain-exact']:.4e}")
    return worst, dist


def encdec_layerwise_routes(model, params, batch) -> dict[str, float]:
    """``EncDecLM``: both routes of every attention of the prefill (each
    encoder layer's, each decoder layer's self- and cross-attention) from
    the same input, following the plain route's activations: the plain
    prefill runs with ``encdec.attend`` wrapped so that the kernel route
    runs beside it on the same q, k, v.  Returns the worst relative RMS
    difference by kind."""
    worst = {"encoder": 0.0, "self": 0.0, "cross": 0.0}
    plain_attend = encdec_mod.attend
    kern = replace(BASELINE, use_pallas=True)

    def both(q, k, v, *, causal, variant):
        o = plain_attend(q, k, v, causal=causal, variant=variant)
        kind = "self" if causal else \
            "encoder" if q.shape[1] == k.shape[1] else "cross"
        worst[kind] = max(worst[kind], _rms_rel(
            plain_attend(q, k, v, causal=causal, variant=kern), o))
        return o
    encdec_mod.attend = both
    try:
        model.prefill(params, batch, None, BASELINE)
    finally:
        encdec_mod.attend = plain_attend
    return worst


def _prefill_routes(model, params, tokens, label: str,
                    tol: float = SERVE_LOGITS_RMS_TOL) -> tuple:
    """The prefill's logits on the kernel route against the plain route's
    (relative RMS within ``tol``, finite); returns the kernel route's cache
    and logits."""
    V = model.cfg.vocab_size
    lk, ck = model.prefill(params, tokens, None,
                           replace(BASELINE, use_pallas=True))
    lp, _ = model.prefill(params, tokens, None, BASELINE)
    sync()
    lk, lp = lk[:, :V], lp[:, :V]
    rms = _rms_rel(lk, lp)
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    say(f"  {label}: prefill logits, kernel route vs plain route "
        f"({model.cfg.n_layers} layers): relative RMS {rms:.4e} (tolerance "
        f"{tol:.4g}), max abs {float((lk - lp).abs().max()):.3e}"
        f" of largest {float(lp.abs().max()):.3e}; first greedy token equal "
        f"in {agree} of {lk.shape[0]} rows")
    if not rms <= tol or not bool(lk.isfinite().all()):
        raise AssertionError(f"{label}: prefill routes disagree: relative "
                             f"RMS {rms} > {tol}")
    return ck, lk


#: flash_attn's launches with a query offset on the main paths: each
#: serving path sets the wrapper's counts to 0 just before it runs and adds
#: its ``offset_launch_counts`` here just after (training launches no
#: kernel; no one-card path splits a sequence over ``model``)
MAIN_OFFSET_LAUNCHES = {"flash_attn": 0}


def note_offset_launches() -> None:
    MAIN_OFFSET_LAUNCHES["flash_attn"] += fa.offset_launch_counts["flash_attn"]


#: ssd_scan's launches by route on each serving path ``serve_cli`` drove,
#: by arch (the wrapper's ``route_launch_counts``, read just after it)
SSD_ROUTE_LAUNCHES: dict[str, dict[int, int]] = {}


def ssd_serve_route(cfg) -> int:
    """The route ``launch_plan`` gives a ``serve`` prefill's SSD (SERVE_B
    prompts of SERVE_P tokens, bf16) of an ssm or hybrid config."""
    s = cfg.ssm
    heads = s.expand * cfg.d_model // s.head_dim
    return sk.launch_plan(SERVE_B * heads, s.head_dim, s.d_state,
                          min(s.chunk_size, SERVE_P), torch.bfloat16)["route"]


def serve_cli(argv: list[str], want: dict[str, int],
              ssd_routes: dict[int, int] | None = None) -> dict[str, int]:
    """``python -m repro_torch.launch.serve`` in process, the launch
    counters set to 0 just before and read just after; raises unless it
    exits 0 with its four lines, launched exactly ``want`` and no membench
    kernel, and (``ssd_routes``) the SSD exactly so many times on each
    route.  Returns the launches."""
    for mod in (mb, fa, sk):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    sync()
    lines = buf.getvalue().strip().splitlines()
    counts = {**fa.launch_counts, **sk.launch_counts}
    routes = {r: n for r, n in sk.route_launch_counts.items() if n}
    SSD_ROUTE_LAUNCHES[argv[argv.index("--arch") + 1]] = routes
    note_offset_launches()
    say(f"  serve: exit {rc}, {time.perf_counter() - t0:.1f} s")
    for line in lines:
        say("  | " + line)
    say(f"  launches on the serving path: {counts}; ssd_scan by route "
        f"{routes}; membench {sum(mb.launch_counts.values())}")
    if rc != 0 or len(lines) != 4:
        raise AssertionError(f"serve exited {rc} with {len(lines)} lines")
    if counts != want or any(mb.launch_counts.values()):
        raise AssertionError(f"serve launched {counts} and membench "
                             f"{mb.launch_counts}, expected {want} and none")
    if ssd_routes is not None and routes != ssd_routes:
        raise AssertionError(f"serve launched ssd_scan {routes} by route, "
                             f"expected {ssd_routes}")
    return counts


def serve_run(cfg, prompt_len: int, want: dict[str, int]) -> dict[str, int]:
    """``serve.run`` on SERVE_B prompts, 4 tokens generated, the launch
    counters set to 0 just before and read just after; raises unless it
    launched exactly ``want``, no membench kernel, and gave 4 tokens of the
    vocabulary a row.  Returns the launches."""
    for mod in (mb, fa, sk):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        r = serve.run(cfg, batch=SERVE_B, prompt_len=prompt_len, gen=4,
                      seed=0, device=DEV)
    sync()
    counts = {**fa.launch_counts, **sk.launch_counts}
    note_offset_launches()
    if counts != want or any(mb.launch_counts.values()) \
            or [len(t) for t in r["tokens"]] != [4] * SERVE_B \
            or not all(0 <= t < cfg.vocab_size for row in r["tokens"]
                       for t in row):
        raise AssertionError(f"{cfg.name}: serve.run launched {counts}, "
                             f"membench {mb.launch_counts}, tokens "
                             f"{r['tokens']}")
    say(f"  {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layers): "
        f"serve.run exit ok in {time.perf_counter() - t0:.1f} s, launches "
        f"{counts}, prefill {r['prefill_s'] * 1e3:.1f} ms (cold), decode "
        f"{r['decode_s'] / r['decode_steps'] * 1e3:.1f} ms a step")
    return counts


def serve_inputs(cfg, model, prompt_len: int) -> tuple:
    """serve's weights (seed 0) and prompt (seed 1: the tokens, or encdec's
    whole batch with its frames)."""
    params = init_params(model.param_specs(),
                         torch.Generator(device=DEV).manual_seed(0))
    batch = make_batch(cfg, (SERVE_B, prompt_len),
                       torch.Generator(device=DEV).manual_seed(1))
    return params, batch if cfg.family == "encdec" else batch["tokens"]


def warm_times(model, params, prompt, cache, logits, prompt_len: int
               ) -> float | None:
    """Warm prefill on both routes (wall and device-busy time), then three
    decode steps from the kernel route's cache (its logits' greedy tokens;
    each step's logits finite): wall time of the second, busy time of the
    third.  Returns the kernel route's prefill busy ms."""
    cfg = model.cfg
    V = cfg.vocab_size
    prefill_busy = {}
    for name, variant in (("kernel route", replace(BASELINE,
                                                   use_pallas=True)),
                          ("plain route", BASELINE)):
        run = lambda v=variant: model.prefill(params, prompt, None, v)  # noqa: E731
        wall, _ = wall_ms(run)
        busy, _ = device_busy_ms(run)
        prefill_busy[name] = busy
        say(f"  warm prefill, {name}: {wall:.1f} ms wall, device busy "
            f"{'not measured' if busy is None else f'{busy:.1f} ms'}")
    cache = serve.pad_cache(cfg, cache, SERVE_B, prompt_len, 3)
    tok = logits.argmax(-1)[:, None]
    for i in range(3):
        step = lambda: model.decode_step(params, cache, tok, prompt_len + i)  # noqa: E731
        if i < 2:
            wall, (out, _) = wall_ms(step)
        else:
            busy, (out, _) = device_busy_ms(step)
        if not bool(out.isfinite().all()):
            raise AssertionError(f"decode step {i}: non-finite logits")
        tok = out[:, :, :V].argmax(-1)
    say(f"  decode steps from the kernel route's cache: finite logits; one "
        f"step {wall:.1f} ms wall, device busy "
        f"{'not measured' if busy is None else f'{busy:.1f} ms'}")
    return prefill_busy["kernel route"]


def phase_dense_serve_path(quick: bool) -> dict[str, int]:
    """3d, the dense / vlm families: ``serve`` on granite-3-2b at full width
    (one flash launch a layer in its prefill, no SSD, no membench), then in
    process the routes layer by layer and whole, warm prefill and decode
    times; then the other four configs at full width, DENSE_DEPTH layers,
    through ``serve.run``.  Returns flash launches by config."""
    say("== phase 3d (dense / vlm): python -m repro_torch.launch.serve "
        + " ".join(DENSE_ARGV) + (" --reduced" if quick else ""))
    t_phase = time.perf_counter()
    launches: dict[str, int] = {}
    cfg = get_arch(DENSE_SERVE)
    if quick:
        cfg = reduced(cfg)
    model = build(cfg)
    launches[DENSE_SERVE] = serve_cli(
        DENSE_ARGV + (["--reduced"] if quick else []),
        {"flash_attn": cfg.n_layers, "ssd_scan": 0})["flash_attn"]
    params, tokens = serve_inputs(cfg, model, SERVE_P)
    with torch.inference_mode():
        worst = decoder_layerwise_routes(model, params, tokens)
        say(f"  every layer's attention fed the same input, kernel route vs "
            f"plain route, worst relative RMS {worst:.4e} (tolerance "
            f"{LAYER_TOL})")
        if not worst <= LAYER_TOL:
            raise AssertionError(f"a layer's attention routes disagree: "
                                 f"{worst}")
        ck, lk = _prefill_routes(model, params, tokens, DENSE_SERVE)
        BUSY_MS["prefill"] = warm_times(model, params, tokens, ck, lk,
                                        SERVE_P)
    del params, ck, lk
    torch.cuda.empty_cache()

    for arch in DENSE_CUT:
        cfg = replace(get_arch(arch), n_layers=DENSE_DEPTH)
        if quick:
            cfg = reduced(cfg)
        launches[arch] = serve_run(cfg, SERVE_P, {"flash_attn": cfg.n_layers,
                                                  "ssd_scan": 0})["flash_attn"]
        model = build(cfg)
        params, tokens = serve_inputs(cfg, model, SERVE_P)
        with torch.inference_mode():
            worst = decoder_layerwise_routes(model, params, tokens)
            if not worst <= LAYER_TOL:
                raise AssertionError(f"{arch}: a layer's attention routes "
                                     f"disagree: {worst}")
            _prefill_routes(model, params, tokens,
                            f"{arch} (flash {dense_flash_shape(arch)}; "
                            f"layers' attention within {worst:.4e})")
        del params, model
        torch.cuda.empty_cache()
    say(f"  phase 3d (dense / vlm): {time.perf_counter() - t_phase:.1f} s; "
        f"flash launches {launches}")
    return launches


def phase_family_serve_path(quick: bool) -> dict[str, dict[str, int]]:
    """3d, the ssm, encdec and moe families: ``serve`` on mamba2-2.7b (one
    SSD launch a layer, no flash) and whisper-medium (one flash launch for
    every encoder layer, and two for every decoder layer: self- and
    cross-attention; no SSD) at full width and depth, then deepseek-v2-236b
    (full width, DENSE_DEPTH layers: one flash launch a layer at (D, Dv) =
    (192, 128)) and arctic-480b (reduced) through ``serve.run``; each in
    process with its routes held layer by layer and whole, and its warm
    prefill and decode times.  Returns the launches by config."""
    say("== phase 3d (ssm / encdec / moe): python -m repro_torch.launch.serve "
        + " ".join(SSM_ARGV) + ", then " + " ".join(ENCDEC_ARGV)
        + (" (--reduced)" if quick else "") + f"; serve.run on {MLA_SERVE} "
        f"({DENSE_DEPTH} layers) and {MOE_REDUCED} (reduced)")
    t_phase = time.perf_counter()
    launches: dict[str, dict[str, int]] = {}
    for arch, argv, P in ((SSM_SERVE, SSM_ARGV, SERVE_P),
                          (ENCDEC_SERVE, ENCDEC_ARGV, ENCDEC_P)):
        cfg = get_arch(arch)
        if quick:
            cfg = reduced(cfg)
        model = build(cfg)
        want = ({"flash_attn": 0, "ssd_scan": cfg.n_layers}
                if cfg.family == "ssm" else
                {"flash_attn": cfg.n_encoder_layers + 2 * cfg.n_layers,
                 "ssd_scan": 0})
        launches[arch] = serve_cli(
            argv + (["--reduced"] if quick else []), want,
            {ssd_serve_route(cfg): cfg.n_layers} if cfg.family == "ssm"
            else {})
        params, prompt = serve_inputs(cfg, model, P)
        tol = SERVE_LOGITS_RMS_TOL
        with torch.inference_mode():
            if cfg.family == "ssm":
                layers, dist = ssm_layerwise_routes(model, params, prompt)
                sens = dist["plain-exact"]
                if sens > SERVE_LOGITS_RMS_TOL:
                    tol = SENSITIVITY_RATIO * sens
                    say(f"  {arch}: the model's own sensitivity (float32 SSD "
                        f"vs plain route) {sens:.4e} exceeds "
                        f"{SERVE_LOGITS_RMS_TOL}: kernel route vs float32 "
                        f"SSD {dist['kernel-exact']:.4e} held to "
                        f"{SENSITIVITY_RATIO} x {sens:.4e}, vs plain route "
                        f"to {tol:.4e}")
                    if not dist["kernel-exact"] <= tol:
                        raise AssertionError(
                            f"{arch}: the kernel route lies "
                            f"{dist['kernel-exact']} from the float32 SSD "
                            f"route, more than {SENSITIVITY_RATIO} x the "
                            f"plain route's {sens}")
            else:
                layers = encdec_layerwise_routes(model, params, prompt)
            say(f"  {arch}: every layer fed the same input, kernel route vs "
                f"plain route, worst relative RMS {layers} (tolerance "
                f"{LAYER_TOL})")
            if not all(e <= LAYER_TOL for e in layers.values()):
                raise AssertionError(f"{arch}: a layer's routes disagree: "
                                     f"{layers}")
            ck, lk = _prefill_routes(model, params, prompt, arch, tol)
            warm_times(model, params, prompt, ck, lk, P)
        del params, prompt, ck, lk, model
        torch.cuda.empty_cache()

    for arch in (MLA_SERVE, MOE_REDUCED):
        cfg = get_arch(arch)
        cfg = (reduced(cfg) if quick or arch == MOE_REDUCED
               else replace(cfg, n_layers=DENSE_DEPTH))
        launches[arch] = serve_run(cfg, SERVE_P, {"flash_attn": cfg.n_layers,
                                                  "ssd_scan": 0})
        model = build(cfg)
        params, tokens = serve_inputs(cfg, model, SERVE_P)
        with torch.inference_mode():
            worst = decoder_layerwise_routes(model, params, tokens)
            say(f"  {arch}: every layer's attention fed the same input, "
                f"kernel route vs plain route, worst relative RMS "
                f"{worst:.4e} (tolerance {LAYER_TOL})")
            if not worst <= LAYER_TOL:
                raise AssertionError(f"{arch}: a layer's attention routes "
                                     f"disagree: {worst}")
            ck, lk = _prefill_routes(model, params, tokens, arch)
            warm_times(model, params, tokens, ck, lk, SERVE_P)
        del params, tokens, ck, lk, model
        torch.cuda.empty_cache()
    say(f"  phase 3d (ssm / encdec / moe): "
        f"{time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 3k — serving on a mesh, its one-card half
# ---------------------------------------------------------------------------

#: the sequence-sharded decode on one card: zamba2-2.7b at full width,
#: batch 1, a KV cache of S_3K tokens a site (9 x 131,072 x 10,240 B =
#: 12.08 GB: a GPU's share of long_500k over 4), a prompt of MESH_P tokens
#: prefilled through the kernels, the rest up to the first decode position
#: drawn from a seed; MESH_G greedy tokens
S_3K, MESH_P, MESH_G = 131072, 512, 16
#: the moe layer through a one-device ctx at deepseek-v2-236b's layer
#: shapes: a prefill's tokens and a decode step's
MOE_3K_SHAPES = ((SERVE_B, SERVE_P), (SERVE_B, 1))


def phase_mesh_serve_path(quick: bool) -> dict[str, int]:
    """3k: the mesh's serving path on one card, through ``make_smoke_ctx()``
    (every axis one position: no collective).  zamba2-2.7b: a 1 x MESH_P
    prefill (``make_prefill_step``, the kernels: one flash launch a site,
    one SSD launch a Mamba layer) fills the first rows of an S_3K-token
    cache and its SSM state, a seed the rest up to the first decode
    position; MESH_G greedy tokens through ``make_decode_step(...,
    seq_shard_decode=True)``, then the plain decode fed the same tokens on
    a copy of the same cache (logits within SERVE_LOGITS_RMS_TOL, ms a
    token both ways); at each of those positions one step both ways from
    the same state (``mesh_check.hold_decode_at``: every site's attention
    within 2e-2 on the same input, the logits, the cache update bit for
    bit).  Then ``moe_layer`` through the one-device ctx against
    ``moe_layer(None, ...)`` at deepseek-v2-236b's layer shapes, bit for
    bit.  Returns the prefill's launches."""
    import mesh_check
    from repro_torch.distributed.sharding import make_smoke_ctx
    from repro_torch.serve import flash_decode as fd
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import shard_params
    from repro_torch.train.step import make_decode_step, make_prefill_step
    cfg = get_arch("zamba2-2.7b")
    S, P = (1024, 32) if quick else (S_3K, MESH_P)
    if quick:
        cfg = reduced(cfg)
    say(f"== phase 3k: serving on a mesh, one card (make_smoke_ctx): "
        f"{cfg.name}{' reduced' if quick else ' at full width'}, batch 1, "
        f"a {S}-token KV cache a site, a 1 x {P} prefill, {MESH_G} greedy "
        f"tokens sequence-sharded; moe_layer at {MLA_SERVE}'s layer shapes")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ctx = make_smoke_ctx()
    model = build(cfg)
    params = init_params(model.param_specs(),
                         torch.Generator(device=DEV).manual_seed(0))
    # the layout the mesh holds (every leaf by its own axes): on one
    # position the whole leaves themselves
    params = shard_params(cfg, params, ctx)
    tokens = make_batch(cfg, (1, P), torch.Generator(
        device=DEV).manual_seed(1))["tokens"]
    variant = replace(BASELINE, use_pallas=True)
    for mod in (mb, fa, sk):
        mod.reset_launch_counts()
    with torch.inference_mode():
        logits, pre = make_prefill_step(cfg, ctx, variant)(
            params, {"tokens": tokens})
        sync()
    launches = {**fa.launch_counts, **sk.launch_counts,
                "membench": sum(mb.launch_counts.values())}
    note_offset_launches()
    want = {"flash_attn": model.n_sites, "ssd_scan": cfg.n_layers,
            "membench": 0}
    say(f"  prefill 1 x {P}: launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"3k prefill launches {launches}, expected "
                             f"{want}")
    pos0 = S - 2 * MESH_G
    shape = (model.n_sites, 1, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    gen = torch.Generator(device=DEV).manual_seed(3)
    whole = {}
    for k in ("k", "v"):
        t = torch.zeros(shape, dtype=torch.bfloat16, device=DEV)
        t[:, :, :P] = pre[k]
        t[:, :, P:pos0] = torch.randn((model.n_sites, 1, pos0 - P) + shape[3:],
                                      generator=gen, device=DEV,
                                      dtype=torch.bfloat16).mul_(0.3)
        whole[k] = t
    ssm = pre["ssm"]
    kv_gb = sum(t.numel() * t.element_size() for t in whole.values()) / 1e9
    first = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]

    def decode(seq_shard: bool, teacher=None) -> tuple:
        """MESH_G tokens from pos0 on a copy of the cache: (logits, tokens,
        ms a token); sequence-sharded, also one further step and one site's
        attention alone by device-busy time beside their wall time."""
        step = make_decode_step(cfg, ctx, BASELINE, seq_shard_decode=seq_shard)
        cache = {"ssm": {k: v.clone() for k, v in ssm.items()},
                 "k": whole["k"].clone(), "v": whole["v"].clone()}
        tok, out, toks, ms = first, [], [], []
        with torch.inference_mode():
            for i in range(MESH_G):
                if teacher is not None:
                    tok = teacher[i]
                t, (lg, cache) = wall_ms(lambda: step(params, cache,
                                                      {"tokens": tok},
                                                      pos0 + i))
                ms.append(t)
                out.append(lg)
                toks.append(tok)
                tok = torch.argmax(lg[:, :, :cfg.vocab_size], -1)
            if seq_shard:
                pos = pos0 + MESH_G
                wall, _ = wall_ms(lambda: step(params, cache,
                                               {"tokens": tok}, pos + 1))
                busy, _ = device_busy_ms(lambda: step(
                    params, cache, {"tokens": tok}, pos + 2))
                x = torch.randn((1, 1, cfg.d_model), device=DEV,
                                generator=torch.Generator(
                                    device=DEV).manual_seed(4))
                site = lambda: fd.seq_sharded_gqa_decode(  # noqa: E731
                    ctx, cfg, params["shared"]["attn"], x, cache["k"][0],
                    cache["v"][0], pos + 2)
                site_wall, _ = wall_ms(site)
                site_busy, _ = device_busy_ms(site)
                say(f"  a sequence-sharded step: {wall:.2f} ms wall, device "
                    f"busy {busy} ms; one site's attention alone "
                    f"{site_wall:.2f} ms wall, busy {site_busy} ms "
                    f"(x {model.n_sites} sites)")
        del cache
        torch.cuda.empty_cache()
        return out, toks, ms

    lg_sh, toks, ms_sh = decode(True)
    lg_pl, _, ms_pl = decode(False, teacher=toks)
    rms = [_rms_rel(a, b) for a, b in zip(lg_sh, lg_pl)]
    finite = all(bool(torch.isfinite(x).all()) for x in lg_sh)
    med = lambda v: sorted(v[1:])[len(v[1:]) // 2]  # noqa: E731
    say(f"  {MESH_G} greedy tokens at pos {pos0}..{pos0 + MESH_G - 1}, "
        f"{kv_gb:.2f} GB of KV: sequence-sharded {med(ms_sh):.2f} ms a token "
        f"(median of tokens 2-{MESH_G}; first {ms_sh[0]:.2f}), plain "
        f"{med(ms_pl):.2f} ms (first {ms_pl[0]:.2f}); logits relative RMS "
        f"<= {max(rms):.4e} (limit {SERVE_LOGITS_RMS_TOL}), finite {finite}")
    if not (finite and max(rms) <= SERVE_LOGITS_RMS_TOL):
        raise AssertionError(f"3k: sequence-sharded logits {rms}")
    holds = []
    with torch.inference_mode():
        for i, tok in enumerate(toks):
            holds.append(mesh_check.hold_decode_at(ctx, cfg, params, whole,
                                                   ssm, tok, pos0 + i))
    bad = [h for h in holds if not (
        h["attn_max_abs"] < mesh_check.ATTN_TOL and h["cache_equal"]
        and h["logits_rms"] <= SERVE_LOGITS_RMS_TOL and h["finite"]
        and h["sites"] == model.n_sites and h["changed_rows"] == [h["pos"]])]
    say(f"  one step both ways from the same state at each of the {MESH_G} "
        f"positions: every site's attention within "
        f"{max(h['attn_max_abs'] for h in holds):.4e} (limit "
        f"{mesh_check.ATTN_TOL}), logits <= "
        f"{max(h['logits_rms'] for h in holds):.4e}, the cache update bit "
        f"for bit, one row written a step")
    if bad:
        raise AssertionError(f"3k holds: {bad}")
    del whole, ssm, pre, params, lg_sh, lg_pl
    torch.cuda.empty_cache()

    # moe_layer through the one-device ctx: E_local = E, no collective
    mcfg = reduced(get_arch(MLA_SERVE)) if quick else get_arch(MLA_SERVE)
    p = init_params(moe_mod.moe_specs(mcfg),
                    torch.Generator(device=DEV).manual_seed(5))
    held = ctx.tree_shard(p, {k: s.axes for k, s in
                              moe_mod.moe_specs(mcfg).items()})
    same = []
    with torch.inference_mode():
        for b, s in MOE_3K_SHAPES:
            x = torch.randn((b, s, mcfg.d_model), generator=torch.Generator(
                device=DEV).manual_seed(b + s), device=DEV,
                dtype=torch.bfloat16)
            y0, a0 = moe_mod.moe_layer(None, mcfg, p, x)
            y1, a1 = moe_mod.moe_layer(ctx, mcfg, held, x)
            same.append(bool(torch.equal(y0, y1) and torch.equal(a0, a1)))
    held_same = all(held[k] is p[k] for k in p)
    say(f"  moe_layer at {mcfg.name}'s layer shapes {list(MOE_3K_SHAPES)} "
        f"x {mcfg.d_model}: one-device ctx = no ctx bit for bit {same}; "
        f"the held tree is the whole tree {held_same}")
    if not (all(same) and held_same):
        raise AssertionError("3k: moe_layer through the one-device ctx "
                             "differs")
    del p, held
    torch.cuda.empty_cache()
    say(f"  phase 3k: {time.perf_counter() - t_phase:.1f} s")
    return {k: v for k, v in launches.items() if k != "membench"}


# ---------------------------------------------------------------------------
# phase 3j — training
# ---------------------------------------------------------------------------

#: the model trained at full width, its batch and its run: 8 steps through
#: the Trainer, a checkpoint interval above the step count (a full-width
#: checkpoint would write ~40 GB)
TRAIN_ARCH = "granite-3-2b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 8
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
#: training's last-position logits against the serving prefill's on the
#: same weights and tokens: the plain route runs the same chunked attention
#: and products, so only the order of a few reductions may differ; the
#: kernel route is held to the logits bound of 3d
TRAIN_SERVE_PLAIN_TOL = 1e-2
#: the card against the CPU, the same port code at full width on 2 layers
#: (one batch of 128 tokens: 3.3 s on the CPU): the loss, and every
#: gradient leaf on the relative RMS, within the bound the CPU tests hold
#: the CPU to the reference with (cuBLAS and the CPU's bf16 products round
#: their float32 sums at other places)
TRAIN_CPU_DEPTH, TRAIN_CPU_B, TRAIN_CPU_S = 2, 1, 128
TRAIN_GRAD_TOL = 2e-2
#: every arch reduced takes one step at this shape
TRAIN_SMALL = (2, 64)


def _train_counts() -> dict[str, int]:
    return {**fa.launch_counts, **sk.launch_counts,
            "membench": sum(mb.launch_counts.values())}


def _finite_metrics(label: str, hist: list) -> None:
    bad = [(h["step"], k, v) for h in hist for k, v in h.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: non-finite metrics {bad}")


def _param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def train_full_width(quick: bool) -> tuple:
    """The Trainer on TRAIN_ARCH at full width: TRAIN_STEPS steps, every
    loss printed and finite, the last below the first; a further step and
    one AdamW update alone by device-busy time; peak memory.  Returns
    (the model, the trained params)."""
    cfg = get_arch(TRAIN_ARCH)
    if quick:
        cfg = reduced(cfg)
    tcfg = TrainConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1,
                       ckpt_dir=str(OUT_DIR / "train_full"), log_every=1,
                       opt=adamw.AdamWConfig(**TRAIN_OPT))
    trainer = Trainer(cfg, (TRAIN_B, TRAIN_S), None, tcfg, device=DEV)
    torch.cuda.init()                    # the allocator's stats need it
    torch.cuda.reset_peak_memory_stats(DEV)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        params, opt_state, hist = trainer.train(resume=False)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV)
    for line in buf.getvalue().strip().splitlines():
        say("  | " + line)
    n = _param_count(params)
    _finite_metrics(TRAIN_ARCH, hist)
    if len(hist) != TRAIN_STEPS or not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"{TRAIN_ARCH}: {len(hist)} steps logged, loss "
                             f"{hist[0]['loss']} -> {hist[-1]['loss']}: not "
                             f"lower")
    tokens = TRAIN_B * TRAIN_S
    warm = [h["dt"] for h in hist[1:]]
    step_s = sorted(warm)[len(warm) // 2]
    say(f"  {TRAIN_ARCH}{' (reduced)' if quick else ''}: {n} float32 "
        f"parameters, {cfg.n_layers} layers, batch {TRAIN_B} x {TRAIN_S}, "
        f"{TRAIN_STEPS} steps in {run_s:.1f} s; loss {hist[0]['loss']:.4f} "
        f"-> {hist[-1]['loss']:.4f}; step wall ms "
        f"{[round(h['dt'] * 1e3, 1) for h in hist]} (the first with the "
        f"process's first backward); peak memory allocated "
        f"{peak / 2**30:.2f} GiB")
    say(f"  median warm step {step_s * 1e3:.1f} ms wall: "
        f"{tokens / step_s:.0f} tokens/s, model "
        f"{6 * n * tokens / step_s / 1e12:.1f} TFLOP/s (6 N tokens a step, "
        f"N = {n})")
    # one more step, and the optimiser alone, by device-busy time
    batch = trainer.pipeline.batch(TRAIN_STEPS)
    wall, _ = wall_ms(lambda: trainer.step_fn(params, opt_state, batch))
    busy, (_, _, m) = device_busy_ms(
        lambda: trainer.step_fn(params, opt_state, batch))
    BUSY_MS["train"] = busy
    opt_busy, _ = device_busy_ms(lambda: adamw.apply(
        tcfg.opt, params, opt_state, opt_state["mu"]))
    say(f"  a further step: {wall:.1f} ms wall, device busy "
        f"{'not measured' if busy is None else f'{busy:.1f} ms'}; one AdamW "
        f"update alone (every leaf, float32 moments) device busy "
        f"{'not measured' if opt_busy is None else f'{opt_busy:.1f} ms'}; "
        f"loss {float(m['loss']):.4f}")
    del opt_state, trainer, batch
    torch.cuda.empty_cache()
    return build(cfg), params


def train_against_serving(model, params) -> dict[str, int]:
    """The same weights and tokens through training's ``hidden_states``
    and the serving prefill: the last position's logits, plain route
    within TRAIN_SERVE_PLAIN_TOL, kernel route within the 3d bound.
    Returns the kernel route's flash launches (a comparison, not
    training)."""
    cfg = model.cfg
    V = cfg.vocab_size
    tokens = make_pipeline(cfg, (TRAIN_B, TRAIN_S), seed=0,
                           device=DEV).batch(0)["tokens"]
    fa.reset_launch_counts()
    with torch.no_grad():
        h, _ = model.hidden_states(params, tokens, None, BASELINE)
        lt = lm_logits(cfg, params["embed"], h[:, -1:])[:, 0, :V]
        lp = model.prefill(params, tokens, None, BASELINE)[0][:, :V]
        lk = model.prefill(params, tokens, None,
                           replace(BASELINE, use_pallas=True))[0][:, :V]
    sync()
    plain, kern = _rms_rel(lt, lp), _rms_rel(lk, lt)
    say(f"  training's last-position logits (hidden_states + lm_logits) vs "
        f"the serving prefill on the same trained weights and tokens: plain "
        f"route relative RMS {plain:.4e} (tolerance "
        f"{TRAIN_SERVE_PLAIN_TOL}), kernel route {kern:.4e} (tolerance "
        f"{SERVE_LOGITS_RMS_TOL}); kernel-route flash launches "
        f"{fa.launch_counts['flash_attn']} (this comparison's, not "
        f"training's)")
    if not (plain <= TRAIN_SERVE_PLAIN_TOL and kern <= SERVE_LOGITS_RMS_TOL
            and bool(lt.isfinite().all())):
        raise AssertionError(f"training and serving disagree: plain {plain}, "
                             f"kernel {kern}")
    return dict(fa.launch_counts)


def train_card_against_cpu(quick: bool) -> None:
    """TRAIN_ARCH at full width on TRAIN_CPU_DEPTH layers, the same params
    and batch on the card and on the CPU: the loss and every gradient leaf
    within TRAIN_GRAD_TOL relative."""
    cfg = replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_CPU_DEPTH)
    if quick:
        cfg = reduced(cfg)
    model = build(cfg)
    cpu_params = init_params(model.param_specs(),
                             torch.Generator().manual_seed(0))
    batch = make_pipeline(cfg, (TRAIN_CPU_B, TRAIN_CPU_S), seed=0,
                          device="cpu").batch(0)
    out = {}
    for where, params in (("cpu", cpu_params), ("cuda", {})):
        if where == "cuda":
            params = spec_map(lambda t: t.detach().to(DEV), cpu_params)
        b = {k: v.to(params["embed"]["embedding"].device)
             for k, v in batch.items()}
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        t0 = time.perf_counter()
        loss, _ = model.loss(params, b, None, BASELINE)
        grads = torch.autograd.grad(loss, leaves)
        out[where] = (float(loss.detach()), [g.float().cpu() for g in grads],
                      time.perf_counter() - t0)
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out["cuda"]
    errs = [_rms_rel(a, b) for a, b in zip(gg, gc)]
    names = [n for n, _ in tree_leaves_with_paths(cpu_params)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    say(f"  {TRAIN_ARCH} at full width on {cfg.n_layers} layers, batch "
        f"{TRAIN_CPU_B} x {TRAIN_CPU_S}, the card vs the CPU (same port "
        f"code, params, batch): loss {lg:.6f} vs {lc:.6f}; worst gradient "
        f"leaf {names[worst]} relative RMS {errs[worst]:.4e} (tolerance "
        f"{TRAIN_GRAD_TOL}); loss + gradients {sg * 1e3:.0f} ms on the card "
        f"(first call), {sc:.1f} s on the CPU")
    if abs(lg - lc) > 2e-3 * abs(lc) or errs[worst] > TRAIN_GRAD_TOL:
        raise AssertionError(f"card and CPU disagree: loss {lg} vs {lc}, "
                             f"{names[worst]} {errs[worst]}")


def train_every_arch_and_resume() -> None:
    """One Trainer step for each of the ten archs reduced (finite
    metrics); then reduced granite 4 steps with checkpoints at 2 and 4
    into the output directory, the newest restored bit for bit, and a
    second Trainer resuming from it at step 4."""
    for arch in sorted(list_archs()):
        cfg = reduced(get_arch(arch))
        tr = Trainer(cfg, TRAIN_SMALL, None, TrainConfig(
            steps=1, ckpt_every=2, ckpt_dir=str(OUT_DIR / "train_small"),
            opt=adamw.AdamWConfig(**TRAIN_OPT)), device=DEV)
        with contextlib.redirect_stdout(io.StringIO()):
            _, _, hist = tr.train(resume=False)
        _finite_metrics(arch, hist)
        say(f"  {arch} (reduced): one step, loss {hist[0]['loss']:.4f}, "
            f"gnorm {hist[0]['grad_norm']:.4f}, {hist[0]['dt'] * 1e3:.0f} ms")
    cfg = reduced(get_arch(TRAIN_ARCH))
    ckpt_dir = OUT_DIR / "train_resume"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def run(steps):
        tcfg = TrainConfig(steps=steps, ckpt_every=2, ckpt_dir=str(ckpt_dir),
                           log_every=1, opt=adamw.AdamWConfig(**TRAIN_OPT))
        with contextlib.redirect_stdout(io.StringIO()):
            return Trainer(cfg, TRAIN_SMALL, None, tcfg, device=DEV).train()
    params, opt_state, _ = run(4)
    step = ckpt.latest_step(ckpt_dir)
    restored, _ = ckpt.restore(ckpt_dir, {"params": params, "opt": opt_state})
    same = all(a.dtype == b.dtype and a.device == b.device
               and torch.equal(a.detach(), b) for a, b in zip(
                   tree_leaves({"params": params, "opt": opt_state}),
                   tree_leaves(restored)))
    _, _, hist = run(6)
    say(f"  checkpoint round at reduced width: newest step {step}, restored "
        f"onto {DEV} bit for bit: {same}; a second Trainer resumed at step "
        f"{hist[0]['step']}")
    if step != 4 or not same or hist[0]["step"] != 4:
        raise AssertionError(f"checkpoint round: step {step}, bit for bit "
                             f"{same}, resumed at {hist[0]['step']}")


def train_one_position_mesh(quick: bool) -> None:
    """One step of TRAIN_ARCH at full width on TRAIN_CPU_DEPTH layers
    through a ``ShardCtx`` over a one-rank NCCL world (``make_mesh((1, 1,
    1))``: the held parameters, the pipeline's block, the mesh step), and
    the same step with ``ctx=None``: the loss, every metric, parameter and
    moment bit for bit."""
    import torch.distributed as tdist

    from repro_torch.bench import distributed as dist
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import shard_params
    from repro_torch.train.step import make_train_step
    cfg = replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_CPU_DEPTH)
    if quick:
        cfg = reduced(cfg)
    own = not tdist.is_initialized()
    if own:
        dist.initialize(f"127.0.0.1:{dist.pick_free_port()}", 1, 0, DEV)
    try:
        ctx = ShardCtx(make_mesh((1, 1, 1), ("pod", "data", "model"),
                                 device=DEV))
        model = build(cfg)
        runs = {}
        for label, c in (("none", None), ("mesh", ctx)):
            params = init_params(model.param_specs(),
                                 torch.Generator(device=DEV).manual_seed(0))
            if c is not None:
                params = shard_params(cfg, params, c)
            opt = adamw.init_state(params)
            batch = make_pipeline(cfg, (TRAIN_B, TRAIN_S), c, seed=0,
                                  device=DEV).batch(0)
            step = make_train_step(cfg, c, adamw.AdamWConfig(**TRAIN_OPT))
            ms, (params, opt, m) = wall_ms(lambda: step(params, opt, batch))
            runs[label] = ({"params": params, "mu": opt["mu"],
                            "nu": opt["nu"]}, m, ms)
            del params, opt, batch
    finally:
        if own:
            dist._shutdown()
    (t0, m0, ms0), (t1, m1, ms1) = runs["none"], runs["mesh"]
    same_m = m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k])
                                            for k in m0)
    same_t = all(torch.equal(a.detach(), b.detach()) for a, b in
                 zip(tree_leaves(t0), tree_leaves(t1)))
    say(f"  one step at {cfg.n_layers} layers, batch {TRAIN_B} x {TRAIN_S}, "
        f"through a one-position mesh (one NCCL rank) against ctx=None: "
        f"loss {float(m1['loss']):.6f} vs {float(m0['loss']):.6f}, metrics "
        f"bit for bit {same_m}, parameters and moments bit for bit "
        f"{same_t}; {ms1:.0f} / {ms0:.0f} ms wall (first calls)")
    if not (same_m and same_t):
        raise AssertionError("3j: the one-position mesh step differs from "
                             "the ctx=None step")
    del runs, t0, t1
    torch.cuda.empty_cache()


def phase_train_path(quick: bool) -> dict[str, int]:
    """3j: training — TRAIN_ARCH at full width through the Trainer, its
    logits against the serving prefill's, the card against the CPU at full
    width on 2 layers, every arch reduced for a step, a checkpoint round
    and one step through a one-position mesh against ctx=None.  Training
    launches neither model kernel (the reference's are forward only);
    returns training's launches (0 each)."""
    say(f"== phase 3j: training (Trainer on {TRAIN_ARCH}"
        f"{' reduced' if quick else ' at full width'}, batch {TRAIN_B} x "
        f"{TRAIN_S}, {TRAIN_STEPS} steps, AdamW {TRAIN_OPT})")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    for mod in (mb, fa, sk):
        mod.reset_launch_counts()
    model, params = train_full_width(quick)
    counts = _train_counts()
    compare = train_against_serving(model, params)
    del model, params
    torch.cuda.empty_cache()
    for mod in (mb, fa, sk):
        mod.reset_launch_counts()
    train_card_against_cpu(quick)
    train_every_arch_and_resume()
    train_one_position_mesh(quick)
    counts = {k: v + _train_counts()[k] for k, v in counts.items()}
    say(f"  launches while training (the full-width run, the card-vs-CPU "
        f"gradients, the ten archs, the checkpoint round, the one-position "
        f"mesh): {counts}; the serving comparison's: {compare}")
    if any(counts.values()):
        raise AssertionError(f"training launched a kernel: {counts}")
    say(f"  phase 3j: {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 3l — the dry run and the roofline
# ---------------------------------------------------------------------------

#: the production cells the dry run and the probe trace on the host
#: (single pod, the rank of the last model coordinate)
DRYRUN_CELLS = (("granite-3-2b", "train_4k"), ("phi3-medium-14b",
                                               "prefill_32k"))
#: the processes 3l starts with phase 1 (``start_dryruns``); stopped in
#: ``main``
DRYRUNS: list = []


def start_dryruns() -> None:
    """Start ``python -m repro_torch.launch.dryrun`` then ``launch.probe``
    for each of DRYRUN_CELLS, one subprocess a cell, at low priority and
    one thread (host only: meta tensors, a fake world), their output in
    ``dryrun_<arch>.log`` under the output directory."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    for arch, shape in DRYRUN_CELLS:
        common = f"--arch {arch} --shape {shape} --mesh single --force"
        cmd = (f"{sys.executable} -m repro_torch.launch.dryrun {common} "
               f"--out-dir {OUT_DIR / 'dryrun'} && {sys.executable} -m "
               f"repro_torch.launch.probe {common} --out-dir "
               f"{OUT_DIR / 'probe'} --dryrun-dir {OUT_DIR / 'dryrun'}")
        log = open(OUT_DIR / f"dryrun_{arch}.log", "w")
        DRYRUNS.append((arch, shape, log, subprocess.Popen(
            ["nice", "-n", "10", "sh", "-c", cmd], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT)))


def wait_dryruns() -> None:
    """Wait for ``start_dryruns``' processes, so that none runs beside a
    timed phase; 3l reads what they wrote."""
    t0 = time.perf_counter()
    for _, _, _, proc in DRYRUNS:
        proc.wait(timeout=600)
    say(f"== the dry-run processes of 3l have ended (waited "
        f"{time.perf_counter() - t0:.1f} s after phase 2c)")


def stop_dryruns() -> None:
    for _, _, log, proc in DRYRUNS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _records(arch: str, shape: str) -> tuple[dict, dict]:
    name = f"{arch}__{shape}__pod1__baseline.json"
    return tuple(json.loads((OUT_DIR / d / name).read_text())
                 for d in ("dryrun", "probe"))


def phase_roofline(quick: bool) -> None:
    """3l: the dry-run cells (``start_dryruns``' processes, ended before
    phase 3), then the roofline of the one-card paths 3j and 3d timed."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.sharding import make_smoke_ctx
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analyze import RooflineTerms
    from repro_torch.roofline.model_bytes import analytic_bytes
    say("== phase 3l: the dry run and the roofline (python -m "
        "repro_torch.launch.dryrun / launch.probe on the host; the "
        "roofline of 3j and 3d)")
    t_phase = time.perf_counter()
    for arch, shape, log, proc in DRYRUNS:
        rc = proc.wait(timeout=600)
        text = (OUT_DIR / f"dryrun_{arch}.log").read_text()
        for line in text.splitlines():
            if line.startswith("["):
                say("  | " + line[:300])
        if rc != 0:
            raise AssertionError(f"dry run / probe of {arch} x {shape}: exit "
                                 f"{rc}\n{text[-3000:]}")
        dry, probe = _records(arch, shape)
        if dry["status"] != "ok" or probe["status"] != "ok":
            raise AssertionError(f"{arch} x {shape}: {dry.get('error')} / "
                                 f"{probe.get('error')}")
        if not all(abs(v) <= 0.01 for v in probe["match"].values()):
            raise AssertionError(f"{arch} x {shape}: the probe's parts "
                                 f"{probe['match']} from the whole")
        if not dry["fits_hbm"]:
            raise AssertionError(f"{arch} x {shape}: "
                                 f"{dry['peak_device_bytes']} bytes a rank")
        say(f"  {arch} x {shape} (16 x 16, rank {dry['rank']}): ok; FLOPs "
            f"{dry['flops']:.4e}, parts within {probe['match']}; "
            f"peak {dry['peak_device_bytes'] / 2**30:.2f} GiB; dominant "
            f"{dry['dominant']}; fallbacks {dry['sharding_fallbacks']}")
    dry, _ = _records(*DRYRUN_CELLS[1])
    n, a = OFFSET_TP, dry["attention_flops"]
    if "act_heads(40) !% ('model',)(16)" not in dry["sharding_fallbacks"] \
            or not 0 < a["rank"] <= (2 * n - 1) / n ** 2 * a["one_device"]:
        raise AssertionError(f"phi3 prefill_32k: {dry['sharding_fallbacks']}"
                             f", attention FLOPs {a}")
    say(f"  phi3's rank attends {a['rank'] / a['one_device']:.4f} of one "
        f"device's attention FLOPs (at most {(2 * n - 1) / n ** 2:.4f})")

    cfg = get_arch(TRAIN_ARCH)
    if quick:
        cfg = reduced(cfg)
    for name, shape in (
            ("train", ShapeConfig("3j", TRAIN_S, TRAIN_B, "train")),
            ("prefill", ShapeConfig("3d", SERVE_P, SERVE_B, "prefill"))):
        busy = BUSY_MS.get(name)
        if busy is None:
            raise AssertionError(f"3l: {name}'s device-busy time was not "
                                 f"measured")
        counts = dryrun.trace(cfg, shape, make_smoke_ctx(), BASELINE,
                              memory=False)
        terms = RooflineTerms(counts["flops"], analytic_bytes(
            cfg, shape, 1, tp=1, dp=1))
        share = max(terms.t_compute, terms.t_memory) * 1e3 / busy
        say(f"  roofline, {TRAIN_ARCH} {name} ({shape.global_batch} x "
            f"{shape.seq_len}): {counts['flops']:.4e} FLOPs, "
            f"{terms.hbm_bytes:.4e} bytes; t_compute "
            f"{terms.t_compute * 1e3:.3f} ms, t_memory "
            f"{terms.t_memory * 1e3:.3f} ms, dominant {terms.dominant}; "
            f"device busy {busy:.1f} ms; share {share:.4f}")
        if share > 1.0:
            raise AssertionError(f"3l: {name}'s roofline share {share} > 1: "
                                 f"the count is wrong")
    say(f"  phase 3l: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 3e — the characterize path
# ---------------------------------------------------------------------------

#: bytes a timed call of the device-paced characterization moves (the
#: Runner's ``target_bytes``): at the SMs' load/store rate (132 x 128 B x
#: 1980 MHz = 33.5 TB/s on an H100 SXM) such a call lasts >= 1.9 ms, so the
#: host's tens of microseconds a call stay <= 5 % of every point.  The
#: reference's presets (3e7 .. 2e8 bytes) give calls of a few microseconds
#: in the L2, which the host's share outlasts (``PERF.md`` §5).
CHARACTERIZE_TARGET_BYTES = 6.4e10
CHARACTERIZE_MIN_S = 1e-3
#: the kernel whose launches a mix's points count
ACC_COPY_KERNEL = {"load_sum": "load_sum", "copy": "copy"}


def _level_lines(model) -> list[str]:
    out = []
    for lvl in model.levels:
        br = (f"{lvl.capacity_ci[0]}..{lvl.capacity_ci[1]} B"
              if lvl.capacity_ci else "-")
        cells = "  ".join(f"{m} {c['gbps']:.1f}"
                          for m, c in lvl.bandwidth.items())
        out.append(f"  {lvl.name}: capacity {lvl.capacity_bytes} B, bracket "
                   f"{br}; GB/s {cells}")
    return out


def _check_launches(mixes: list[str], calls: int, what: str
                    ) -> dict[str, int]:
    """The launch counters after a characterization (set to 0 just before
    it) against the mixes of its points: one launch of the mix's kernel per
    timed call, ``calls`` = reps + warmup a point, and no other kernel."""
    counts = dict(mb.launch_counts)
    want = dict.fromkeys(counts, 0)
    for mix in mixes:
        kernel = "fma" if mix.startswith("fma_") else ACC_COPY_KERNEL[mix]
        want[kernel] += calls
    say(f"  launches ({what}): {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected "
                             f"{want} (points x {calls} calls)")
    return counts


def _check_device_paced(points) -> None:
    """Every point of a device-paced sweep ran on ``cuda``, lasted at least
    CHARACTERIZE_MIN_S a call, and stayed under the SMs' load/store rate
    and under what HBM can feed past the L2."""
    l2 = ON_CHIP["l2"]
    for p in points:
        if p.backend != "cuda":
            raise AssertionError(f"a {p.backend!r} point: {p}")
        if p.mean_s < CHARACTERIZE_MIN_S:
            raise AssertionError(
                f"{p.mix} at {p.nbytes} B: {p.mean_s * 1e3:.3f} ms a call, "
                f"under {CHARACTERIZE_MIN_S * 1e3} ms: the host sets its pace")
        check_on_chip_rate(f"characterize {p.mix} at {p.nbytes} B", p.gbps)
        # in-order passes over a footprint F > L2 find at most L2 bytes of
        # each pass on chip: the rest comes from HBM
        foot = p.nbytes * (2 if p.mix == "copy" else 1)
        if foot > l2 and p.gbps > (HBM_BYTES_PER_S / 1e9 * foot / (foot - l2)
                                   * 1.02):
            raise AssertionError(
                f"characterize {p.mix} at {p.nbytes} B: {p.gbps:.1f} GB/s, "
                f"above HBM's rate for a footprint of {foot} B over a "
                f"{l2} B L2")


def phase_characterize_path(quick: bool) -> dict[str, int]:
    say("== phase 3e: the characterize path (python -m repro_torch.bench "
        "characterize --smoke --backend cuda; then device-paced)")
    t0 = time.perf_counter()
    props = torch.cuda.get_device_properties(DEV)
    say(f"  L2_cache_size {props.L2_cache_size} B, "
        f"{props.multi_processor_count} SMs")
    root = OUT_DIR / "characterize_history"
    shutil.rmtree(root, ignore_errors=True)
    h100 = get_spec("nvidia-h100-sxm")

    # a. host-paced: the CLI as users run it, the reference's --smoke preset
    out = OUT_DIR / "characterize_smoke.json"
    mb.reset_launch_counts()
    rc, text = _cli(["characterize", "--smoke", "--backend", "cuda", "--out",
                     str(out), "--report",
                     str(OUT_DIR / "characterize_smoke.md"), "--compare",
                     "nvidia-h100-sxm", "--history-root", str(root),
                     "--force"])
    sync()
    (OUT_DIR / "characterize_smoke.txt").write_text(text)
    if rc != 0:
        raise AssertionError(f"characterize --smoke exited {rc}:\n{text}")
    for heading in ("Detected hierarchy", "Table-1 deltas",
                    "sysfs prior cross-check"):
        if heading not in text:
            raise AssertionError(f"characterize printed no {heading!r}")
    # host-paced, its GB/s are the host's pace below ~64 MiB and need not
    # show a level boundary (PERF.md §6): the device-paced run below
    # is held to >= 2 levels
    smoke = FittedMachineModel.from_json(out)
    if smoke.schema_version != 3 or not smoke.levels:
        raise AssertionError(f"smoke model: schema {smoke.schema_version}, "
                             f"{len(smoke.levels)} level(s)")
    [rec] = cli.ledger.read_ledger(root)
    if rec["backend"] != "cuda" or smoke.provenance["backend"] != "cuda":
        raise AssertionError(f"smoke ran on {rec['backend']!r}")
    # one ledger cell per point: each (mix, size) is measured once
    mixes = [c["mix"] for c in rec["curves"]]
    smoke_kw = cli.CHARACTERIZE_PRESETS["smoke"][0]
    counts = _check_launches(mixes, smoke_kw["reps"] + smoke_kw["warmup"],
                             "characterize --smoke")
    say(f"  smoke (host-paced, {len(mixes)} points, "
        f"{time.perf_counter() - t0:.1f} s): {len(smoke.levels)} levels")
    for line in _level_lines(smoke):
        say(line)

    # b. device-paced: the --full preset's mixes and grid through the API,
    # each call long enough that the device sets its pace
    t1 = time.perf_counter()
    kw, mixes = cli.CHARACTERIZE_PRESETS["full"]
    kw = dict(kw, target_bytes=CHARACTERIZE_TARGET_BYTES)
    if quick:
        kw.update(coarse_per_decade=2, max_rounds=1)
    runner = Runner(device=DEV)
    mb.reset_launch_counts()
    model, sweep = characterize(mixes, primary=mixes[0], runner=runner,
                                backend="cuda", register=False, **kw)
    sync()
    res = sweep.result
    full = _check_launches([p.mix for p in res.points],
                           kw["reps"] + kw["warmup"],
                           "device-paced characterize")
    _check_device_paced(res.points)
    if len(model.levels) < 2:
        raise AssertionError(f"the device-paced model has "
                             f"{len(model.levels)} level(s); the card has "
                             f"at least an on-chip level and HBM")
    path = OUT_DIR / "characterize_device.json"
    model.to_json(path)
    if FittedMachineModel.from_json(path).to_dict() != model.to_dict():
        raise AssertionError("the fitted model does not round-trip its JSON")
    res.to_json(OUT_DIR / "characterize_device_result.json")
    with open(OUT_DIR / "characterize_points.txt", "w") as f:
        for p in sorted(res.points, key=lambda q: (q.mix, q.nbytes)):
            f.write(f"{p.mix} {p.nbytes} {p.passes} {p.mean_s * 1e3:.4f} ms "
                    f"{p.gbps:.2f} GB/s\n")
    report = render_markdown(model, sweep, h100)
    (OUT_DIR / "characterize_device.md").write_text(report)
    say(f"  device-paced ({len(res.points)} points, target_bytes "
        f"{CHARACTERIZE_TARGET_BYTES:.3g}, {sweep.rounds} rounds, "
        f"{time.perf_counter() - t1:.1f} s): {len(model.levels)} levels, "
        f"calls {min(p.mean_s for p in res.points) * 1e3:.3f} .. "
        f"{max(p.mean_s for p in res.points) * 1e3:.3f} ms")
    for line in _level_lines(model):
        say(line)
    ridge = model.ridge_flops_per_byte
    say(f"  ridge: {ridge} flop/B"
        + (f" (fma depth {ridge * 4 / 2:.0f}, float32)" if ridge else ""))
    # on a CUDA runner the prior is core.machine_model.detect_device's
    say(f"  prior {model.sysfs_prior['prior_name']}: "
        f"{model.sysfs_prior['notes']}")
    for c in model.sysfs_prior["checks"]:
        say(f"  prior {c['prior']} {c['size_bytes']} B: "
            + (f"inside {c['bracket']}" if c["within_bracket"] else
               f"outside, nearest detected {c.get('nearest_detected')}"))
    say("  " + report.replace("\n", "\n  "))

    # copy, which drives the --smoke preset's detection, device-paced on the
    # same grid: two buffers a point, so its boundary is expected near half
    # the L2
    mb.reset_launch_counts()
    copy_sweep = adaptive_sweep("copy", runner=runner, backend="cuda", **kw)
    sync()
    copied = _check_launches([p.mix for p in copy_sweep.result.points],
                             kw["reps"] + kw["warmup"],
                             "device-paced copy sweep")
    _check_device_paced(copy_sweep.result.points)
    for k, v in copied.items():
        counts[k] += v + full[k]
    with open(OUT_DIR / "characterize_points.txt", "a") as f:
        for p in sorted(copy_sweep.result.points, key=lambda q: q.nbytes):
            f.write(f"copy-sweep {p.nbytes} {p.passes} "
                    f"{p.mean_s * 1e3:.4f} ms {p.gbps:.2f} GB/s\n")
    say(f"  device-paced copy sweep ({copy_sweep.n_points} points, "
        f"{copy_sweep.rounds} rounds): "
        f"{copy_sweep.detection.n_levels} levels")
    for lvl in copy_sweep.detection.levels:
        say(f"  {lvl.name}: bracket {lvl.capacity_ci}, {lvl.gbps:.1f} GB/s")

    # c. history lists both records; the device-paced one diffs clean
    cli.ledger.append_record(res, cmd="characterize", root=root)
    rc, text = _cli(["history", "--history-root", str(root)])
    rows = [l for l in text.splitlines() if l.split()[:1]
            and l.split()[0].isdigit()]
    say("  " + text.rstrip().replace("\n", "\n  "))
    if rc != 0 or len(rows) != 2:
        raise AssertionError(f"history exited {rc} with {len(rows)} records")
    rc, text = _cli(["diff", "--baseline", "-1", "--current", "-1",
                     "--history-root", str(root)])
    say("  " + text.rstrip().splitlines()[-1])
    if rc != 0 or " 0 regression(s)" not in text:
        raise AssertionError(f"diff of the record with itself exited {rc}")
    say(f"  phase 3e: {time.perf_counter() - t0:.1f} s")
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


def model_kernel_entries(counts: dict[str, int], errs: dict,
                         dense_launches: dict[str, int]) -> list[dict]:
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
    # the dense path's shape (granite-3-2b, GQA group 4, head dim 64)
    shape = dense_flash_shape(DENSE_SERVE)
    q, k, v = flash_inputs(*shape, torch.bfloat16, seed=sum(shape))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    nb = 2 * (q.numel() + k.numel() + v.numel()) + 2 * q.numel()
    nf = fa_ops.flops(q, k, True)
    ms, host_ms = time_both_ms(lambda: fa.flash_attention(q, k, v), 20)
    entries[0]["dense"] = {
        "arch": DENSE_SERVE, "shape": list(shape), "dtype": "bfloat16",
        "causal": True, "launches": dense_launches,
        "max_abs_err": errs["flash_attn_dense"][DENSE_SERVE],
        "max_abs_err_by_arch": errs["flash_attn_dense"], "ms": ms,
        "host_ms": host_ms,
        "device_ms": device_ms(lambda: fa.flash_attention(q, k, v), 20),
        "plain_ms": time_ms(lambda: fa.plain_flash(q, k, v), 5),
        **bound_fields(bytes_bound(nb, nb),
                       nf / PEAK_FLOPS["bfloat16_tensor"]),
        "library_ms": time_ms(sdpa, 20),
        "library_device_ms": device_ms(sdpa, 20), "flops": nf, "bytes": nb}
    del q, k, v, qt, kt, vt
    entries.append(ssd_entry(SSD_SERVE, errs["ssd_scan"],
                             counts.get("ssd_scan", 0),
                             SSD_ROUTE_LAUNCHES["zamba2-2.7b"]))
    for e in entries:
        say_model_entry(e)
    d = entries[0]["dense"]
    say(f"  flash_attn bfloat16 {d['shape']} ({d['arch']})  ms "
        f"{d['ms']:.4f}  (host {d['host_ms']:.4f})  {bound_note(d)} "
        f"({d['flops'] / 1e9:.2f} GFLOP, {d['bytes'] / 1e6:.2f} MB)  plain "
        f"{d['plain_ms']:.4f}  library {d['library_ms']:.4f}  device "
        f"{d['device_ms']:.4f} vs library {d['library_device_ms']:.4f}; "
        f"launches on the dense path {d['launches']}")
    return entries


def say_model_entry(e: dict) -> None:
    lib = "-" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
    say(f"  {e['name']:10s} {e['dtype']:8s} {e['shape']}"
        + (f" ({e['path']}" + (f", causal={e['causal']}" if "causal" in e
                                 else "") + ")" if "path" in e else "")
        + f"  ms {e['ms']:.4f}  (host {e['host_ms']:.4f})  {bound_note(e)} "
        f"({e['flops'] / 1e9:.2f} GFLOP, {e['bytes'] / 1e6:.2f} MB)  "
        f"plain {e['plain_ms']:.4f}  library {lib}  err "
        f"{e['max_abs_err']:.2e}  launches {e['launches']}"
        + (f"  device {e['device_ms']:.4f}" if "device_ms" in e else "")
        + (f"  route {e['ssd_route']} ({e['ssd_plan']}), launches by route "
           f"{e['launches_by_route']}" if "ssd_route" in e else "")
        + (f" vs library {e['library_device_ms']:.4f}"
           if e.get("library_device_ms") is not None else ""))


def ssd_entry(shape: tuple, err: float, launches: int,
              by_route: dict[int, int]) -> dict:
    """The ``kernels`` entry of ssd_scan at a serving shape (B, H, S, P, N,
    chunk): kernel ms (CUDA events) and device ms, the token recurrence's
    ms (``plain_ssd``), no library call, and the bound (the operations the
    function needs, ``ssd_ops.work_flops`` with C B^T once a B/C group, at
    the bf16 tensor peak, against x, dA, B and C read once and y and the
    state written once; B and C counted, both ways, as the storage their
    stride-0 views cover); the route and its plan, and the path's launches
    by route (``by_route``)."""
    xdt, dA, Bv, Cv = serve_ssd_inputs(shape=shape)
    chunk = shape[-1]
    BH, S, P = xdt.shape
    N = Bv.shape[-1]
    plan = sk.launch_plan(BH, P, N, chunk, xdt.dtype,
                          sms=torch.cuda.get_device_properties(
                              DEV).multi_processor_count)
    run = lambda: sk.ssd_scan(xdt, dA, Bv, Cv, chunk=chunk)  # noqa: E731
    ms, host_ms = time_both_ms(run, 20)
    B3, C3 = Bv.reshape(BH, S, N), Cv.reshape(BH, S, N)
    plain_ms = time_ms(lambda: sk.plain_ssd(xdt, dA, B3, C3), 3)
    nb = (2 * xdt.numel() * xdt.element_size()                # x in, y out
          + dA.numel() * 4 + 2 * 2 * shape[0] * S * N         # dA, B, C
          + BH * N * P * 4)                                   # state out
    groups = Bv.shape[0] * (Bv.shape[1] if Bv.stride(1) else 1)
    nf = ssd_ops.work_flops(BH, S, P, N, chunk, groups)
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": REPLACES["ssd_scan"], "launches": launches,
        "max_abs_err": err, "tolerance": SSD_TOL,
        "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
        **bound_fields(bytes_bound(nb, nb),
                       nf / PEAK_FLOPS["bfloat16_tensor"]),
        "library_ms": None, "device_ms": device_ms(run, 20), "flops": nf,
        "bytes": nb, "shape": list(shape), "dtype": "bfloat16",
        "launches_by_route": by_route, "ssd_route": plan["route"],
        "ssd_plan": {k: plan[k] for k in ("grid", "smem_bytes",
                                          "ctas_per_sm", "waves",
                                          "last_wave")},
    }


def flash_entry(path: str, shape: tuple, causal: bool, err: float,
                launches: int, q_offset: int = 0) -> dict:
    """The ``kernels`` entry of flash_attn at a serving shape (B, Sq, Sk, H,
    KV, D, Dv), bf16, with encdec's blocks: kernel ms (CUDA events) and
    device ms, ``plain_flash``'s ms, ``scaled_dot_product_attention``'s on
    the same tensors (it takes Dv != D and Sq != Sk; timed here, used
    nowhere in the port; with a ``q_offset``, which ``is_causal`` cannot
    shift, an explicit boolean mask of the same causal limit), and the
    bound: 2 B H (D + Dv) operations a (query, key) pair the mask keeps
    (Sq Sk, halved when causal; Sq q_offset + Sq**2 / 2 with an offset) at
    the bf16 tensor peak against q, k, v read once and o written once."""
    B, Sq, Sk, H, KV, D, Dv = shape
    q, k, v = flash_qkv(*shape, torch.bfloat16, seed=sum(shape))
    blocks = dict(q_block=encdec_mod.flash_block(Sq),
                  kv_block=encdec_mod.flash_block(Sk), q_offset=q_offset)
    run = lambda: fa.flash_attention(q, k, v, causal=causal, **blocks)  # noqa: E731
    ms, host_ms = time_both_ms(run, 20)
    plain_ms = time_ms(lambda: fa.plain_flash(q, k, v, causal=causal,
                                              q_offset=q_offset), 5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = None
    if q_offset:
        mask = (torch.arange(Sq, device=DEV)[:, None] + q_offset
                >= torch.arange(Sk, device=DEV)[None, :])
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    nb = 2 * (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv)
    pairs = (Sq * q_offset + Sq * Sq / 2 if q_offset
             else Sq * Sk / (2 if causal else 1))
    nf = 2.0 * B * H * (D + Dv) * pairs
    return {
        "name": "flash_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attn.cu",
        "replaces": REPLACES["flash_attn"], "launches": launches,
        "path": path, "max_abs_err": err, "tolerance": FLASH_TOL["bfloat16"],
        "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
        **bound_fields(bytes_bound(nb, nb),
                       nf / PEAK_FLOPS["bfloat16_tensor"]),
        "library_ms": time_ms(sdpa, 20), "device_ms": device_ms(run, 20),
        "library_device_ms": device_ms(sdpa, 20), "flops": nf, "bytes": nb,
        "shape": list(shape), "dtype": "bfloat16", "causal": causal,
        "q_offset": q_offset,
    }


def offset_kernel_entry(errs: dict) -> dict:
    """flash_attn with a query offset (``PERF.md`` row 7f), under the
    serving entry's ``q_offset``: the last rank's shape of
    ``offset_shapes()`` for phi3, timed as ``flash_entry`` times a serving
    shape.  ``launches``: the offset launches the main paths made
    (``MAIN_OFFSET_LAUNCHES``; no one-card path splits a sequence over
    ``model``, so they read 0 there); ``launches_holds`` counts 2c's
    comparisons."""
    arch, r, shape, q0 = [c for c in offset_shapes()
                          if c[0] == OFFSET_ARCHS[0]][-1]
    e = flash_entry(f"{arch} rank {r} of a model axis of {OFFSET_TP} "
                    f"(train_4k)", shape, True,
                    max(v for k, v in errs.items() if k != "launches"),
                    MAIN_OFFSET_LAUNCHES["flash_attn"], q_offset=q0)
    e["launches_holds"] = errs["launches"]
    e["max_abs_err_by_case"] = {k: v for k, v in errs.items()
                                if k != "launches"}
    say_model_entry(e)
    torch.cuda.empty_cache()
    return e


def family_kernel_entries(errs: dict, launches: dict) -> list[dict]:
    """The ``kernels`` entries at the ssm / encdec / mla serving shapes:
    flash at deepseek's (192, 128) pair, whisper's encoder (1500 frames)
    and cross-attention (256 prompt tokens against them); the SSD at
    mamba2's shape (route 2).  ``launches`` is the path's count of the
    kernel in its phase 3d run."""
    shapes = family_shapes()
    entries = [
        flash_entry(f"{MLA_SERVE} ({DENSE_DEPTH} layers)", *shapes["mla"],
                    errs["mla"], launches[MLA_SERVE]["flash_attn"]),
        flash_entry(f"{ENCDEC_SERVE} encoder", *shapes["encoder"],
                    errs["encoder"], launches[ENCDEC_SERVE]["flash_attn"]),
        flash_entry(f"{ENCDEC_SERVE} cross-attention", *shapes["cross"],
                    errs["cross"], launches[ENCDEC_SERVE]["flash_attn"]),
        {**ssd_entry(shapes["ssd"], errs["ssd"],
                     launches[SSM_SERVE]["ssd_scan"],
                     SSD_ROUTE_LAUNCHES[SSM_SERVE]), "path": SSM_SERVE},
    ]
    for e in entries:
        say_model_entry(e)
        torch.cuda.empty_cache()
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
    if torch.cuda.is_available():
        # host only: beside the builds and phase 2's checks, none timed
        start_dryruns()
    try:
        info = phase_device()
        phase_kernels(args.quick)
        phase_rw_chase(args.quick)
        errs = phase_model_kernels(args.quick)
        family_errs = phase_family_kernels(args.quick)
        rank_errs = phase_rank_kernels(args.quick)
        offset_errs = phase_offset_kernels(args.quick)
        wait_dryruns()
        return _main_paths(args, t0, info, errs, family_errs, rank_errs,
                           offset_errs)
    finally:
        stop_dryruns()


def _main_paths(args, t0, info, errs, family_errs, rank_errs,
                offset_errs) -> int:
    counts = phase_main_path(args.quick)
    counts["rw"] = phase_rw_path(args.quick)["rw"]
    counts["chase"] = phase_latency_path(args.quick)["chase"]
    counts.update(phase_serve_path(args.quick))
    dense = phase_dense_serve_path(args.quick)
    families = phase_family_serve_path(args.quick)
    mesh_served = phase_mesh_serve_path(args.quick)
    trained = phase_train_path(args.quick)
    characterized = phase_characterize_path(args.quick)
    audited = phase_audit_path(args.quick)
    phase_mesh_path(args.quick)
    figures = phase_figures_path(args.quick)
    probed = phase_collectives_path(args.quick)
    phase_roofline(args.quick)
    phase_real(args.quick)
    phase_real_rw_chase(args.quick)
    line = phase_kernels_line(counts, args.quick)
    line["kernels"] += model_kernel_entries(counts, errs, dense)
    line["kernels"] += family_kernel_entries(family_errs, families)
    flash = next(e for e in line["kernels"] if e["name"] == "flash_attn")
    flash["q_offset"] = offset_kernel_entry(offset_errs)
    for e in line["kernels"]:
        if e["name"] == "load_sum":
            e["launches_probe"] = probed["load_sum"]
        if e["name"] in ("load_sum", "fma", "copy"):
            e["launches_characterize"] = characterized[e["name"]]
        if e["name"] in ("load_sum", "copy", "rw", "chase"):
            e["launches_audit"] = audited[e["name"]]
        if e["name"] in mb.launch_counts:
            e["launches_figures"] = figures.get(e["name"], 0)
        if e["name"] in trained:
            e["launches_train"] = trained[e["name"]]
        if e["name"] in mesh_served:
            e["launches_mesh_serve"] = mesh_served[e["name"]]
        if e["name"] in rank_errs:
            e["max_abs_err_rank_shapes"] = rank_errs[e["name"]]
    say(f"== all phases passed in {time.perf_counter() - t0:.1f} s")
    say(info["smi"])
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
