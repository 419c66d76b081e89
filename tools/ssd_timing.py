#!/usr/bin/env python3
"""Device time of the SSD kernel (``ssd_scan``) of one checkout's package at
a serving shape, on one NVIDIA GPU: for an A/B of two commits in one call.

    python3 tools/ssd_timing.py                               # this checkout
    python3 tools/ssd_timing.py --src DIR/src --label parent  # another one
    python3 tools/ssd_timing.py --shape zamba2,mamba2         # both shapes
    python3 tools/ssd_timing.py --route2 --label route2       # route 2 at N 64

``--route2`` sends bfloat16 to route 2 where ``launch_plan`` would give
route 1 (its width-64 build at zamba2's shape: what route 1 is weighed
against); the package must have it.  Every bfloat16 output is held against
``plain_ssd`` (the token recurrence in float32) within the smoke's SSD_TOL,
2e-4, plus (2e-4 + 2**-8) of |y|.

Times ``repro_torch.kernels.ssd_scan.ssd_scan.ssd_scan`` of the package
under ``--src`` on a prefill shape (``--shape``): ``zamba2`` (zamba2-2.7b,
the default: B 4, H 80, S 512, P 64, N 64, chunk 256) or ``mamba2``
(mamba2-2.7b: the same with N 128); x and dA per head, B and C one matrix
per batch row expanded over its heads with stride 0, as the model lays
them out; seed 64, as ``chip_smoke.py`` phase 5; in bfloat16 (the serving
dtype) and in float32 (x, B and C widened).  Device time: the calls are enqueued behind a
device-side sleep, so that the host's pace drops out; the CUDA-event time of
back-to-back calls beside it.  Each is taken ``--rounds`` times and the
lesser kept.  Writes ``<out-dir>/ssd_<label>_<shape>.json`` with the card's
name and power limit and the launch plan of each dtype.  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (batch, heads, sequence, P, N, chunk) of the serving paths
SHAPES = {"zamba2": (4, 80, 512, 64, 64, 256),
          "mamba2": (4, 80, 512, 64, 128, 256)}


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--shape", default="zamba2",
                    help="comma-separated: " + ", ".join(SHAPES))
    ap.add_argument("--n", type=int, default=20, help="calls a timing")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--route2", action="store_true",
                    help="bfloat16 on route 2 where the plan gives route 1")
    ap.add_argument("--out-dir", default=str(ROOT / "artifacts" / "ssd"))
    return ap.parse_args()


ARGS = parse_args()
if not set(ARGS.shape.split(",")) <= set(SHAPES):
    sys.exit(f"ssd_timing: --shape takes {', '.join(SHAPES)}")
sys.path.insert(0, str(Path(ARGS.src).resolve()))

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("ssd_timing: no CUDA device", file=sys.stderr)
    sys.exit(2)

from repro_torch.kernels.ssd_scan import ssd_scan as sk  # noqa: E402

DEV = torch.device("cuda", 0)
SSD_TOL = 2e-4


def route2_plan(BH, P, N, Q, dtype, sms=132, aligned=True) -> dict:
    """``launch_plan``, but route 2 where it gives route 1."""
    plan = PLAN(BH, P, N, Q, dtype, sms, aligned)
    if plan["route"] != 1:
        return plan
    smem = sk.wide_smem_bytes(N, Q)
    per_sm = min(sk.WIDE_CTAS_PER_SM,
                 sk.SM_SMEM_BYTES // (smem + sk.SMEM_PER_BLOCK))
    grid, slots = -(-P // sk.WIDE_COLS) * BH, per_sm * sms
    return {"route": 2, "grid": grid, "smem_bytes": smem,
            "ctas_per_sm": per_sm, "slots": slots, "waves": grid / slots,
            "last_wave": (grid - 1) % slots + 1}


PLAN = sk.launch_plan
if ARGS.route2:
    sk.launch_plan = route2_plan


def device_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device ms per call over ``n`` back-to-back calls enqueued behind
    a device-side sleep long enough for the host to enqueue them all."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
        torch.cuda.synchronize()
        if covered:
            return t0.elapsed_time(t1) / n
        cycles *= 4
    raise AssertionError("device_ms: the host did not get ahead of the device")


def event_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def serve_inputs(shape: tuple, dtype, seed: int = 64) -> tuple:
    B, H, S, P, N, _ = shape
    g = torch.Generator(device=DEV).manual_seed(seed)

    def randn(shape, scale):
        return (torch.randn(shape, generator=g, device=DEV) * scale)
    xdt = randn((B * H, S, P), 0.5).to(torch.bfloat16)
    dA = -randn((B * H, S), 0.3).abs()
    Bm = randn((B, S, N), 0.5).to(torch.bfloat16)
    Cm = randn((B, S, N), 0.5).to(torch.bfloat16)
    xdt, Bm, Cm = (t.to(dtype) for t in (xdt, Bm, Cm))
    return (xdt, dA, Bm.unsqueeze(1).expand(B, H, S, N),
            Cm.unsqueeze(1).expand(B, H, S, N))


def main() -> int:
    out = Path(ARGS.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t_start = time.perf_counter()
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    for name in ARGS.shape.split(","):
        shape = SHAPES[name]
        B, H, S, P, N, chunk = shape
        rows = []
        for dtype in (torch.bfloat16, torch.float32):
            args = serve_inputs(shape, dtype)
            fn = lambda: sk.ssd_scan(*args, chunk=chunk)  # noqa: E731
            y, st = fn()
            torch.cuda.synchronize()
            if not (bool(y.float().isfinite().all())
                    and bool(st.isfinite().all())):
                raise AssertionError(f"ssd_scan {dtype}: non-finite output")
            err = None
            if dtype == torch.bfloat16:
                xdt, dA, Bv, Cv = args
                py, pst = sk.plain_ssd(xdt, dA, Bv.reshape(B * H, S, N),
                                       Cv.reshape(B * H, S, N))
                d = (y.float() - py).abs()
                if not (bool((d <= SSD_TOL + (SSD_TOL + 2.0**-8)
                              * py.abs()).all())
                        and bool(((st - pst).abs()
                                  <= SSD_TOL + SSD_TOL * pst.abs()).all())):
                    raise AssertionError(f"ssd_scan {name}: y or the state "
                                         f"off plain_ssd")
                err = float(d.max())
                del py, pst, d
            dev = min(device_ms(fn, ARGS.n) for _ in range(ARGS.rounds))
            ev = min(event_ms(fn, ARGS.n) for _ in range(ARGS.rounds))
            plan = sk.launch_plan(B * H, P, N, chunk, dtype, sms=sms)
            r = {"label": ARGS.label, "src": ARGS.src, "shape": list(shape),
                 "dtype": str(dtype).removeprefix("torch."),
                 "device_ms": dev, "event_ms": ev, "plan": plan,
                 "max_abs_err": err, "route2": ARGS.route2}
            rows.append(r)
            print(f"  ssd_scan {ARGS.label:8s} {name} {r['dtype']:8s} "
                  f"{shape}  device {dev:.4f} ms  event {ev:.4f} ms  route "
                  f"{plan['route']}, {plan['grid']} CTAs, "
                  f"{plan['ctas_per_sm']} an SM", flush=True)
            del args, y, st
            torch.cuda.empty_cache()
        (out / f"ssd_{ARGS.label}_{name}.json").write_text(json.dumps(
            {"device": torch.cuda.get_device_name(0), "smi": smi,
             "rows": rows}, indent=1))
    print(f"  done in {time.perf_counter() - t_start:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
