#!/usr/bin/env python3
"""Device time of the SSD kernel (``ssd_scan``) of one checkout's package at
the serving shape, on one NVIDIA GPU: for an A/B of two commits in one call.

    python3 tools/ssd_timing.py                               # this checkout
    python3 tools/ssd_timing.py --src DIR/src --label parent  # another one

Times ``repro_torch.kernels.ssd_scan.ssd_scan.ssd_scan`` of the package
under ``--src`` on ``zamba2-2.7b``'s prefill shape (B 4, H 80, S 512, P 64,
N 64, chunk 256; x and dA per head, B and C one matrix per batch row
expanded over its heads with stride 0, as the model lays them out; seed 64,
as ``chip_smoke.py`` phase 5), in bfloat16 (the serving dtype) and in
float32 (x, B and C widened).  Device time: the calls are enqueued behind a
device-side sleep, so that the host's pace drops out; the CUDA-event time of
back-to-back calls beside it.  Each is taken ``--rounds`` times and the
lesser kept.  Writes ``<out-dir>/ssd_<label>.json`` with the card's name and
power limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (batch, heads, sequence, P, N, chunk) of the serving path
SERVE = (4, 80, 512, 64, 64, 256)


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--n", type=int, default=20, help="calls a timing")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out-dir", default=str(ROOT / "artifacts" / "ssd"))
    return ap.parse_args()


ARGS = parse_args()
sys.path.insert(0, str(Path(ARGS.src).resolve()))

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("ssd_timing: no CUDA device", file=sys.stderr)
    sys.exit(2)

from repro_torch.kernels.ssd_scan import ssd_scan as sk  # noqa: E402

DEV = torch.device("cuda", 0)


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


def serve_inputs(dtype, seed: int = 64) -> tuple:
    B, H, S, P, N, _ = SERVE
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
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        args = serve_inputs(dtype)
        fn = lambda: sk.ssd_scan(*args, chunk=SERVE[-1])  # noqa: E731
        y, st = fn()
        torch.cuda.synchronize()
        if not (bool(y.float().isfinite().all())
                and bool(st.isfinite().all())):
            raise AssertionError(f"ssd_scan {dtype}: non-finite output")
        dev = min(device_ms(fn, ARGS.n) for _ in range(ARGS.rounds))
        ev = min(event_ms(fn, ARGS.n) for _ in range(ARGS.rounds))
        r = {"label": ARGS.label, "src": ARGS.src, "shape": list(SERVE),
             "dtype": str(dtype).removeprefix("torch."), "device_ms": dev,
             "event_ms": ev}
        rows.append(r)
        print(f"  ssd_scan {ARGS.label:8s} {r['dtype']:8s} {SERVE}  device "
              f"{dev:.4f} ms  event {ev:.4f} ms", flush=True)
        del args, y, st
        torch.cuda.empty_cache()
    (out / f"ssd_{ARGS.label}.json").write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "smi": smi, "rows": rows},
        indent=1))
    print(f"  done in {time.perf_counter() - t_start:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
