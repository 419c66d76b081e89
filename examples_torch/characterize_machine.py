"""Standalone Arm-membench-style machine characterization (the paper's CLI),
on the port — counterpart of ``examples/characterize_machine.py``.

Thin wrapper over ``repro_torch.characterize``: adaptive fine-granularity
sweep, change-point topology detection (no sysfs/documentation input),
fitted machine model + report, plus the per-device straggler probe.  The
heavy lifting — and the ``--smoke``/``--full`` presets — live in
``python -m repro_torch.bench characterize``; this example shows the
library API.  The sweep runs the hand-written kernels (the ``cuda``
backend; on the CPU their plain versions).

    PYTHONPATH=src python examples_torch/characterize_machine.py [--full]
    PYTHONPATH=src python examples_torch/characterize_machine.py --device cpu
"""
import argparse
from pathlib import Path

from repro_torch.bench import Runner
from repro_torch.characterize import characterize, render_markdown
from repro_torch.core.machine_model import detect_host
from repro_torch.ft.stragglers import probe_devices

ROOT = Path(__file__).resolve().parents[1]


def main(full: bool = False, device: str = "cuda",
         out_dir: str = str(ROOT / "artifacts" / "torch")):
    runner = Runner(device=device)          # raises without a CUDA device
    prior = detect_host()
    print(f"sysfs prior: {prior.name} ({len(prior.levels)} levels — "
          f"cross-checked below, not trusted)")

    if full:
        kw = dict(coarse_per_decade=4, hi=256 * 2**20, reps=10, warmup=2,
                  target_bytes=2e8, resolution=0.10)
        mixes = ("load_sum", "copy", "fma_1", "fma_2", "fma_8", "fma_32",
                 "fma_64")
    else:
        kw = dict(coarse_per_decade=3, reps=5, warmup=1, target_bytes=5e7,
                  resolution=0.25, max_rounds=4)
        mixes = ("load_sum", "copy", "fma_8", "fma_32")
    model, sweep = characterize(mixes=mixes, primary=mixes[0], prior=prior,
                                runner=runner, backend="cuda", **kw)
    print(render_markdown(model, sweep))

    print("== per-device probe (straggler check) ==")
    for p in probe_devices(nbytes=1 * 2**20, passes=2, reps=3, device=device):
        flag = "  <-- STRAGGLER" if p.is_straggler else ""
        print(f"  {p.device}: {p.gbps:.2f} GB/s (z={p.z_score:+.2f}){flag}")

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model.to_json(out / "fitted_machine_model.json")
    model.to_machine_model().to_json(out / "machine_model_host.json")
    sweep.result.to_json(out / "characterize_sweep.json")
    print(f"\nsaved: {out}/fitted_machine_model.json (+ legacy "
          f"machine_model_host.json, characterize_sweep.json)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) | "
                         "cpu (the kernels' plain versions; no device number)")
    ap.add_argument("--out-dir", dest="out_dir",
                    default=str(ROOT / "artifacts" / "torch"))
    main(**vars(ap.parse_args()))
