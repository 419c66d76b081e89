"""Fig 7 — loaded-latency surface (Mess-style bandwidth–latency curves).

Counterpart of ``benchmarks/fig7_loaded_latency.py`` on the port: the same
(sizes x loads) grid over ``repro_torch.characterize.loaded``.  The
reference's default backend (``xla``) walks the chain on the device; here
that is ``cuda``, the default: ``chase.cu``'s dependent walk, with acc.cu's
load_sum sweeps as the generators, time-shared.  ``--backend torch`` times
the oracle's host walk (its latency_ns is the interpreter's, no memory
latency), as the ``latency`` CLI's help says.

    PYTHONPATH=src:. python -m benchmarks_torch.fig7_loaded_latency --quick
"""
from __future__ import annotations

import argparse
from pathlib import Path

from benchmarks_torch.common import add_device_flags, emit
from repro_torch.bench import Runner
from repro_torch.characterize.loaded import fit_loaded, loaded_latency_sweep

ART = Path(__file__).resolve().parents[1] / "artifacts" / "torch"


def grid(quick: bool = False, smoke: bool = False) -> dict:
    if smoke:
        return dict(sizes=(128 * 2**10,), loads=(0, 1, 2), reps=3)
    if quick:
        return dict(sizes=(128 * 2**10, 4 * 2**20), loads=(0, 1, 2, 4),
                    reps=3)
    return dict(sizes=(128 * 2**10, 4 * 2**20, 64 * 2**20),
                loads=(0, 1, 2, 4, 8), reps=5)


def row_name(backend: str, nbytes: int, load: int) -> str:
    return f"fig7/{backend}/{nbytes}B/load{load}"


def main(quick: bool = False, smoke: bool = False, out: str | None = None,
         backend: str = "cuda", device: str = "cuda"):
    kw = grid(quick, smoke)
    runner = Runner(device=device)          # raises without a CUDA device
    res = loaded_latency_sweep(kw.pop("sizes"), kw.pop("loads"),
                               backend=backend, runner=runner, **kw)
    fit = fit_loaded(res)
    if fit:
        res.meta["loaded_latency"]["fit"] = fit

    for p in sorted(res.points, key=lambda p: (p.nbytes, p.load)):
        emit(row_name(p.backend, p.nbytes, p.load), p.mean_s * 1e6,
             f"{p.latency_ns:.2f}ns;{p.gen_gbps:.2f}GB/s-generated")
    for name, knee in ((fit or {}).get("levels") or {}).items():
        print(f"# {name}: idle {knee['idle_latency_ns']:.1f} ns, knee at "
              f"load={knee['knee_load']} ({knee['knee_gen_gbps']:.2f} GB/s), "
              f"max {knee['max_latency_ns']:.1f} ns")

    if out:
        res.to_json(out)
        print(f"# saved {len(res.points)} points "
              f"(schema v{res.schema_version}) -> {out}")
    elif not smoke:
        ART.mkdir(parents=True, exist_ok=True)
        res.to_json(ART / "fig7_loaded_latency.json")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale grid — the CI smoke gate")
    ap.add_argument("--out", default=None,
                    help="write the schema-v5 result JSON here")
    add_device_flags(ap)
    main(**vars(ap.parse_args()))
