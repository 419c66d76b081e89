"""Fig 6 — bandwidth-bound vs issue-bound classification
(``repro_torch.istream``).

Counterpart of ``benchmarks/fig6_istream.py`` on the port: the same sweep
grid (unroll x interleave over lean and store-mixed kernels) over
``repro_torch.istream.run_istream``, on the ``torch`` backend (profiles
from the aten trace) and the ``cuda`` backend (profiles from the SASS of the
kernels this checkout built, run by ``istream.emulate``; ``cuobjdump``
required, as on the card's machine).  Every measured point is labelled
bandwidth-bound or issue-bound with a confidence margin.

On the card the fitted issue rate is a host-paced fit: the sweep's calls
(64 KiB to 8 MiB quick) last less than the host's share of a timed call, so
the rate is work over wall time, not the SMs' issue rate.  The printed
table says so.

    PYTHONPATH=src:. python -m benchmarks_torch.fig6_istream --quick
"""
from __future__ import annotations

import argparse
from pathlib import Path

from benchmarks_torch.common import add_device_flags, emit
from repro_torch.bench import Runner
from repro_torch.istream import run_istream

ART = Path(__file__).resolve().parents[1] / "artifacts" / "torch"

#: the reference sweeps both of its backends (xla, pallas); their
#: counterparts here
BACKENDS = ("torch", "cuda")
#: the mixes ``run_istream`` sweeps by default, as the reference's run does
MIXES = ("copy", "rw_2to1")


def grid(quick: bool = False, smoke: bool = False) -> dict:
    if smoke:
        return dict(smoke=True)
    if quick:
        return dict(sizes=(1 << 16, 1 << 20, 1 << 23),
                    unrolls=(1, 2), interleaves=(1, 2), reps=3)
    return dict(sizes=(1 << 16, 1 << 20, 1 << 24, 1 << 26),
                unrolls=(1, 2, 4), interleaves=(1, 2, 4), reps=5)


def row_name(backend: str, mix: str, unroll: int, interleave: int,
             nbytes: int) -> str:
    return f"fig6/{backend}/{mix}/u{unroll}i{interleave}/{nbytes}B"


def main(quick: bool = False, smoke: bool = False, out: str | None = None,
         model: str | None = None, backend: str | None = None,
         device: str = "cuda"):
    """``backend`` None sweeps both backends, as the reference does; a name
    sweeps that one."""
    kw = grid(quick, smoke)
    if model:
        from repro_torch.characterize.fit import FittedMachineModel
        kw["model"] = FittedMachineModel.from_json(model)
    runner = Runner(device=device)          # raises without a CUDA device
    report = run_istream(backends=BACKENDS if backend is None else
                         (backend,), mixes=MIXES, runner=runner, **kw)
    for p in sorted(report.result.points,
                    key=lambda p: (p.backend, p.mix, p.nbytes,
                                   p.unroll, p.interleave)):
        info = p.istream or {}
        emit(row_name(p.backend, p.mix, p.unroll, p.interleave, p.nbytes),
             p.mean_s * 1e6,
             f"{p.gbps:.2f}GB/s;{info.get('label', 'unclassified')}")
    print()
    print(report.table)
    if runner.device.type == "cuda":
        print("# the fitted issue rate is host-paced: these calls last less "
              "than the host's share of a timed call, so it is work over "
              "wall time, not the SMs' issue rate")

    if out:
        report.result.to_json(out)
        print(f"# saved {len(report.result.points)} classified points "
              f"(schema v{report.result.schema_version}) -> {out}")
    elif not smoke:
        ART.mkdir(parents=True, exist_ok=True)
        report.result.to_json(ART / "fig6_istream.json")
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale grid — the CI smoke gate")
    ap.add_argument("--out", default=None,
                    help="write the classified result JSON here")
    ap.add_argument("--model", default=None,
                    help="FittedMachineModel JSON for bandwidth lookup")
    ap.add_argument("--backend", default=None,
                    help="torch | cuda (default: both, as the reference "
                         "sweeps both of its backends)")
    add_device_flags(ap, backend=None)
    main(**vars(ap.parse_args()))
