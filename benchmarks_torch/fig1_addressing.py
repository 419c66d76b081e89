"""Fig 1 — addressing-mode overhead (post-increment vs manual multi-pointer).

Counterpart of ``benchmarks/fig1_addressing.py`` on the port.  The same
BenchSpec declaration (``streams`` = C3 knob: one contiguous stream vs S
interleaved strided streams), run by the port's Runner: on the ``cuda``
backend ``acc.cu``'s load_sum walks the tiles in S address streams, on
``torch`` the strided-walk oracle (``core.instruction_mix.k_strided_sum``)
does.  Relative throughput anchors on the streams=1 point per size via
``BenchResult.baseline_relative``.

    PYTHONPATH=src:. python -m benchmarks_torch.fig1_addressing --quick
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import add_device_flags, emit
from repro_torch.bench import BenchSpec, Runner
from repro_torch.core.buffers import hierarchy_grid

STREAM_COUNTS = (1, 2, 4, 8)


def specs(quick: bool = False, backend: str = "cuda") -> list[BenchSpec]:
    """The declaration: one load_sum spec per stream count."""
    # shared grid constructor (core.buffers): the quick ladder, or a sparse
    # log grid across the full hierarchy span
    sizes = hierarchy_grid(quick=True) if quick else \
        hierarchy_grid(per_decade=2)
    base = BenchSpec(mixes=("load_sum",), sizes=sizes,
                     reps=5 if quick else 10, warmup=2,
                     target_bytes=5e7 if quick else 2e8, backend=backend)
    return [base.replace(streams=s) for s in STREAM_COUNTS]


def row_name(streams: int, nbytes: int) -> str:
    return f"fig1/streams{streams}/{nbytes}B"


def main(quick: bool = False, out: str | None = None, backend: str = "cuda",
         device: str = "cuda"):
    res = Runner(device=device).run_many(specs(quick, backend))

    rel = dict(res.baseline_relative(group_key=lambda p: p.nbytes,
                                     is_baseline=lambda p: p.streams == 1))
    for p in sorted(res.points, key=lambda p: (p.nbytes, p.streams)):
        emit(row_name(p.streams, p.nbytes), p.mean_s * 1e6,
             f"{p.gbps:.2f}GB/s;rel={rel[p]:.3f}")
    if out:
        res.to_json(out)
        print(f"# saved {len(res.points)} points "
              f"(schema v{res.schema_version}) -> {out}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None, help="write result JSON here")
    add_device_flags(ap)
    main(**vars(ap.parse_args()))
