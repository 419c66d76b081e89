"""Fig 5 — R:W-ratio sweep with store-path attribution (the paper's central
finding: achievable throughput depends on the *relation* between load and
store instructions, not raw bandwidth).

Counterpart of ``benchmarks/fig5_rw_ratio.py`` on the port: the same
declarations (ratio x working-set size) through the port's Runner — on
``cuda`` the ``rw.cu`` kernel, on ``torch`` the ``k_rw`` oracle.  The
per-level table comes from ``BenchResult.summarize`` with the device's
levels: ``detect_device`` on CUDA (the 50 MB L2, then HBM as ``DRAM``),
``detect_host`` on the CPU.

    PYTHONPATH=src:. python -m benchmarks_torch.fig5_rw_ratio --quick
"""
from __future__ import annotations

import argparse
import math
from pathlib import Path

from benchmarks_torch.common import add_device_flags, emit
from benchmarks_torch.fig2_hierarchy import levels_of
from repro_torch.bench import RW_RATIOS, BenchSpec, Runner, rw_name
from repro_torch.bench.result import level_band
from repro_torch.core.buffers import hierarchy_grid

ART = Path(__file__).resolve().parents[1] / "artifacts" / "torch"

#: the swept (reads, writes) ratios — the registry's canonical ladder,
#: store-heavy to load-heavy
RATIOS = RW_RATIOS


def quick_sizes(levels) -> tuple[int, ...]:
    """One band-interior working-set size per detected hierarchy level: the
    geometric mean of each level's (2x prev, 0.5x level) attribution band,
    and 2x the band floor for the unbounded DRAM level (no fixed cap — a cap
    below the floor would silently drop the DRAM row on big-LLC hosts).
    Typical cache sizes (32K/256K/...) sit exactly ON band edges, so a fixed
    size list would fall outside every band on devices whose levels are
    reported."""
    sizes, prev = [], 2 * 2**10
    for lvl in levels:
        lo, hi = level_band(lvl.size_bytes, prev)
        size = 2 * lo if math.isinf(hi) else math.sqrt(lo * hi)
        sizes.append(int(size))
        if lvl.size_bytes:
            prev = lvl.size_bytes
    if len(sizes) < 3:          # cacheless topology (DRAM-only detection)
        sizes.extend((32 * 2**10, 2 * 2**20))
    return tuple(sorted(set(sizes)))


def spec_for(quick: bool = False, smoke: bool = False, backend: str = "cuda",
             device: str = "cuda") -> BenchSpec:
    ratios = ((1, 1), (2, 1), (3, 1)) if smoke else RATIOS
    mixes = tuple(rw_name(r, w) for r, w in ratios)
    if smoke:
        return BenchSpec(mixes=mixes, sizes=(32 * 2**10,), reps=2, warmup=1,
                         passes=1, tags=("fig5", "smoke"), backend=backend)
    if quick:
        return BenchSpec(mixes=mixes,
                         sizes=quick_sizes(levels_of(device).levels),
                         reps=3, warmup=1, target_bytes=2e7, tags=("fig5",),
                         backend=backend)
    return BenchSpec(mixes=mixes,
                     sizes=hierarchy_grid(hi=64 * 2**20, per_decade=4),
                     reps=10, warmup=2, target_bytes=2e8, tags=("fig5",),
                     backend=backend)


def row_name(mix: str, nbytes: int) -> str:
    return f"fig5/{mix}/{nbytes}B"


def ratio_table(summary: dict) -> str:
    """Pivot ``BenchResult.summarize`` output into ratio rows x level
    columns of GB/s, with the per-level relative-to-best ratio alongside."""
    levels = list(summary)
    mixes: list[str] = []
    for cells in summary.values():
        mixes.extend(m for m in cells if m not in mixes)
    lines = [f"{'R:W':8s} " + " ".join(f"{lvl + ' GB/s':>12s} {'rel':>5s}"
                                       for lvl in levels)]
    for m in mixes:
        row = [f"{m.removeprefix('rw_').replace('to', ':'):8s}"]
        for lvl in levels:
            c = summary[lvl].get(m)
            row.append(f"{c['gbps']:12.2f} {c['rel']:5.2f}" if c else
                       f"{'-':>12s} {'-':>5s}")
        lines.append(" ".join(row))
    return "\n".join(lines)


def main(quick: bool = False, smoke: bool = False, backend: str = "cuda",
         device: str = "cuda"):
    runner = Runner(device=device)          # raises without a CUDA device
    res = runner.run(spec_for(quick, smoke, backend, runner.device))
    for p in res.points:
        emit(row_name(p.mix, p.nbytes), p.mean_s * 1e6, f"{p.gbps:.2f}GB/s")

    # one band in smoke mode (a single size can't attribute levels); the
    # device's hierarchy otherwise
    levels = None if smoke else levels_of(runner.device).levels
    summary = res.summarize(levels=levels)
    print()
    print(ratio_table(summary))

    if not smoke:
        ART.mkdir(parents=True, exist_ok=True)
        res.to_json(ART / "fig5_rw_ratio.json")
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="single tiny size, 3 ratios — the CI smoke gate")
    add_device_flags(ap)
    main(**vars(ap.parse_args()))
