"""Sweep analysis — the reasoning in the paper's §6, automated.

* level attribution: mean throughput inside each hierarchy level's working-set
  band (paper: 'cumulative mean over one hundred repetitions' per level)
* mix penalty: throughput of each mix relative to the best at that level — the
  FADD-vs-LOAD-vs-NOP gap that exposes front-end/issue bottlenecks (§6.1-6.3)
* knee/ridge detection: the smallest fma depth k where throughput drops below
  90% of the pure-load mix — the measured ridge point of the machine

Counterpart of ``repro.core.analysis``.
"""
from __future__ import annotations

from typing import Union

import numpy as np

from repro_torch.bench.result import BenchResult, level_band  # noqa: F401
#   (band formula lives with the summarize view; re-exported here)
from repro_torch.core.machine_model import HardwareSpec, MachineModel
from repro_torch.core.sweep import SweepResult

#: Both result schemas expose .points (.mix/.nbytes/.gbps), .by_mix and .meta;
#: BenchResult is the versioned schema, SweepResult the legacy one.
Result = Union[BenchResult, SweepResult]


def attribute_levels(res: Result, hw: HardwareSpec) -> dict:
    """level -> {mix: mean GB/s within the level's band}.

    Thin view over ``BenchResult.summarize`` (where the banding lives);
    duck-typed so the legacy SweepResult works too, since summarize only
    reads ``.points``.
    """
    summary = BenchResult.summarize(res, levels=hw.levels)
    return {lvl: {m: c["gbps"] for m, c in mixes.items()}
            for lvl, mixes in summary.items()}


def mix_penalties(level_bw: dict) -> dict:
    """Per level: each mix's throughput relative to the best mix — the paper's
    instruction-mix gap (e.g. A64FX L1d: FADD 69% vs LOAD 99%)."""
    out = {}
    for lvl, mixes in level_bw.items():
        best = max(mixes.values())
        out[lvl] = {m: v / best for m, v in mixes.items()}
    return out


def ridge_depth(res: Result, band: tuple[float, float],
                threshold: float = 0.9) -> int | None:
    """Smallest fma-chain depth whose throughput < threshold x load_sum —
    the measured compute/bandwidth crossover inside the given size band."""
    lo, hi = band

    def mean_bw(mix):
        pts = [p.gbps for p in res.by_mix(mix) if lo <= p.nbytes <= hi]
        return float(np.mean(pts)) if pts else None

    base = mean_bw("load_sum")
    if not base:
        return None
    depths = sorted(int(p.mix.split("_")[1]) for p in res.points
                    if p.mix.startswith("fma_"))
    for k in depths:
        bw = mean_bw(f"fma_{k}")
        if bw is not None and bw < threshold * base:
            return k
    return None


def build_machine_model(res: Result, hw: HardwareSpec) -> MachineModel:
    """Thin wrapper over ``repro_torch.characterize.fit`` in
    *documented-banding* mode: per-mix bandwidths attributed inside ``hw``'s
    level bands, ridge measured in the innermost band.  For
    measurement-*detected* topology (no ``hw`` input at all), use
    ``repro_torch.characterize.characterize`` / ``fit_from_result`` directly
    — they return the richer ``FittedMachineModel`` this legacy schema
    downgrades from."""
    from repro_torch.characterize.fit import fit_from_result
    model = fit_from_result(res, hw=hw, name=hw.name).to_machine_model()
    # legacy contract: hardware carries the DOCUMENTED levels verbatim
    # (sizes + documented read_bw), not the measured-bandwidth view
    model.hardware = {"name": hw.name,
                      "levels": tuple((l.name, l.size_bytes, l.read_bw)
                                      for l in hw.levels)}
    return model


def format_table(level_bw: dict, pen: dict) -> str:
    lines = [f"{'level':8s} {'mix':10s} {'GB/s':>10s} {'rel':>6s}"]
    for lvl, mixes in level_bw.items():
        for m, v in sorted(mixes.items()):
            lines.append(f"{lvl:8s} {m:10s} {v:10.2f} {pen[lvl][m]:6.2f}")
    return "\n".join(lines)
