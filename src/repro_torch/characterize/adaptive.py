"""Adaptive fine-granularity sweep — the paper's resolution at a fraction
of the samples.

A dense grid fine enough to localize a cache boundary to ±10% needs
``log(hi/lo)/log(1.1)`` points across the whole span; almost all of them
land mid-plateau where they add nothing.  This driver starts from a coarse
log-spaced grid (``core.buffers.size_grid``), runs change-point detection
(``characterize.detect``), and each round measures ONLY geometric
midpoints inside still-unresolved boundary brackets — classic bisection, so
every round halves each bracket and convergence takes
``O(log(coarse_gap / resolution))`` rounds.

One ``bench.Runner`` lives across all rounds: its case cache means a mix
re-measured at an already-built shape re-times without re-building, and
candidate sizes are snapped to real working-set tiles
(``buffers.snap_sizes``) so the driver never re-times a size it already has
— a bracket that cannot produce a new snapped size is resolution-floored
and counts as converged.

Counterpart of ``repro.characterize.adaptive``; the backends are this
package's (``torch`` for the reference's ``xla``, ``cuda`` for ``pallas``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.characterize.detect import Detection, detect_levels

DEFAULT_RESOLUTION = 0.10       # relative boundary-bracket width target


@dataclass
class AdaptiveSweep:
    """Everything one adaptive characterization run measured and inferred."""
    result: object                  # merged BenchResult (all rounds)
    detection: Detection            # detection over the final point set
    rounds: int = 0
    resolution: float = DEFAULT_RESOLUTION
    history: list[dict] = field(default_factory=list)   # per-round summary

    @property
    def n_points(self) -> int:
        return len({p.nbytes for p in self.result.points})

    @property
    def converged(self) -> bool:
        return not self.detection.unresolved(self.resolution) or \
            bool(self.history and self.history[-1].get("floored"))

    def dense_equivalent(self, lo: int | None = None, hi: int | None = None
                         ) -> int:
        """Points a fixed grid would need for the same boundary resolution
        across [lo, hi] (the sample-count baseline the paper's fine
        granularity implies)."""
        sizes = sorted({p.nbytes for p in self.result.points})
        lo = lo or sizes[0]
        hi = hi or sizes[-1]
        return int(math.ceil(math.log(hi / lo)
                             / math.log(1.0 + self.resolution))) + 1

    def summary(self) -> dict:
        return {
            "rounds": self.rounds,
            "n_points": self.n_points,
            "dense_equivalent": self.dense_equivalent(),
            "resolution": self.resolution,
            "converged": self.converged,
            "n_levels": self.detection.n_levels,
            "history": self.history,
        }


def _bisection_candidates(detection: Detection, resolution: float,
                          measured: set[int], dtype) -> list[int]:
    """Geometric midpoints of every unresolved bracket, snapped to real
    working-set sizes and deduped against what's already measured."""
    from repro_torch.core import buffers
    cands: list[int] = []
    for b in detection.unresolved(resolution):
        mid = int(round(math.sqrt(float(b.lo) * float(b.hi))))
        for c in buffers.snap_sizes([mid], dtype=dtype):
            if c not in measured and b.lo < c < b.hi:
                cands.append(c)
    return sorted(set(cands))


def adaptive_sweep(mix: str = "load_sum", *, runner=None,
                   backend: str = "torch",
                   lo: int | None = None, hi: int | None = None,
                   coarse_per_decade: int = 3,
                   resolution: float = DEFAULT_RESOLUTION,
                   max_rounds: int = 8, reps: int = 5, warmup: int = 1,
                   target_bytes: float = 5e7, dtype: str = "float32",
                   spec_kw: dict | None = None, detect_kw: dict | None = None
                   ) -> AdaptiveSweep:
    """Run the adaptive refinement loop for one instruction mix.

    ``runner`` is duck-typed (needs ``.run(BenchSpec) -> BenchResult``); the
    tests inject a synthetic-curve runner, production passes a
    ``bench.Runner`` (or None for a fresh one on the default device,
    ``cuda``, kept for all rounds so the case cache spans them).
    """
    from repro_torch.bench import BenchSpec, Runner
    from repro_torch.core import buffers
    from repro_torch.obs import metrics, trace

    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1: {max_rounds} "
                         f"(round 1 is the coarse grid)")
    lo = lo or buffers.HIERARCHY_SPAN[0]
    hi = hi or buffers.HIERARCHY_SPAN[1]
    runner = runner or Runner()
    detect_kw = dict(detect_kw or {})
    base = BenchSpec(mixes=(mix,), sizes=(lo,), backend=backend, dtype=dtype,
                     reps=reps, warmup=warmup, target_bytes=target_bytes,
                     **(spec_kw or {}))

    tdtype = buffers.as_dtype(dtype)
    sizes = buffers.size_grid(lo, hi, per_decade=coarse_per_decade,
                              dtype=tdtype)
    merged = None
    measured: set[int] = set()
    history: list[dict] = []
    detection = None
    rounds = 0
    tr = trace.get_tracer()
    while rounds < max_rounds:
        new = [s for s in sizes if s not in measured]
        if not new:
            break
        with tr.span("characterize.round", cat="characterize",
                     round=rounds + 1, mix=mix, new_points=len(new)):
            metrics.REGISTRY.inc("adaptive_rounds")
            res = runner.run(base.replace(sizes=tuple(new)))
            measured.update(p.nbytes for p in res.points)
            if merged is None:
                merged = res
            else:
                merged.points.extend(res.points)
                merged.meta["sizes"] = sorted({*merged.meta.get("sizes", []),
                                               *res.meta.get("sizes", [])})
            rounds += 1
            detection = detect_levels(
                sorted(measured),
                [_mean_gbps(merged, mix, s) for s in sorted(measured)],
                mix=mix, **detect_kw)
            unresolved = detection.unresolved(resolution)
            sizes = _bisection_candidates(detection, resolution, measured,
                                          tdtype)
            floored = bool(unresolved) and not sizes
            tr.event("characterize.bisect", cat="characterize",
                     round=rounds, n_levels=detection.n_levels,
                     brackets=[[b.lo, b.hi] for b in unresolved],
                     candidates=sizes, floored=floored)
        history.append({
            "round": rounds, "new_points": len(new),
            "n_levels": detection.n_levels,
            "unresolved": len(unresolved),
            "brackets": [[b.lo, b.hi] for b in unresolved],
            "floored": floored,     # bracket narrower than one buffer tile
        })
        if not unresolved or floored:
            break
    merged.meta["characterize"] = {"mix": mix, "rounds": rounds,
                                   "resolution": resolution,
                                   "span": [lo, hi],
                                   "coarse_per_decade": coarse_per_decade}
    return AdaptiveSweep(result=merged, detection=detection, rounds=rounds,
                         resolution=resolution, history=history)


def _mean_gbps(res, mix: str, nbytes: int) -> float:
    pts = [p.gbps for p in res.points if p.mix == mix and p.nbytes == nbytes]
    return float(sum(pts) / len(pts))
