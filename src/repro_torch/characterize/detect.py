"""Change-point / plateau detection over a measured GB/s-vs-size curve.

The paper reads cache sizes and per-level bandwidths off the throughput
curve by eye (§5-§6, 'fine spatial granularity'); this module does the same
inference mechanically, with NO sysfs or documentation input:

1. optimal piecewise-constant segmentation of log-bandwidth vs log-size
   (exact dynamic program, BIC-style penalty — the curve is a staircase:
   one plateau per hierarchy level, separated by capacity cliffs),
2. merge of adjacent segments whose plateau bandwidths are closer than the
   noise floor (``min_drop``) — a transition sample must not fake a level,
3. per-plateau bandwidth with a normal-approximation confidence interval,
   and per-boundary capacity with an interval bracketed by the last sample
   of one plateau and the first sample of the next (the *measured* bracket:
   exactly what adaptive refinement tightens).

Everything is plain numpy on (sizes, gbps) arrays; ``detect_from_result``
adapts a BenchResult.  The adaptive driver calls this every round and
bisects any ``Boundary`` whose bracket is wider than the target resolution.

Counterpart of ``repro.characterize.detect``: the same float64 numpy
arithmetic, so both packages detect the same levels from the same curve.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Boundary:
    """One capacity transition: bracketed by measured sizes lo < hi."""
    lo: int                  # last working-set size on the inner plateau
    hi: int                  # first working-set size on the outer plateau
    capacity: int            # point estimate: geometric mean of the bracket

    @property
    def width(self) -> float:
        """Relative bracket width (hi/lo - 1); the adaptive driver's
        convergence measure."""
        return self.hi / self.lo - 1.0

    def resolved(self, resolution: float) -> bool:
        return self.width <= resolution


@dataclass(frozen=True)
class DetectedLevel:
    """One inferred hierarchy level: a bandwidth plateau."""
    name: str
    capacity_bytes: Optional[int]            # None = outermost (unbounded)
    capacity_ci: Optional[tuple[int, int]]   # measured bracket (lo, hi)
    gbps: float                              # plateau mean
    gbps_ci: tuple[float, float]             # normal-approx CI on the mean
    n_points: int
    sizes: tuple[int, ...]                   # member working-set sizes


@dataclass
class Detection:
    """Full detection result for one mix's size sweep."""
    levels: list[DetectedLevel] = field(default_factory=list)
    boundaries: list[Boundary] = field(default_factory=list)
    mix: str = ""
    n_points: int = 0

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def unresolved(self, resolution: float) -> list[Boundary]:
        return [b for b in self.boundaries if not b.resolved(resolution)]

    def to_dict(self) -> dict:
        return {
            "mix": self.mix, "n_points": self.n_points,
            "levels": [{
                "name": l.name, "capacity_bytes": l.capacity_bytes,
                "capacity_ci": list(l.capacity_ci) if l.capacity_ci else None,
                "gbps": l.gbps, "gbps_ci": list(l.gbps_ci),
                "n_points": l.n_points, "sizes": list(l.sizes),
            } for l in self.levels],
            "boundaries": [{"lo": b.lo, "hi": b.hi, "capacity": b.capacity}
                           for b in self.boundaries],
        }


def _segment_dp(y: np.ndarray, max_segments: int, penalty: float
                ) -> list[tuple[int, int]]:
    """Exact minimum of sum of within-segment squared error + penalty per
    extra segment (Bellman DP, O(n^2 k) — sweeps are tens of points)."""
    n = len(y)
    pre = np.concatenate([[0.0], np.cumsum(y)])
    pre2 = np.concatenate([[0.0], np.cumsum(y * y)])

    def sse(i, j):          # cost of one segment y[i:j]
        s, s2, m = pre[j] - pre[i], pre2[j] - pre2[i], j - i
        return s2 - s * s / m

    kmax = min(max_segments, n)
    # cost[k][j] = best cost of y[:j] split into k+1 segments
    cost = np.full((kmax, n + 1), np.inf)
    back = np.zeros((kmax, n + 1), dtype=int)
    for j in range(1, n + 1):
        cost[0][j] = sse(0, j)
    for k in range(1, kmax):
        for j in range(k + 1, n + 1):
            cands = [cost[k - 1][i] + sse(i, j) for i in range(k, j)]
            best = int(np.argmin(cands))
            cost[k][j] = cands[best]
            back[k][j] = best + k
    # pick segment count by penalized cost
    totals = [cost[k][n] + penalty * k for k in range(kmax)]
    k = int(np.argmin(totals))
    # reconstruct
    bounds = [n]
    j = n
    for kk in range(k, 0, -1):
        j = back[kk][j]
        bounds.append(j)
    bounds.append(0)
    bounds = bounds[::-1]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def significant_step(m1: float, n1: int, m2: float, n2: int, *,
                     sigma: float, z: float = 3.0, min_drop: float = 0.12
                     ) -> bool:
    """The noise-aware two-sample test: is the gap between two log-scale
    means (``n1``/``n2`` samples each, common noise scale ``sigma``) a real
    step, or noise?

    The gap must clear BOTH the physical floor ``log(1+min_drop)`` (a
    smaller relative step does not count, however many samples agree on it)
    and the sampling bound ``z·σ·√(1/n₁+1/n₂)`` (few-sample means need a
    bigger gap).  Shared by the plateau merger below (a non-significant
    step between adjacent segments merges them) and the run ledger's
    regression gate (``obs.ledger.diff_records`` — a significant drop in a
    bandwidth cell is a regression), so the detector and the gate cannot
    disagree about what counts as noise.
    """
    thr = max(math.log(1.0 + min_drop),
              z * sigma * math.sqrt(1.0 / max(n1, 1) + 1.0 / max(n2, 1)))
    return abs(m1 - m2) >= thr


def _merge_segments(segs, y: np.ndarray, *, min_drop: float, sigma: float,
                    z: float = 3.0) -> list[tuple[int, int]]:
    """Iteratively merge adjacent segments the data can't tell apart.

    Two rules, applied closest-pair-first until a fixpoint (means are
    recomputed after every merge; callers pass the median-filtered series
    with the RAW noise sigma — see ``detect_levels``):

    * indistinguishable: |Δmean| fails ``significant_step`` — below both
      the physical floor (``log(1+min_drop)`` — a smaller step is noise,
      not a hierarchy level) and the two-sample noise bound
      ``z·σ·√(1/n₁+1/n₂)`` (short plateau fragments need a bigger gap to
      count as real),
    * non-physical: the OUTER segment is *faster* — bandwidth cannot rise
      with working-set size, so an upward step is measurement noise and the
      pair is one plateau.
    """
    segs = list(segs)

    def mean(seg):
        return float(np.mean(y[seg[0]:seg[1]]))

    while len(segs) > 1:
        best_i, best_d = None, None
        for i in range(len(segs) - 1):
            a, b = segs[i], segs[i + 1]
            m1, m2 = mean(a), mean(b)
            sig = significant_step(m1, a[1] - a[0], m2, b[1] - b[0],
                                   sigma=sigma, z=z, min_drop=min_drop)
            d = abs(m1 - m2)
            if (not sig or m2 > m1) and (best_d is None or d < best_d):
                best_i, best_d = i, d
        if best_i is None:
            break
        a, b = segs[best_i], segs[best_i + 1]
        segs[best_i:best_i + 2] = [(a[0], b[1])]
    return segs


def _noise_sigma(y: np.ndarray) -> float:
    """Robust noise scale from first differences (MAD estimator) — plateau
    interiors are flat, so diffs are ~noise except at the few cliffs, which
    the median ignores."""
    if len(y) < 3:
        return 0.05
    d = np.abs(np.diff(y))
    sigma = 1.4826 * float(np.median(d)) / math.sqrt(2.0)
    return max(sigma, 1e-3)


def detect_levels(sizes: Sequence[int], gbps: Sequence[float], *,
                  max_levels: int = 6, min_drop: float = 0.12,
                  z: float = 1.96, mix: str = "") -> Detection:
    """Infer hierarchy levels from a (working-set size, throughput) sweep.

    ``min_drop``: smallest relative bandwidth step that counts as a level
    transition (smaller steps are merged — measurement noise, not topology).
    ``z``: normal quantile for the plateau-bandwidth CI (1.96 = 95%).
    """
    if len(sizes) != len(gbps) or len(sizes) == 0:
        raise ValueError("sizes and gbps must be equal-length, non-empty")
    order = np.argsort(np.asarray(sizes))
    s = np.asarray(sizes, dtype=np.int64)[order]
    g = np.asarray(gbps, dtype=np.float64)[order]
    if np.any(g <= 0):
        raise ValueError("gbps must be positive (a 0.0 point is a failed "
                         "measurement, not a plateau)")
    n = len(s)
    y = np.log(g)

    # light median filter: a lone mid-transition sample joins a neighbor
    # plateau instead of becoming a one-point segment
    ys = y.copy()
    if n >= 5:
        for i in range(1, n - 1):
            ys[i] = np.median(y[i - 1:i + 2])

    # two noise scales: the RAW sigma calibrates the merge threshold (what a
    # real plateau gap must exceed), the FILTERED sigma the DP penalty (the
    # DP runs on the filtered series) — using the filtered sigma for both
    # under-estimates noise and lets 2-point noise excursions survive as
    # fake levels (measured: 7/60 wrong level counts vs 0/60 at 6% noise)
    sigma_raw = _noise_sigma(y)
    sigma_f = _noise_sigma(ys)
    penalty = max(2.0 * sigma_f * sigma_f * math.log(max(n, 2)),
                  0.25 * math.log(1.0 + min_drop) ** 2)
    segs = _segment_dp(ys, max_segments=max_levels + 2, penalty=penalty)

    merged = _merge_segments(segs, ys, min_drop=min_drop, sigma=sigma_raw)

    det = Detection(mix=mix, n_points=n)
    for li, (a, b) in enumerate(merged):
        pts = g[a:b]
        mean = float(np.mean(pts))
        if len(pts) > 1:
            half = z * float(np.std(pts, ddof=1)) / math.sqrt(len(pts))
        else:
            half = min_drop * mean      # single sample: noise-floor interval
        last = li == len(merged) - 1
        cap_ci = (int(s[b - 1]), int(s[b])) if not last else None
        cap = (int(round(math.sqrt(cap_ci[0] * cap_ci[1])))
               if cap_ci else None)
        det.levels.append(DetectedLevel(
            name="DRAM" if last else f"L{li + 1}",
            capacity_bytes=cap, capacity_ci=cap_ci,
            gbps=mean, gbps_ci=(mean - half, mean + half),
            n_points=len(pts), sizes=tuple(int(x) for x in s[a:b])))
        if not last:
            det.boundaries.append(Boundary(lo=cap_ci[0], hi=cap_ci[1],
                                           capacity=cap))
    return det


def detect_from_result(res, mix: str | None = None, **kw) -> Detection:
    """Run detection over one mix's points of a BenchResult (duck-typed:
    anything with ``.points`` carrying ``.mix``/``.nbytes``/``.gbps``)."""
    mixes = []
    for p in res.points:
        if p.mix not in mixes:
            mixes.append(p.mix)
    if mix is None:
        if not mixes:
            raise ValueError("result has no points")
        mix = mixes[0]
    pts = {}
    for p in res.points:
        if p.mix == mix:
            pts.setdefault(p.nbytes, []).append(p.gbps)
    if not pts:
        raise ValueError(f"no points for mix {mix!r} (have: {mixes})")
    sizes = sorted(pts)
    gbps = [float(np.mean(pts[s])) for s in sizes]
    return detect_levels(sizes, gbps, mix=mix, **kw)
