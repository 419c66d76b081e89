"""Loaded-latency surfaces — Mess-style bandwidth–latency curve fits.

Counterpart of ``repro.characterize.loaded``.  The ``latency_chase`` mix
measures per-step dependent-load latency and the spec's ``load`` axis adds
bandwidth-generator streams to the probe.  Sweeping ``load`` at a fixed
working-set size traces one bandwidth–latency curve — the Mess benchmark's
view of a memory level: latency sits on an idle plateau until the generators
approach the level's sustainable bandwidth, then takes off.

* ``loaded_latency_sweep`` — drive the Runner over (sizes x loads); one spec
  per load level (``load`` is a spec knob and a case-cache key), merged by
  ``run_many`` into one result.
* ``fit_knee`` — one curve's knee: the last load level whose latency stays
  within ``factor`` of the idle latency, and the generator bandwidth there.
* ``fit_loaded`` — per-hierarchy-level knee fits in ``summarize`` band
  discipline.

The single-device backends of this package (torch, cuda) run the composite
time-shared (each probe pass followed by the generator sweeps,
``kernels.membench.ops``), so latency at ``load`` > 0 includes the
generators' time by construction; the mesh backends (sharded, distributed)
run the probe on shard 0 and each generator on its own sibling shard.
"""
from __future__ import annotations

import math


def loaded_latency_sweep(sizes, loads=(0, 1, 2, 4), *, backend: str = "torch",
                         runner=None, reps: int = 5, warmup: int = 1,
                         dtype: str = "float32", spec_kw: dict | None = None):
    """Measure ``latency_chase`` at every (size, load) point.

    ``load`` lives on the spec, so each load level is its own ``BenchSpec``;
    ``Runner.run_many`` merges them into one result whose points carry the
    curve coordinates (``load`` / ``latency_ns`` / ``gen_gbps``).  The
    single-device backends (torch / cuda) run the generators time-shared;
    on ``sharded`` the composite is spatial but ``devices == load + 1`` is
    required per spec, so sweep loads there by calling this once per load
    with ``spec_kw={"devices": load + 1}``.
    ``runner=None`` makes a ``Runner()`` on the default device (``cuda``)."""
    from repro_torch.bench import BenchSpec, Runner
    runner = runner or Runner()
    spec_kw = dict(spec_kw or {})
    specs = [BenchSpec(mixes=("latency_chase",), sizes=tuple(sizes),
                       backend=backend, dtype=dtype, reps=reps,
                       warmup=warmup, load=load, **spec_kw)
             for load in loads]
    res = runner.run_many(specs)
    res.meta["loaded_latency"] = {"loads": list(loads), "backend": backend}
    return res


def _curve(points) -> dict:
    """load -> (mean latency_ns, mean gen_gbps) over the chase points."""
    by_load: dict[int, dict] = {}
    for p in points:
        if getattr(p, "latency_ns", None) is None:
            continue
        cell = by_load.setdefault(p.load, {"lat": 0.0, "gen": 0.0, "n": 0})
        cell["lat"] += p.latency_ns
        cell["gen"] += p.gen_gbps or 0.0
        cell["n"] += 1
    return {load: (c["lat"] / c["n"], c["gen"] / c["n"])
            for load, c in sorted(by_load.items())}


def fit_knee(points, factor: float = 1.5) -> dict | None:
    """Fit one bandwidth–latency curve's knee from its chase points.

    The knee is the LAST load level whose mean latency stays within
    ``factor`` x the idle (lowest-load) latency; ``knee_gen_gbps`` is the
    aggregate generator bandwidth there (0.0 when the knee is the idle point
    itself).  Points at the same load are averaged (multiple sizes / reps).
    Returns None when fewer than two load levels are present.
    """
    curve = _curve(points)
    if len(curve) < 2:
        return None
    loads = list(curve)
    lats = [curve[load][0] for load in loads]
    gens = [curve[load][1] for load in loads]
    idle = lats[0]
    knee_i = max((i for i, lat in enumerate(lats)
                  if lat <= factor * idle), default=0)
    return {"factor": factor,
            "idle_latency_ns": idle,
            "max_latency_ns": max(lats),
            "knee_load": loads[knee_i],
            "knee_gen_gbps": gens[knee_i],
            "loads": loads,
            "latency_ns": lats,
            "gen_gbps": gens}


def fit_loaded(result, levels=None, factor: float = 1.5,
               min_band_bytes: int = 4 * 2**10) -> dict | None:
    """Per-hierarchy-level knee fits over a loaded-latency sweep result.

    ``levels`` follows ``BenchResult.summarize``: an ordered sequence
    (innermost first) of ``(name, size_bytes)`` pairs or objects with
    ``.name`` / ``.size_bytes`` (``None`` size = unbounded); omitted means
    one ``"all"`` level.  Each level's knee is fitted from the chase points
    inside its attribution band (``result.level_band``).

    Returns ``{"factor": ..., "levels": {name: knee_dict}}``, or None when
    no level has a fittable curve.  All-finite floats: JSON-safe by
    construction (band edges use None for unbounded).
    """
    from repro_torch.bench.result import level_band
    chase = [p for p in result.points
             if getattr(p, "latency_ns", None) is not None]
    if levels is None:
        levels = (("all", None),)
    out: dict[str, dict] = {}
    prev = min_band_bytes / 2.0
    for lvl in levels:
        name, size = (lvl if isinstance(lvl, (tuple, list))
                      else (lvl.name, lvl.size_bytes))
        lo, hi = level_band(size, prev)
        knee = fit_knee([p for p in chase if lo <= p.nbytes <= hi],
                        factor=factor)
        if knee is not None:
            knee["band"] = [lo, None if math.isinf(hi) else hi]
            out[name] = knee
        if size:
            prev = size
    return {"factor": factor, "levels": out} if out else None
