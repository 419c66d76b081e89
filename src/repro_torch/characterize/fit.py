"""FittedMachineModel — the measurement-derived machine model.

The paper's deliverable is not a curve but a *characterization*: how many
levels, how big, how fast under each instruction mix, where the measured
numbers disagree with the documentation (Table 1).  This module assembles
that from detection output:

* ``fit_from_result`` — BenchResult (+ Detection, or documented/prior
  ``HardwareSpec`` levels) -> ``FittedMachineModel``: per-level per-mix
  bandwidths, mix penalties, measured ridge point, all schema-versioned.
* ``characterize`` — the full pipeline: adaptive sweep on a primary mix,
  secondary mixes probed only at plateau-interior sizes (one of the sample
  savings: topology is found once, mixes ride on it), sysfs prior
  cross-check, fit.
* The fitted model registers into the ``core.machine_model`` spec registry
  (``model.register()``) and is accepted by ``core.autotune`` (as the
  capacity that bounds block candidates) in place of the static tables.

Counterpart of ``repro.characterize.fit``: the same schema, so a fitted
model's JSON loads in either package.  The prior differs where the machine
does: a sweep measured on a CUDA device is cross-checked against
``detect_device`` (the card's L2 and memory sizes), not the host's sysfs.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from repro_torch.characterize.adaptive import AdaptiveSweep, adaptive_sweep
from repro_torch.characterize.detect import Detection, detect_from_result
from repro_torch.core.machine_model import (HardwareSpec, MachineModel,
                                            MemLevel, detect_device,
                                            detect_host, register_spec)

# schema history: 1 = levels/penalties/ridge/prior/provenance; 2 = optional
# ``issue`` dict — the fitted instruction-issue model (``rate_elems_per_s``
# + fit provenance) that the reference's ``istream`` classifies against; 3 =
# optional
# ``loaded_latency`` dict — per-level bandwidth–latency knee fits from a
# loaded-latency sweep (``characterize.loaded.fit_loaded``).  Older files
# load unchanged (the optional fields stay None).
FITTED_SCHEMA_VERSION = 3


@dataclass(frozen=True)
class LevelFit:
    """One hierarchy level with everything measured about it."""
    name: str
    capacity_bytes: Optional[int]             # None = unbounded / outermost
    capacity_ci: Optional[tuple[int, int]]    # measured bracket; None if
    #   capacity came from a documented table rather than detection
    bandwidth: dict = field(default_factory=dict)
    #   mix -> {"gbps": float, "ci": (lo, hi) | None, "n": int}

    @property
    def best_gbps(self) -> float:
        return max((c["gbps"] for c in self.bandwidth.values()), default=0.0)

    @property
    def best_mix(self) -> Optional[str]:
        if not self.bandwidth:
            return None
        return max(self.bandwidth, key=lambda m: self.bandwidth[m]["gbps"])


@dataclass
class FittedMachineModel:
    """Schema-versioned, JSON-round-trippable fitted model of one machine."""
    name: str = "host-cpu-fitted"
    levels: tuple[LevelFit, ...] = ()
    ridge_flops_per_byte: Optional[float] = None
    mix_penalty: dict = field(default_factory=dict)   # level -> {mix: rel}
    sysfs_prior: Optional[dict] = None    # {"levels": [...], "crosscheck": [..]}
    provenance: dict = field(default_factory=dict)    # sweep economics + meta
    issue: Optional[dict] = None    # schema v2: fitted issue model —
    #   {"rate_elems_per_s": float, ...fit provenance}; the reference's
    #   istream both fits it (fit_issue_rate) and classifies against it
    loaded_latency: Optional[dict] = None   # schema v3: per-level
    #   bandwidth–latency knee fits — {"factor", "levels": {name:
    #   {"idle_latency_ns", "knee_load", "knee_gen_gbps", ...curve}}}
    #   from characterize.loaded.fit_loaded over a latency_chase sweep
    schema_version: int = FITTED_SCHEMA_VERSION

    def __post_init__(self):
        self.levels = tuple(
            l if isinstance(l, LevelFit) else LevelFit(
                name=l["name"], capacity_bytes=l["capacity_bytes"],
                capacity_ci=(tuple(l["capacity_ci"])
                             if l.get("capacity_ci") else None),
                bandwidth={m: {**c, "ci": tuple(c["ci"]) if c.get("ci")
                               else None}
                           for m, c in l.get("bandwidth", {}).items()})
            for l in self.levels)

    # -- consumers ----------------------------------------------------------
    @property
    def peak_flops(self) -> Optional[float]:
        """Measured models carry no documented FLOP peak (None convention)."""
        return self.provenance.get("peak_flops")

    @property
    def hbm_bw(self) -> Optional[float]:
        """Outermost-level best measured bandwidth in B/s — the roofline's
        memory-term denominator."""
        if not self.levels:
            return None
        bw = self.levels[-1].best_gbps
        return bw * 1e9 if bw else None

    @property
    def innermost_capacity(self) -> Optional[int]:
        """Detected capacity of the innermost level — what the autotuner
        sizes blocks against."""
        for l in self.levels:
            if l.capacity_bytes:
                return l.capacity_bytes
        return None

    @property
    def issue_rate(self) -> Optional[float]:
        """Fitted sustained issue rate (element-ops/s, schema v2) — the
        ECM predictor's in-core term denominator."""
        return (self.issue or {}).get("rate_elems_per_s")

    def level_path(self, nbytes: int) -> list[LevelFit]:
        """Hierarchy prefix a working set of ``nbytes`` streams through:
        innermost level up to (and including) its residence level — the
        first level whose measured capacity holds it, else the outermost.
        The ECM predictor sums per-level transfer times over this path."""
        path: list[LevelFit] = []
        for l in self.levels:
            path.append(l)
            if l.capacity_bytes and nbytes <= l.capacity_bytes:
                break
        return path

    def bandwidth_for(self, level: LevelFit, mix: str | None = None
                      ) -> Optional[float]:
        """Measured bandwidth of ``level`` in B/s — the mix's own cell when
        measured there, else the level's best mix (penalties are already a
        separate field; the ECM consumer wants an absolute number)."""
        cell = level.bandwidth.get(mix) if mix else None
        gbps = cell["gbps"] if cell else level.best_gbps
        return gbps * 1e9 if gbps else None

    def to_hardware_spec(self) -> HardwareSpec:
        """Detected topology as a HardwareSpec (measured best-mix bandwidth
        in the ``read_bw`` slot, B/s) — drop-in for the static tables."""
        return HardwareSpec(
            name=self.name, peak_flops=self.peak_flops,
            levels=tuple(MemLevel(l.name, l.capacity_bytes,
                                  l.best_gbps * 1e9 if l.bandwidth else None)
                         for l in self.levels),
            notes="measured by repro_torch.characterize")

    def to_machine_model(self) -> MachineModel:
        """Downgrade to the legacy MachineModel shape consumed by
        ``core.analysis`` callers and the table1 benchmark."""
        return MachineModel(
            hardware={"name": self.name,
                      "levels": [(l.name, l.capacity_bytes,
                                  l.best_gbps * 1e9 if l.bandwidth else None)
                                 for l in self.levels]},
            level_bw={l.name: {m: c["gbps"] for m, c in l.bandwidth.items()}
                      for l in self.levels if l.bandwidth},
            ridge_flops_per_byte=self.ridge_flops_per_byte,
            mix_penalty=self.mix_penalty)

    def register(self, overwrite: bool = True) -> HardwareSpec:
        """Publish the detected topology into the machine_model registry so
        ``get_spec(self.name)`` resolves to measurement, like the tables."""
        return register_spec(self.to_hardware_spec(), overwrite=overwrite)

    # -- measured vs documented (the paper's Table-1 deltas) ---------------
    def compare_to(self, documented: HardwareSpec) -> dict:
        """Per-level measured-vs-documented report: capacity and bandwidth
        deltas, level-count mismatch, prior containment."""
        rows = []
        for i in range(max(len(self.levels), len(documented.levels))):
            det = self.levels[i] if i < len(self.levels) else None
            doc = documented.levels[i] if i < len(documented.levels) else None
            row = {"detected": det.name if det else None,
                   "documented": doc.name if doc else None}
            if det and doc:
                if det.capacity_bytes and doc.size_bytes:
                    row["capacity_bytes"] = det.capacity_bytes
                    row["documented_bytes"] = doc.size_bytes
                    row["capacity_ratio"] = det.capacity_bytes / doc.size_bytes
                    row["capacity_within_ci"] = (
                        det.capacity_ci is not None
                        and det.capacity_ci[0] <= doc.size_bytes
                        <= det.capacity_ci[1])
                if det.bandwidth and doc.read_bw:
                    row["gbps"] = det.best_gbps
                    row["documented_gbps"] = doc.read_bw / 1e9
                    row["bw_ratio"] = det.best_gbps / (doc.read_bw / 1e9)
            rows.append(row)
        return {"name": self.name, "documented_name": documented.name,
                "n_detected": len(self.levels),
                "n_documented": len(documented.levels),
                "levels": rows}

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "name": self.name,
            "levels": [{
                "name": l.name, "capacity_bytes": l.capacity_bytes,
                "capacity_ci": list(l.capacity_ci) if l.capacity_ci else None,
                "bandwidth": {m: {"gbps": c["gbps"],
                                  "ci": list(c["ci"]) if c.get("ci") else None,
                                  "n": c.get("n", 0)}
                              for m, c in l.bandwidth.items()},
            } for l in self.levels],
            "ridge_flops_per_byte": self.ridge_flops_per_byte,
            "mix_penalty": self.mix_penalty,
            "sysfs_prior": self.sysfs_prior,
            "provenance": self.provenance,
            "issue": self.issue,
            "loaded_latency": self.loaded_latency,
        }

    def to_json(self, path: str | Path | None = None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            Path(path).write_text(s)
        return s

    @classmethod
    def from_dict(cls, d: dict) -> "FittedMachineModel":
        d = dict(d)
        ver = d.pop("schema_version", FITTED_SCHEMA_VERSION)
        if ver > FITTED_SCHEMA_VERSION:
            raise ValueError(f"fitted-model schema {ver} newer than "
                             f"supported {FITTED_SCHEMA_VERSION}")
        return cls(**d, schema_version=ver)

    @classmethod
    def from_json(cls, src: str | Path) -> "FittedMachineModel":
        return cls.from_dict(json.loads(Path(src).read_text()))


# --------------------------------------------------------------------------
# fitting
# --------------------------------------------------------------------------

def _band_cells(res, levels) -> dict:
    """{level: {mix: {"gbps", "n", "ci"}}} via BenchResult.summarize bands
    (unbound call: duck-typed for legacy SweepResult, like core.analysis)."""
    from repro_torch.bench.result import BenchResult
    summary = BenchResult.summarize(res, levels=levels)
    out = {}
    for lvl, mixes in summary.items():
        out[lvl] = {m: {"gbps": c["gbps"], "n": c["n"], "ci": None}
                    for m, c in mixes.items()}
    return out


def _ridge(res, band) -> Optional[float]:
    from repro_torch.core.analysis import ridge_depth
    if not hasattr(res, "by_mix"):     # bare point container (tests inject
        from repro_torch.bench.result import BenchResult   # synthetic runners)
        shim = BenchResult(points=list(res.points))
        shim.meta = dict(getattr(res, "meta", {}) or {})
        res = shim
    k = ridge_depth(res, band)
    if k is None:
        return None
    itemsize = 4
    meta_dtype = res.meta.get("dtype", "float32") if hasattr(res, "meta") \
        else "float32"
    if isinstance(meta_dtype, str) and meta_dtype in ("bfloat16", "float16"):
        itemsize = 2
    return 2.0 * k / itemsize


def fit_from_result(res, detection: Detection | None = None,
                    hw: HardwareSpec | None = None, mix: str | None = None,
                    name: str | None = None) -> FittedMachineModel:
    """Fit a model from a finished sweep.

    Two modes:
    * ``hw`` given — *prior/documented banding*: per-mix bandwidths are
      attributed inside ``hw``'s level bands (the legacy
      ``core.analysis.build_machine_model`` path, now a wrapper over this).
      Capacities are the documented ones; no detection CI.
    * ``hw`` omitted — *detected banding*: levels come from change-point
      detection over the primary mix's curve (``detection`` if supplied,
      else run here); capacities carry measured brackets.
    """
    from repro_torch.bench.result import level_band

    if hw is not None:
        levels_src = [(l.name, l.size_bytes, None, None) for l in hw.levels]
        band_levels = hw.levels
        name = name or f"{hw.name}-fitted"
        detection_dict = None
    else:
        if detection is None:
            detection = detect_from_result(res, mix=mix)
        levels_src = [(l.name, l.capacity_bytes, l.capacity_ci, l.gbps_ci)
                      for l in detection.levels]
        band_levels = [(l.name, l.capacity_bytes) for l in detection.levels]
        name = name or "host-cpu-fitted"
        detection_dict = detection.to_dict()

    cells = _band_cells(res, band_levels)
    if detection is not None and hw is None:
        for l in detection.levels:
            cell = cells.get(l.name, {}).get(detection.mix)
            if cell is not None:
                # detection CI on the primary mix's plateau mean rides along
                cell["ci"] = l.gbps_ci
            else:
                # band attribution can come up empty for a level whose
                # detected capacity is below 2x the smallest measured size
                # (band hi = 0.5 cap < grid lo) — the detection plateau
                # stats ARE that level's primary-mix measurement, keep them
                cells.setdefault(l.name, {})[detection.mix] = {
                    "gbps": l.gbps, "n": l.n_points, "ci": l.gbps_ci}

    fits = []
    for lname, cap, cap_ci, _gci in levels_src:
        fits.append(LevelFit(name=lname, capacity_bytes=cap,
                             capacity_ci=cap_ci,
                             bandwidth=cells.get(lname, {})))

    penalty = {lvl: {m: c["gbps"] / best for m, c in mixes.items()}
               for lvl, mixes in cells.items()
               if (best := max(cc["gbps"] for cc in mixes.values()))}

    # ridge measured in the innermost level band (cache-resident)
    first_cap = next((cap for _, cap, _, _ in levels_src if cap), None)
    ridge = _ridge(res, level_band(first_cap, 2 * 2**10)) \
        if first_cap or levels_src else None

    # the schema's name, shared with the reference package's fitted models
    prov = {"schema": "repro.characterize", "source_points": len(res.points)}
    if hasattr(res, "meta") and isinstance(getattr(res, "meta", None), dict):
        prov["sweep_meta"] = {k: res.meta[k] for k in
                              ("mixes", "dtype", "characterize")
                              if k in res.meta}
    if detection_dict:
        prov["detection"] = detection_dict
    return FittedMachineModel(name=name, levels=tuple(fits),
                              ridge_flops_per_byte=ridge,
                              mix_penalty=penalty, provenance=prov)


def crosscheck_prior(detection: Detection, prior: HardwareSpec) -> dict:
    """sysfs topology vs detected boundaries: for each prior cache size,
    is it inside a measured boundary bracket (and how far off otherwise)?"""
    checks = []
    brackets = [(b.lo, b.hi, b.capacity) for b in detection.boundaries]
    for lvl in prior.levels:
        if not lvl.size_bytes:
            continue
        hit = next(((lo, hi, cap) for lo, hi, cap in brackets
                    if lo <= lvl.size_bytes <= hi), None)
        if hit:
            checks.append({"prior": lvl.name, "size_bytes": lvl.size_bytes,
                           "within_bracket": True, "bracket": [hit[0], hit[1]]})
        else:
            nearest = min((cap for _, _, cap in brackets), default=None,
                          key=lambda c: abs(math.log(c / lvl.size_bytes))
                          if c else math.inf)
            checks.append({"prior": lvl.name, "size_bytes": lvl.size_bytes,
                           "within_bracket": False,
                           "nearest_detected": nearest,
                           "ratio": (nearest / lvl.size_bytes)
                           if nearest else None})
    return {"prior_name": prior.name, "notes": prior.notes, "checks": checks}


def probe_sizes(detection: Detection) -> list[int]:
    """One size per detected level for secondary mixes, picked inside the
    level's *attribution band* (``result.level_band``: 2x previous capacity
    to 0.5x own capacity) so ``summarize`` credits it — already-measured
    sizes, so the Runner's compiled-case cache turns these into re-times."""
    from repro_torch.bench.result import level_band
    out = []
    prev = 2.0 * 2**10          # summarize's default min_band_bytes / 2
    for l in detection.levels:
        lo, hi = level_band(l.capacity_bytes, prev)
        if l.capacity_bytes:
            prev = l.capacity_bytes
        if not l.sizes:
            continue
        center = math.sqrt(lo * hi) if math.isfinite(hi) else 2.0 * lo
        inside = [s for s in l.sizes if lo <= s <= hi]
        if not inside:
            # no measured size falls in this level's band (capacity below
            # 2x the grid floor): a probe here would be timed and then
            # dropped by summarize — skip it; the level keeps its
            # detection-derived primary-mix cell (see fit_from_result)
            continue
        out.append(min(inside, key=lambda s: abs(math.log(s / center))))
    return sorted(set(out))


def characterize(mixes=("load_sum", "copy", "fma_8", "fma_32"),
                 primary: str = "load_sum", *, runner=None,
                 backend: str = "torch", name: str | None = None,
                 register: bool = True, prior: HardwareSpec | None = None,
                 **adaptive_kw) -> tuple[FittedMachineModel, AdaptiveSweep]:
    """The full measurement->inference pipeline.

    1. adaptive boundary-refining sweep on ``primary``
    2. secondary ``mixes`` measured only at plateau-interior probe sizes
    3. fit + prior cross-check + registry publication

    ``runner=None`` makes a ``Runner()`` on the default device (``cuda``).
    The prior, unless given, is the measured device's: ``detect_device``
    where the runner measures a CUDA device (and the model is named after
    the card), else ``detect_host()``.
    """
    from repro_torch.bench import BenchSpec, Runner
    runner = runner or Runner()
    if primary not in mixes:
        mixes = (primary, *mixes)
    sweep = adaptive_sweep(primary, runner=runner, backend=backend,
                           **adaptive_kw)
    secondary = tuple(m for m in mixes if m != primary)
    if secondary:
        probes = probe_sizes(sweep.detection)
        if probes:
            spec_kw = adaptive_kw.get("spec_kw") or {}
            spec = BenchSpec(
                mixes=secondary, sizes=tuple(probes), backend=backend,
                dtype=adaptive_kw.get("dtype", "float32"),
                reps=adaptive_kw.get("reps", 5),
                warmup=adaptive_kw.get("warmup", 1),
                target_bytes=adaptive_kw.get("target_bytes", 5e7), **spec_kw)
            res2 = runner.run(spec)
            sweep.result.points.extend(res2.points)
            sweep.result.meta["mixes"] = list(mixes)
    if prior is None:
        device = getattr(runner, "device", None)
        if device is not None and device.type == "cuda":
            prior = detect_device(device)
            name = name or f"{prior.name}-fitted"
        else:
            prior = detect_host()
    model = fit_from_result(sweep.result, detection=sweep.detection,
                            name=name or "host-cpu-fitted")
    model.provenance["sweep"] = sweep.summary()
    model.provenance["backend"] = backend
    model.sysfs_prior = crosscheck_prior(sweep.detection, prior)
    if register:
        model.register()
    return model, sweep
