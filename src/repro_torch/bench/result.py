"""Versioned result schema: BenchPoint / BenchResult.

Every point carries its backend, the
addressing knobs it was measured under, and explicit bytes/flops accounting
(from the shared mix registry), so results from different backends/machines
are directly comparable.  The envelope carries ``schema_version``, the spec
that produced it, and machine metadata — a result file is a reproducible
record, not just numbers.

schema_version history: 1 = original point schema; 2 = points carry
``devices`` (the multi-device knob); 3 = points carry ``nbytes_requested``
(the pre-rounding spec size, so ``by_size`` resolves requested sizes), the
machine meta records process identity (``process_count`` /
``process_index`` / ``local_device_count`` — the ``distributed`` backend),
and unbounded ``summarize`` bands serialize as ``null`` instead of the
non-JSON ``Infinity``; 4 = points carry the instruction-stream knobs
(``unroll`` / ``interleave``) and an optional ``istream`` dict — the
per-point compiled-IR instruction profile + bandwidth-vs-instruction-bound label
attached by ``repro.istream``; 5 = points carry the loaded-latency axes
(``load`` generator count, per-step ``latency_ns``, aggregate generator
``gen_gbps`` — the Mess-style bandwidth–latency curve coordinates; None /
0 on non-chase points); 6 = points retain their raw per-rep timing samples
(``rep_times_s``, bounded to the last ``REP_SAMPLE_LIMIT`` reps — enough
for the run ledger's noise-aware regression test to compute per-cell CIs
instead of trusting the mean triple) and the envelope meta carries the
``obs`` observability snapshot (``repro_torch.obs``: per-run counter deltas —
cache hits/misses, buffer lifecycle, peak working-set bytes — plus the
Runner's cumulative cache counters, which used to die with the Runner
object).  Older files load unchanged with the defaults.

The schema is ``repro.bench.result``'s, field for field: a result JSON
written by either package loads in the other.
"""
from __future__ import annotations

import json
import math
import platform
from dataclasses import asdict, dataclass, field
from pathlib import Path

SCHEMA_VERSION = 6

#: per-point raw-sample retention (schema v6): the last this-many rep
#: timings survive into the result — bounded so a 10k-rep soak doesn't
#: bloat every record, plenty for a two-sample noise test
REP_SAMPLE_LIMIT = 64


def level_band(level_size: int | None,
               prev_size: float) -> tuple[float, float]:
    """Working-set band that cleanly sits inside one hierarchy level:
    (2x previous level, 0.5x this level); an unbounded level (DRAM/HBM,
    ``level_size=None``) opens to infinity.  The paper's §6 banding
    discipline, defined ONCE — ``summarize`` and ``core.analysis`` (which
    re-exports this) both read it."""
    lo = 2.0 * prev_size
    hi = 0.5 * level_size if level_size else float("inf")
    return lo, hi


@dataclass(frozen=True)
class BenchPoint:
    nbytes: int                 # real working-set bytes
    mix: str
    dtype: str
    backend: str
    passes: int
    streams: int
    block_rows: int | None
    reps: int
    bytes_per_call: float       # registry accounting x passes
    flops_per_call: float
    mean_s: float
    std_s: float
    min_s: float
    gbps: float
    gflops: float
    devices: int = 1            # schema v2; v1 files load with the default
    nbytes_requested: int | None = None     # schema v3: the spec size before
    #   buffers.working_set_shape rounding (None on pre-v3 files)
    unroll: int = 1             # schema v4: instruction-stream knobs
    interleave: int = 1
    istream: dict | None = None     # schema v4: repro.istream attaches the
    #   compiled-IR profile + bound classification here (None = not analyzed)
    load: int = 0               # schema v5: co-scheduled bandwidth generators
    latency_ns: float | None = None     # schema v5: ns per dependent chase
    #   step (chase mixes only; the loaded-latency curve's y axis)
    gen_gbps: float | None = None       # schema v5: aggregate generator GB/s
    #   (chase mixes: 0.0 at load=0; the loaded-latency curve's x axis)
    rep_times_s: tuple[float, ...] | None = None    # schema v6: raw per-rep
    #   timings, last REP_SAMPLE_LIMIT reps (None on pre-v6 files) — the
    #   ledger's regression gate derives per-cell noise sigmas from these

    def __post_init__(self):
        # canonicalize to a tuple so the frozen point stays hashable (JSON
        # round-trips hand from_dict a list); baseline_relative groups
        # points in dicts
        if self.rep_times_s is not None and not isinstance(self.rep_times_s,
                                                           tuple):
            object.__setattr__(self, "rep_times_s", tuple(self.rep_times_s))


@dataclass
class BenchResult:
    points: list[BenchPoint] = field(default_factory=list)
    spec: dict = field(default_factory=dict)       # BenchSpec.to_dict()
    machine: dict = field(default_factory=dict)    # machine_meta()
    meta: dict = field(default_factory=dict)       # run-level extras (dtype..)
    schema_version: int = SCHEMA_VERSION

    # -- queries ------------------------------------------------------------
    def by_mix(self, mix: str) -> list[BenchPoint]:
        return [p for p in self.points if p.mix == mix]

    def by_size(self, nbytes: int) -> list[BenchPoint]:
        """Points at a working-set size — matching either the *real*
        (rounded) byte count or the size as requested on the spec.
        ``buffers.working_set_shape`` rounds requests to whole (8, 128)
        tiles, so ``by_size(spec.sizes[i])`` historically returned ``[]``
        for any size the rounding moved; points now carry both (schema v3)
        and either resolves here."""
        return [p for p in self.points
                if p.nbytes == nbytes or p.nbytes_requested == nbytes]

    def baseline_relative(self, group_key=None, is_baseline=None
                          ) -> list[tuple[BenchPoint, float]]:
        """Each point's throughput relative to its group's baseline point.

        The baseline is the *first* point in each group satisfying
        ``is_baseline`` (default: the first point seen).  Anchoring uses an
        explicit presence check — a measured 0.0 GB/s baseline stays the
        baseline instead of silently re-anchoring on the next point (the
        ``base = base or gbps`` truthiness bug this replaces).
        """
        group_key = group_key or (lambda p: p.nbytes)
        bases: dict = {}
        for p in self.points:
            g = group_key(p)
            if g not in bases and (is_baseline is None or is_baseline(p)):
                bases[g] = p.gbps
        out = []
        for p in self.points:
            base = bases.get(group_key(p))
            rel = p.gbps / base if base else float("nan")
            out.append((p, rel))
        return out

    def summarize(self, levels=None, min_band_bytes: int = 4 * 2**10,
                  key=None) -> dict:
        """Per-level bandwidth attribution folded into the result — the
        paper's §6 'cumulative mean per hierarchy level', as a view on the
        points, so figure scripts stop re-deriving L1/L2/DRAM tables.

        ``levels`` is an ordered sequence (innermost first) of memory levels:
        either ``(name, size_bytes)`` pairs or objects with ``.name`` /
        ``.size_bytes`` attributes (e.g. ``core.machine_model.MemLevel``);
        ``size_bytes=None`` means unbounded (DRAM/HBM).  ``None`` summarizes
        everything into a single ``"all"`` level.  Each level's band is
        (2x previous level size, 0.5x this level size) so the mean sits
        cleanly inside one level; the innermost band opens at
        ``min_band_bytes``.

        Returns ``{level: {mix: {"gbps", "rel", "n", "band"}}}`` where
        ``rel`` is the mix's throughput relative to the best mix at that
        level (the paper's FADD/NOP/LOAD penalty ratios) and ``n`` the point
        count inside the band.  Levels with no points are omitted.  An
        unbounded band's upper edge is ``None`` (NOT ``float("inf")``): a
        summary stashed into ``meta`` must survive ``to_json``, and JSON has
        no ``Infinity`` — consumers treat a ``None`` edge as open.

        ``key`` overrides the per-point grouping column (default: the mix
        name) — e.g. ``lambda p: f"{p.mix}/u{p.unroll}x{p.interleave}"``
        groups a knob sweep by the instruction-stream axes.  A plain string
        names a BenchPoint field to group by (``summarize(key="load")``
        groups a loaded-latency sweep by generator count); field values are
        rendered with ``str()`` so the summary survives a ``meta`` JSON
        round-trip (JSON object keys are strings).  Prefer string keys if
        the summary is stashed into ``meta``.
        """
        if levels is None:
            levels = (("all", None),)
        if isinstance(key, str):
            col = key
            key = lambda p: str(getattr(p, col))  # noqa: E731
        key = key or (lambda p: p.mix)
        out: dict[str, dict] = {}
        prev = min_band_bytes / 2.0
        for lvl in levels:
            name, size = (lvl if isinstance(lvl, (tuple, list))
                          else (lvl.name, lvl.size_bytes))
            lo, hi = level_band(size, prev)
            mixes: dict[str, dict] = {}
            for p in self.points:
                if lo <= p.nbytes <= hi:
                    cell = mixes.setdefault(key(p), {"gbps": 0.0, "n": 0})
                    cell["gbps"] += p.gbps
                    cell["n"] += 1
            if mixes:
                best = max(c["gbps"] / c["n"] for c in mixes.values())
                for c in mixes.values():
                    c["gbps"] /= c["n"]
                    c["rel"] = c["gbps"] / best if best else float("nan")
                    c["band"] = (lo, None if math.isinf(hi) else hi)
                out[name] = mixes
            if size:
                prev = size
        return out

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        # meta is the free-form envelope (stashed summaries, skip maps, …):
        # sanitize it so the emitted text is real JSON — Python's dump of
        # inf/nan ("Infinity"/"NaN") is rejected by spec-compliant parsers.
        # summarize() already emits None band edges; this catches everything
        # else (e.g. a NaN ``rel`` from an all-zero level).
        return {"schema_version": self.schema_version,
                "spec": self.spec, "machine": self.machine,
                "meta": _json_finite(self.meta),
                "points": [asdict(p) for p in self.points]}

    def to_json(self, path: str | Path | None = None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            Path(path).write_text(s)
        return s

    @classmethod
    def from_dict(cls, d: dict) -> "BenchResult":
        ver = d.get("schema_version", 0)
        if ver > SCHEMA_VERSION:
            raise ValueError(
                f"result schema_version {ver} newer than supported "
                f"{SCHEMA_VERSION}")
        return cls(points=[BenchPoint(**p) for p in d.get("points", [])],
                   spec=d.get("spec", {}), machine=d.get("machine", {}),
                   meta=d.get("meta", {}),
                   schema_version=ver or SCHEMA_VERSION)

    @classmethod
    def from_json(cls, path: str | Path) -> "BenchResult":
        return cls.from_dict(json.loads(Path(path).read_text()))


def _json_finite(obj):
    """Deep-copy ``obj`` with non-finite floats replaced by None (the JSON
    serialization of an unbounded/undefined value); containers are rebuilt
    (tuples as lists, matching what a JSON round-trip produces anyway)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_finite(v) for v in obj]
    return obj


def machine_meta(device=None) -> dict:
    """Best-effort machine identity stamped into every result, for the
    ``device`` the run used (None = ``cuda``).  Keeps the keys the run
    ledger reads (``hostname``, ``arch``, ``device_platform``,
    ``device_kind``, ``device_count``, ``process_count``);
    ``device_platform`` is ``"gpu"`` or ``"cpu"``.  The device count is the
    pool a mesh may use (every visible GPU, or the logical CPU devices);
    process identity is the ``torch.distributed`` rank and world size (1 and
    0 outside a launch), and ``bench.distributed.gather_result`` extends the
    merged result with the per-process ``local_device_counts`` and the
    global ``device_count``."""
    import torch

    from repro_torch.bench import distributed as dist
    from repro_torch.core.device import device_pool, resolve_device
    dev = resolve_device(device)
    count = len(device_pool(dev))
    if dev.type == "cuda":
        plat, kind = "gpu", torch.cuda.get_device_name(dev)
    else:
        plat, kind = "cpu", platform.processor() or "cpu"
    return {"hostname": platform.node(),
            "arch": platform.machine(),
            "system": platform.system(),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": str(dev),
            "device_platform": plat,
            "device_kind": kind,
            "device_count": count,
            "process_count": dist.process_count(),
            "process_index": dist.process_index(),
            "local_device_count": count}
