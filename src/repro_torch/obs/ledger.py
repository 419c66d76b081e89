"""Persistent run ledger — every benchmark invocation leaves a record.

Layout (``BENCH_history/`` by default; override with ``--history-root`` or
``REPRO_BENCH_HISTORY``):

    BENCH_history/
        VERSION         ledger format version (this module refuses newer)
        ledger.jsonl    one compact JSON record per line, append-only

A record is NOT the full result (those go wherever ``--out`` points): it
is the diffable summary — spec digest, machine identity, per-cell
bandwidth curves *with noise statistics* (mean GB/s, sample count, and the
log-space sigma from the per-rep samples result schema v6 retains), the
loaded-latency knees when present, the obs counters, and the trace path.
Records are the write path of a per-node history: one ledger per node,
diffed against a stored baseline.  The record layout, ``LEDGER_VERSION``,
``CELL_KEY`` and ``LEDGER_ENV`` are those of the JAX reference package's
ledger, so a ledger written by either package can be diffed against the
other's.

``diff_records`` is the regression gate: per curve cell, a two-sample test
on log-bandwidth using the SAME noise-aware threshold
``characterize.detect.significant_step`` applies when merging plateau
segments — ``max(log(1+tolerance), z·σ·√(1/n₁+1/n₂))``.  A significant
*drop* is a regression (CLI ``diff`` exits 2); a significant rise is
reported as an improvement; anything inside the threshold is noise.  A
record diffed against itself is identical by construction (exit 0).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

LEDGER_VERSION = 1
LEDGER_ENV = "REPRO_BENCH_HISTORY"
DEFAULT_ROOT = "BENCH_history"

#: curve cells are keyed by every knob that changes what the number means
CELL_KEY = ("mix", "nbytes", "devices", "unroll", "interleave", "load")


def ledger_root(root: str | Path | None = None) -> Path:
    return Path(root or os.environ.get(LEDGER_ENV) or DEFAULT_ROOT)


def spec_digest(spec: dict) -> str:
    """Stable short digest of a spec dict (sorted-key canonical JSON)."""
    blob = json.dumps(spec, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


# ---------------------------------------------------------------------------
# record construction
# ---------------------------------------------------------------------------

def _median(sorted_vals: list) -> float:
    k = len(sorted_vals)
    mid = k // 2
    if k % 2:
        return sorted_vals[mid]
    return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])


def _cell_stats(points: list) -> dict:
    """Mean GB/s + noise statistics for one curve cell's points.

    ``n`` counts raw timing samples (the per-rep retention of schema v6)
    and ``log_sigma`` is a MAD-robust scale of log-throughput across them
    (1.4826 * median |log t - median log t|) — since gbps = bytes/t,
    scale(log gbps) == scale(log t).  Robust matters here: a single cold
    first rep can be several times slower than the rest, and a plain
    sample std inflated by that outlier deadens the regression gate.  Points without retained samples fall back to reps
    and the coefficient of variation (≈ sigma of the log for small
    noise)."""
    gbps = [p.gbps for p in points]
    mean = sum(gbps) / len(gbps)
    n = 0
    var_sum, var_n = 0.0, 0
    for p in points:
        samples = getattr(p, "rep_times_s", None)
        if samples:
            n += len(samples)
            logs = sorted(math.log(t) for t in samples if t > 0)
            if len(logs) > 1:
                med = _median(logs)
                mad = _median(sorted(abs(x - med) for x in logs))
                var_sum += (1.4826 * mad) ** 2
                var_n += 1
        else:
            n += p.reps
            if p.mean_s:
                var_sum += (p.std_s / p.mean_s) ** 2
                var_n += 1
    sigma = math.sqrt(var_sum / var_n) if var_n else 0.0
    cell = {"gbps": mean, "n": max(n, 1), "log_sigma": sigma}
    lats = [p.latency_ns for p in points
            if getattr(p, "latency_ns", None) is not None]
    if lats:
        cell["latency_ns"] = sum(lats) / len(lats)
    return cell


def record_from_result(res, *, cmd: str = "run", trace_path=None,
                       out_path=None, extra: dict | None = None) -> dict:
    """Compact ledger record for one BenchResult (no file IO)."""
    cells: dict[tuple, list] = {}
    for p in res.points:
        key = tuple(getattr(p, k, None) for k in CELL_KEY)
        cells.setdefault(key, []).append(p)
    curves = []
    for key in sorted(cells, key=lambda k: tuple(str(x) for x in k)):
        cell = dict(zip(CELL_KEY, key))
        cell.update(_cell_stats(cells[key]))
        curves.append(cell)
    meta = res.meta or {}
    rec = {
        "ledger_version": LEDGER_VERSION,
        "time_unix_s": time.time(),
        "cmd": cmd,
        "spec_digest": spec_digest(res.spec or {}),
        "schema_version": res.schema_version,
        "backend": (res.spec or {}).get("backend"),
        "machine": {k: res.machine.get(k)
                    for k in ("hostname", "arch", "device_platform",
                              "device_kind", "device_count", "process_count")
                    if k in (res.machine or {})},
        "mixes": list(meta.get("mixes") or []),
        "sizes": list(meta.get("sizes") or []),
        "curves": curves,
        "knees": (meta.get("loaded_latency") or {}).get("fit"),
        "obs": meta.get("obs"),
        "trace": str(trace_path) if trace_path else None,
        "out": str(out_path) if out_path else None,
    }
    if extra:
        rec.update(extra)
    return rec


# ---------------------------------------------------------------------------
# on-disk ledger
# ---------------------------------------------------------------------------

def append_record(res_or_record, *, root=None, **kw) -> tuple[Path, dict]:
    """Append one record (built from a BenchResult unless already a dict)
    to the ledger; returns (ledger path, record).  Append-only: existing
    history is never rewritten (the ``--force`` overwrite rule is about
    result files, not the ledger)."""
    rec = (res_or_record if isinstance(res_or_record, dict)
           else record_from_result(res_or_record, **kw))
    rootp = ledger_root(root)
    rootp.mkdir(parents=True, exist_ok=True)
    vfile = rootp / "VERSION"
    if vfile.exists():
        _check_version(int(vfile.read_text().strip()), vfile)
    else:
        vfile.write_text(f"{LEDGER_VERSION}\n")
    path = rootp / "ledger.jsonl"
    with path.open("a") as f:
        f.write(json.dumps(rec) + "\n")
    return path, rec


def _check_version(ver: int, where) -> None:
    if ver > LEDGER_VERSION:
        raise ValueError(f"ledger at {where} has version {ver}, newer than "
                         f"supported {LEDGER_VERSION}")


def read_ledger(root=None) -> list[dict]:
    """All records, oldest first; [] when no ledger exists yet."""
    path = ledger_root(root) / "ledger.jsonl"
    if not path.exists():
        return []
    records = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        _check_version(rec.get("ledger_version", LEDGER_VERSION), path)
        records.append(rec)
    return records


def resolve_ref(ref, root=None) -> dict:
    """A baseline reference → ledger record.

    Accepted forms: an integer index into the ledger (Python indexing:
    ``-1`` = newest, ``0`` = oldest), the string ``latest``, a path to a
    JSON file (either a saved ledger record or a full BenchResult, which
    is summarized on the fly), or a spec-digest prefix (newest match
    wins)."""
    s = str(ref)
    if s == "latest":
        s = "-1"
    try:
        idx = int(s)
    except ValueError:
        idx = None
    records = read_ledger(root)
    if idx is not None:
        if not records:
            raise ValueError(f"ledger at {ledger_root(root)} is empty; "
                             f"cannot resolve index {idx}")
        try:
            return records[idx]
        except IndexError:
            raise ValueError(f"ledger index {idx} out of range "
                             f"({len(records)} record(s))") from None
    p = Path(s)
    if p.exists():
        d = json.loads(p.read_text())
        if "ledger_version" in d:
            _check_version(d["ledger_version"], p)
            return d
        if "points" in d:       # a full BenchResult file
            from repro_torch.bench.result import BenchResult
            return record_from_result(BenchResult.from_dict(d),
                                      cmd="file", out_path=p)
        raise ValueError(f"{p} is neither a ledger record nor a BenchResult")
    matches = [r for r in records if r.get("spec_digest", "").startswith(s)]
    if matches:
        return matches[-1]
    raise ValueError(f"cannot resolve ledger ref {ref!r}: not an index, an "
                     f"existing file, or a digest prefix of the "
                     f"{len(records)} record(s) in {ledger_root(root)}")


# ---------------------------------------------------------------------------
# the regression gate
# ---------------------------------------------------------------------------

@dataclass
class DiffReport:
    baseline: dict
    current: dict
    rows: list[dict] = field(default_factory=list)
    missing: list[dict] = field(default_factory=list)   # cells only in base
    added: list[dict] = field(default_factory=list)     # cells only in cur
    z: float = 3.0
    tolerance: float = 0.05

    @property
    def regressions(self) -> list[dict]:
        return [r for r in self.rows if r["verdict"] == "regression"]

    @property
    def improvements(self) -> list[dict]:
        return [r for r in self.rows if r["verdict"] == "improvement"]

    @property
    def identical(self) -> bool:
        return (not self.missing and not self.added
                and all(r["ratio"] == 1.0 for r in self.rows))

    def exit_code(self) -> int:
        return 2 if self.regressions else 0

    def summary(self) -> dict:
        return {"cells": len(self.rows),
                "regressions": len(self.regressions),
                "improvements": len(self.improvements),
                "missing": len(self.missing), "added": len(self.added),
                "z": self.z, "tolerance": self.tolerance}

    def table(self) -> str:
        lines = [f"{'cell':38s} {'base GB/s':>10s} {'cur GB/s':>10s} "
                 f"{'ratio':>7s}  verdict"]
        for r in self.rows:
            lines.append(f"{r['cell']:38s} {r['base_gbps']:10.2f} "
                         f"{r['cur_gbps']:10.2f} {r['ratio']:7.3f}  "
                         f"{r['verdict']}{' *' if r['significant'] else ''}")
        for m in self.missing:
            lines.append(f"{m['cell']:38s} {'(missing in current)':>30s}")
        s = self.summary()
        lines.append(f"# {s['cells']} cells: {s['regressions']} regression(s)"
                     f", {s['improvements']} improvement(s), "
                     f"{s['missing']} missing, {s['added']} added "
                     f"(z={s['z']}, tolerance={s['tolerance']:.0%})")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"summary": self.summary(), "rows": self.rows,
                "missing": self.missing, "added": self.added,
                "baseline_digest": self.baseline.get("spec_digest"),
                "current_digest": self.current.get("spec_digest")}


def _cell_label(cell: dict) -> str:
    label = f"{cell['mix']}/{cell['nbytes']}B"
    for k in ("devices", "unroll", "interleave", "load"):
        v = cell.get(k)
        if v not in (None, 1) and (k != "load" or v != 0):
            label += f"/{k[0]}{v}"
    return label


def diff_records(baseline: dict, current: dict, *, z: float = 3.0,
                 tolerance: float = 0.05) -> DiffReport:
    """Noise-aware comparison of two records' bandwidth curves.

    Per cell present in both, a two-sample test on log-GB/s
    (``characterize.detect.significant_step`` — the plateau-merge
    threshold): the gap must clear both the physical floor
    ``log(1+tolerance)`` and ``z·σ·√(1/n₁+1/n₂)``, σ being the larger of
    the two cells' stored log-sigmas (per-rep scatter).  Only significant
    *drops* regress; cells the baseline has but the current run lacks are
    reported as missing (coverage shrank — visible, not fatal)."""
    from repro_torch.characterize.detect import significant_step

    def index(rec):
        return {tuple(c.get(k) for k in CELL_KEY): c
                for c in rec.get("curves", [])}

    base, cur = index(baseline), index(current)
    report = DiffReport(baseline=baseline, current=current, z=z,
                        tolerance=tolerance)
    for key in sorted(set(base) & set(cur),
                      key=lambda k: tuple(str(x) for x in k)):
        b, c = base[key], cur[key]
        if b["gbps"] <= 0 or c["gbps"] <= 0:
            ratio = float("nan") if b["gbps"] <= 0 else 0.0
            sig, verdict = True, ("regression" if c["gbps"] <= 0 < b["gbps"]
                                  else "unknown")
        else:
            mb, mc = math.log(b["gbps"]), math.log(c["gbps"])
            sigma = max(b.get("log_sigma") or 0.0, c.get("log_sigma") or 0.0,
                        1e-3)
            sig = significant_step(mb, b.get("n", 1), mc, c.get("n", 1),
                                   sigma=sigma, z=z, min_drop=tolerance)
            ratio = c["gbps"] / b["gbps"]
            verdict = ("regression" if sig and ratio < 1.0 else
                       "improvement" if sig and ratio > 1.0 else "ok")
        report.rows.append({
            "cell": _cell_label(b), "key": list(key),
            "base_gbps": b["gbps"], "cur_gbps": c["gbps"], "ratio": ratio,
            "significant": sig, "verdict": verdict,
            "base_n": b.get("n"), "cur_n": c.get("n"),
        })
    report.missing = [{"cell": _cell_label(base[k]), "key": list(k)}
                      for k in sorted(set(base) - set(cur),
                                      key=lambda k: tuple(str(x)
                                                          for x in k))]
    report.added = [{"cell": _cell_label(cur[k]), "key": list(k)}
                    for k in sorted(set(cur) - set(base),
                                    key=lambda k: tuple(str(x) for x in k))]
    return report
