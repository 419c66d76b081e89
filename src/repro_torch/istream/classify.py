"""Bandwidth-bound vs issue-bound classification of measured points.

Counterpart of ``repro.istream.classify``, the same rule: join each measured
BenchPoint with its InstructionProfile and compare two estimates of one
timed call,

    mem_time   = bytes_per_call / achievable_bandwidth(nbytes)
    issue_time = issue work per call / fitted issue rate

whichever is larger names the regime; the margin is
``|log2(issue_time / mem_time)|``.  Achievable bandwidth comes from a
``characterize.FittedMachineModel`` when one is supplied, else from the best
measured GB/s at the same size in the result (self-calibration).  The issue
work of a cuda point is the warp instructions its launches execute, of a
torch point the element-ops of its aten operations; the rate is fitted per
run over both, from the fastest point, as in the reference.

``run_istream`` sweeps unroll x interleave over the requested mixes and
backends, observes every case's profile, classifies and renders the fig6
table.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

from repro_torch.bench.result import BenchResult
from repro_torch.bench.spec import BenchSpec
from repro_torch.istream.analyze import (InstructionProfile, ProfileCache,
                                   analyze_case, fit_issue_rate,
                                   point_join_key, profile_join_key)

#: label strings — the only two values a point's istream["label"] takes
BANDWIDTH_BOUND = "bandwidth-bound"
ISSUE_BOUND = "issue-bound"


def _bandwidth_for(nbytes: int, result: BenchResult, model=None) -> float:
    """Achievable bandwidth (B/s) for a working set of ``nbytes``: the
    fitted model's level bandwidth when a model is given, else the best
    measured GB/s at this size in the result (self-calibration)."""
    if model is not None and getattr(model, "levels", ()):
        for lvl in model.levels:
            cap = lvl.capacity_bytes
            if (cap is None or nbytes <= cap) and lvl.bandwidth:
                return lvl.best_gbps * 1e9
        last = model.levels[-1]
        if last.bandwidth:
            return last.best_gbps * 1e9
    best = max((p.gbps for p in result.points if p.nbytes == nbytes),
               default=0.0)
    return best * 1e9


def classify_points(result: BenchResult, profiles: dict,
                    issue_rate: float | None = None, model=None
                    ) -> BenchResult:
    """Annotate every point that has a profile with its regime label.

    ``profiles`` maps ``profile_join_key(...)`` -> InstructionProfile.
    ``issue_rate`` (element-ops/s) is fitted from the joined points when not
    given.  Returns a NEW BenchResult (points are frozen; annotated copies
    replace them) with ``meta["istream"]`` recording the fit and the label
    census; unjoined points pass through with ``istream=None``.

    Each annotation also records the point's *traffic provenance* from the
    accounting auditor: ``istream["traffic"]`` is ``"audited"`` when
    ``repro_torch.audit`` holds an enforced traffic expectation for the
    (mix, backend, knobs) combination — its GB/s is absolute — and
    ``"waived"`` (with ``istream["traffic_waiver"]`` naming the caveat)
    when the combination carries a documented waiver and the number should
    be read as shape-only.  Since the rotating-carry fix, carried-mix
    unroll>1 points are audited, not waived.
    """
    import numpy as np
    from repro_torch.audit.verify import expected_counts, waiver_reason
    from repro_torch.bench.mixes import get_mix

    def _traffic_status(p):
        knobs = {"unroll": p.unroll, "interleave": p.interleave,
                 "streams": p.streams, "block_rows": p.block_rows}
        try:
            mixdef = get_mix(p.mix)
        except KeyError:
            return None, None
        n = p.nbytes / (2 if p.dtype == "bfloat16" else
                        np.dtype(p.dtype).itemsize)
        if expected_counts(mixdef, p.backend, n, knobs,
                           dtype=p.dtype) is not None:
            return "audited", None
        return "waived", (waiver_reason(mixdef, p.backend, knobs)
                          or "no expectation for this backend")

    pairs = [(p, profiles.get(point_join_key(p))) for p in result.points]
    if issue_rate is None and model is not None:
        # schema-v2 fitted models carry the issue fit (characterize.fit)
        issue_rate = (getattr(model, "issue", None) or {}
                      ).get("rate_elems_per_s")
    # the issue work of each backend has its own unit (cuda: warp
    # instructions, torch: element-ops), so each backend's rate is fitted
    # from its own points
    backends = sorted({p.backend for p, prof in pairs if prof is not None})
    rates = {b: (issue_rate if issue_rate is not None else
                 fit_issue_rate([(p, prof) for p, prof in pairs
                                 if p.backend == b]))
             for b in backends}
    points = []
    census = {BANDWIDTH_BOUND: 0, ISSUE_BOUND: 0}
    for p, prof in pairs:
        rate = rates.get(p.backend, 0.0)
        if prof is None or rate <= 0 or p.mean_s <= 0:
            points.append(p)
            continue
        bw = _bandwidth_for(p.nbytes, result, model)
        mem_time = p.bytes_per_call / bw if bw > 0 else float("inf")
        issue_time = prof.issue_elems_per_call(p.passes) / rate
        label = ISSUE_BOUND if issue_time > mem_time else BANDWIDTH_BOUND
        if mem_time > 0 and issue_time > 0 and math.isfinite(mem_time):
            margin = abs(math.log2(issue_time / mem_time))
        else:
            margin = float("inf")
        census[label] += 1
        traffic, waiver = _traffic_status(p)
        points.append(dataclasses.replace(p, istream={
            "label": label,
            "traffic": traffic,
            "traffic_waiver": waiver,
            "margin": margin if math.isfinite(margin) else None,
            "issue_time_s": issue_time,
            "mem_time_s": mem_time if math.isfinite(mem_time) else None,
            "issue_elems_per_call": prof.issue_elems_per_call(p.passes),
            "critical_path": prof.critical_path,
            "trips": prof.trips,
            "per_iter": dict(prof.per_iter)}))
    out = BenchResult(points=points, spec=result.spec,
                      machine=result.machine, meta=dict(result.meta),
                      schema_version=result.schema_version)
    out.meta["istream"] = {"issue_rate_elems_per_s":
                           next(iter(rates.values())) if len(rates) == 1
                           else None,
                           "issue_rates": rates,
                           "labels": census,
                           "model": getattr(model, "name", None)}
    return out


def render_fig6(result: BenchResult) -> str:
    """The fig6 table: every classified point with its knobs, throughput,
    regime label, confidence margin, and traffic provenance (markdown).

    GB/s in ``audited`` rows is absolute — the auditor enforces that the
    compiled code moves the declared bytes, including carried mixes at
    unroll>1 (rotating-carry fix).  ``waived`` rows carry a documented
    accounting caveat (e.g. chunked interleave) and should be read as
    issue-axis shapes, not absolute throughput."""
    lines = ["| backend | mix | KiB | unroll | ilv | GB/s | label | "
             "margin | traffic |",
             "|---|---|---:|---:|---:|---:|---|---:|---|"]
    for p in result.points:
        info = p.istream
        if info is None:
            continue
        margin = info.get("margin")
        lines.append(
            f"| {p.backend} | {p.mix} | {p.nbytes / 1024:.0f} "
            f"| {p.unroll} | {p.interleave} | {p.gbps:.2f} "
            f"| {info['label']} "
            f"| {'inf' if margin is None else f'{margin:.2f}'} "
            f"| {info.get('traffic') or '-'} |")
    meta = result.meta.get("istream", {})
    rates = meta.get("issue_rates") or {}
    if rates:
        lines.append("")
        unit = {"cuda": "warp instructions"}
        lines.append("fitted issue rate: " + "; ".join(
            f"{b} {r:.3e} {unit.get(b, 'element-ops')}/s"
            for b, r in rates.items()) + f"; labels: {meta.get('labels')}")
    return "\n".join(lines)


@dataclass
class IStreamReport:
    """Everything ``run_istream`` produced: the annotated result, the fitted
    issue rate (cuda's where it ran: warp instructions a second; every
    backend's is in ``result.meta["istream"]["issue_rates"]``), the
    per-case profiles (by join key), and the fig6 table."""
    result: BenchResult
    issue_rate: float
    profiles: dict = field(default_factory=dict)
    table: str = ""

    @property
    def labels(self) -> dict:
        return self.result.meta.get("istream", {}).get("labels", {})


def synthetic_check() -> dict:
    """Deterministic classifier self-test on synthetic profiles — no device,
    no timing.  Two hand-built cases: a cache-resident case whose issue work
    dwarfs its byte traffic (must classify issue-bound) and a DRAM-sized
    case whose bytes dwarf its issue work (must classify bandwidth-bound).
    CI's fast-fail step asserts both labels appear.  Returns the census."""
    from repro_torch.bench.result import BenchPoint

    def _point(nbytes, bpc, mean_s, gbps, mix):
        return BenchPoint(
            nbytes=nbytes, mix=mix, dtype="float32", backend="synthetic",
            passes=8, streams=1, block_rows=None, reps=3,
            bytes_per_call=bpc, flops_per_call=0.0, mean_s=mean_s,
            std_s=0.0, min_s=mean_s, gbps=gbps, gflops=0.0)

    def _profile(mix, nbytes, loads, stores, arith):
        return InstructionProfile(
            mix=mix, backend="synthetic", shape=(nbytes // 512, 128),
            dtype="float32", nbytes=nbytes, unroll=1, interleave=1,
            per_iter={"loads": loads, "stores": stores, "arith": arith,
                      "move": 0.0, "ops": 4, "opcodes": {}},
            critical_path=16.0, trips=8, passes=8, loop="while.0")

    # issue-heavy: 32 KiB set, tiny bytes/call, huge arithmetic per iter —
    # slow despite sitting in cache.  bandwidth-heavy: 256 MiB set, huge
    # bytes/call, light issue work.  load_sum is the unprofiled reference
    # that reveals the achievable cache bandwidth at the small size (the
    # self-calibration path: without it, fma's own throughput would define
    # "achievable" and the classifier could only ever tie).
    small, big = 32 * 2**10, 256 * 2**20
    points = [_point(small, bpc=8 * small, mean_s=1e-3, gbps=0.26,
                     mix="fma"),
              _point(small, bpc=8 * small, mean_s=6.55e-6, gbps=40.0,
                     mix="load_sum"),
              _point(big, bpc=8 * big, mean_s=1e-1, gbps=21.5,
                     mix="copy")]
    profiles = {
        profile_join_key("synthetic", "fma", 1, 1, small):
            _profile("fma", small, loads=8e3, stores=8e3, arith=5e6),
        profile_join_key("synthetic", "copy", 1, 1, big):
            _profile("copy", big, loads=6e7, stores=6e7, arith=1e3),
    }
    res = BenchResult(points=points)
    out = classify_points(res, profiles)
    labels = {p.mix: p.istream["label"] for p in out.points
              if p.istream is not None}
    ok = (labels.get("fma") == ISSUE_BOUND
          and labels.get("copy") == BANDWIDTH_BOUND)
    return {"ok": ok, "labels": labels,
            "census": out.meta["istream"]["labels"],
            "issue_rate": out.meta["istream"]["issue_rate_elems_per_s"]}


def run_istream(backends=("torch", "cuda"), mixes=("copy", "rw_2to1"),
                sizes=None, unrolls=(1, 2), interleaves=(1, 2),
                reps: int = 3, smoke: bool = False, model=None,
                runner=None, sass=None, machine=None) -> IStreamReport:
    """The subsystem's entry point: sweep unroll x interleave per backend
    over the given mixes and sizes (one Runner: ``runner``, by default on
    the CUDA device), observe each case's profile (``analyze_case``: cuda over
    ``sass``, by default the SASS of the libraries built from this
    checkout, for ``machine`` = (SMs, L2 bytes), by default the card's),
    fit the issue rate, classify every point and render the fig6 table.

    A profile is observed at 2 x unroll passes and carried to the pass
    count the Runner timed (the per-pass profile does not depend on it),
    so a sweep of many passes emulates few.  ``smoke`` shrinks sizes and
    reps to a seconds-scale end-to-end pass (the reference's preset).
    """
    import torch

    from repro_torch.bench.runner import Runner, pick_passes
    from repro_torch.core import buffers
    from repro_torch.istream.analyze import LiveSass, machine_of

    if sizes is None:
        sizes = (1 << 16, 1 << 20) if smoke else (1 << 16, 1 << 20, 1 << 24)
    if smoke:
        reps = min(reps, 2)
    runner = runner or Runner()
    if "cuda" in backends:
        sass = sass if sass is not None else LiveSass()
        machine = machine if machine is not None else machine_of()
    specs = [BenchSpec(mixes=tuple(mixes), sizes=tuple(sizes),
                       backend=b, unroll=u, interleave=i, reps=reps)
             for b in backends
             for u in unrolls
             for i in interleaves]
    result = runner.run_many(specs, extra_meta={"sweep": "istream"})

    cache = ProfileCache()
    profiles: dict[tuple, InstructionProfile] = {}
    dtype = getattr(torch, specs[0].dtype)
    for spec in specs:
        for nbytes in spec.sizes:
            shape = buffers.working_set_shape(nbytes, dtype=dtype)
            real_bytes = shape[0] * shape[1] * dtype.itemsize
            passes = spec.passes or pick_passes(real_bytes,
                                               spec.target_bytes)
            if passes % spec.unroll:    # mirror the Runner's round-up
                passes += spec.unroll - passes % spec.unroll
            for mix_name in spec.mixes:
                prof = analyze_case(spec, mix_name, shape, dtype,
                                    2 * spec.unroll, cache=cache,
                                    sass=sass if spec.backend == "cuda"
                                    else None,
                                    machine=machine if spec.backend == "cuda"
                                    else None)
                prof = dataclasses.replace(
                    prof, passes=passes,
                    trips=max(passes // spec.unroll, 1) if prof.trips else 0)
                profiles[profile_join_key(spec.backend, mix_name,
                                          spec.unroll, spec.interleave,
                                          real_bytes)] = prof
    annotated = classify_points(result, profiles, model=model)
    rates = annotated.meta["istream"]["issue_rates"]
    return IStreamReport(result=annotated,
                         issue_rate=rates.get("cuda",
                                              next(iter(rates.values()), 0.0)),
                         profiles=profiles, table=render_fig6(annotated))
