"""ECM-style analytic predictor over instruction profiles.

Counterpart of ``repro.audit.ecm``, the same arithmetic: the
Execution-Cache-Memory model decomposes a streaming kernel's per-pass time
into an in-core issue term and per-level transfer terms,

    t_core = issue work / fitted issue rate
    t_data = sum over the levels the data streams through of
             (observed traffic bytes / that level's measured bandwidth)
    t_pred = max(t_core, t_data)        # full-overlap assumption

with the issue rate and level bandwidths from a ``characterize``
``FittedMachineModel`` and the issue work and traffic from
``repro_torch.istream`` profiles.  On ``cuda`` the issue work is warp
instructions (the SASS the launches execute); ``issue_ceiling`` gives the
card's own ceiling in the same unit — SMs x 4 warp instructions a clock
(one scheduler per SM sub-partition) x ``clocks.max.sm`` — to print beside
a fitted rate.

Two consumers, as in the reference: ``validate_ecm`` (predicted vs
measured over a finished sweep) and ``predict_block_rows`` /
``ecm_filter_rows`` (the block-shape prefilter of ``core.autotune``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


# per-block issue overhead (element-op equivalents) charged by the analytic
# block-shape model: grid bookkeeping, block address arithmetic, loop
# control.  One VPU-tile's worth per block is the calibrated order of
# magnitude; the *ranking* (not the absolute time) is what the prefilter
# consumes, and the ranking is insensitive to 2x either way.
BLOCK_OVERHEAD_ELEMS = 1024.0


@dataclass
class EcmPrediction:
    """Analytic per-pass decomposition for one case."""
    mix: str
    backend: str
    nbytes: int
    t_core_s: float
    t_data_s: float
    level_times: dict = field(default_factory=dict)   # level -> seconds/pass
    declared_bytes: float = 0.0

    @property
    def t_pred_s(self) -> float:
        return max(self.t_core_s, self.t_data_s)

    @property
    def bound(self) -> str:
        return "core" if self.t_core_s >= self.t_data_s else "data"

    @property
    def gbps(self) -> float:
        """Effective declared-bytes throughput (comparable to
        BenchPoint.gbps, which normalizes by the same declared bytes)."""
        t = self.t_pred_s
        return self.declared_bytes / t / 1e9 if t > 0 else 0.0

    def to_dict(self) -> dict:
        return {"mix": self.mix, "backend": self.backend,
                "nbytes": self.nbytes, "t_core_s": self.t_core_s,
                "t_data_s": self.t_data_s, "t_pred_s": self.t_pred_s,
                "level_times": self.level_times, "bound": self.bound,
                "gbps": self.gbps}


def _issue_rate(model) -> float | None:
    issue = getattr(model, "issue", None) or {}
    return issue.get("rate_elems_per_s")


def ecm_predict(profile, model, mix=None) -> EcmPrediction:
    """Analytic per-pass time for one extracted ``InstructionProfile``
    against a ``FittedMachineModel`` — no timing, one compile."""
    from repro_torch.bench.mixes import get_mix
    m = get_mix(mix or profile.mix)
    unroll = max(profile.unroll, 1)
    itemsize = profile.nbytes // max(
        int(math.prod(profile.shape)) if profile.shape else 1, 1)
    obs_bytes = (profile.per_iter["loads"] + profile.per_iter["stores"]) \
        / unroll * max(itemsize, 1)
    issue_per_pass = profile.issue_elems_per_iter / unroll

    rate = _issue_rate(model)
    t_core = issue_per_pass / rate if rate else 0.0
    level_times = {}
    for lvl in model.level_path(profile.nbytes):
        bw = model.bandwidth_for(lvl, m.name)
        if bw:
            level_times[lvl.name] = obs_bytes / bw
    t_data = sum(level_times.values())
    return EcmPrediction(mix=m.name, backend=profile.backend,
                         nbytes=profile.nbytes, t_core_s=t_core,
                         t_data_s=t_data, level_times=level_times,
                         declared_bytes=m.bytes_per_pass(profile.nbytes))


def validate_ecm(pairs, model) -> dict:
    """Predicted vs measured over (BenchPoint, InstructionProfile) pairs.

    Per point: predicted call time = t_pred/pass x passes; relative error
    against the measured mean.  Returns rows + the summary stats the fig3
    harness prints (median/max absolute relative error)."""
    rows = []
    for point, prof in pairs:
        if prof is None or point.mean_s <= 0:
            continue
        pred = ecm_predict(prof, model, mix=point.mix)
        pred_s = pred.t_pred_s * max(point.passes, 1)
        rel = (pred_s - point.mean_s) / point.mean_s
        rows.append({"mix": point.mix, "backend": point.backend,
                     "nbytes": point.nbytes,
                     "knobs": {"block_rows": getattr(point, "block_rows", None),
                               "unroll": point.unroll},
                     "measured_s": point.mean_s, "predicted_s": pred_s,
                     "rel_err": rel, "bound": pred.bound,
                     "measured_gbps": point.gbps, "predicted_gbps": pred.gbps})
    errs = sorted(abs(r["rel_err"]) for r in rows)
    med = errs[len(errs) // 2] if errs else None
    return {"rows": rows, "n": len(rows),
            "median_abs_rel_err": med,
            "max_abs_rel_err": errs[-1] if errs else None}


# --------------------------------------------------------------------------
# block-shape prefilter (core.autotune consumer)
# --------------------------------------------------------------------------

def predict_block_rows(nbytes: int, model, candidates, mix: str = "load_sum",
                       itemsize: int = 4, lanes: int = 128,
                       overhead_elems: float = BLOCK_OVERHEAD_ELEMS) -> dict:
    """Closed-form ECM ranking of block-row candidates: rows -> predicted
    GB/s.  The two penalties that make fig3's curve peaked:

    * capacity: the block tile (plus its companion stream — factor 2) must
      fit the innermost level, else the transfer path extends outward;
    * issue: per-block overhead charges small blocks on the core term.
    """
    from repro_torch.bench.mixes import get_mix
    m = get_mix(mix)
    n = nbytes // max(itemsize, 1)
    rate = _issue_rate(model)
    declared = m.bytes_per_pass(nbytes)
    traffic_elems = (m.reads_per_elem + m.writes_per_elem) * n
    out = {}
    for rows in candidates:
        block_bytes = rows * lanes * itemsize
        nblocks = max(math.ceil(n / (rows * lanes)), 1)
        issue = traffic_elems + m.flops_per_elem * n + overhead_elems * nblocks
        t_core = issue / rate if rate else 0.0
        t_data = 0.0
        for lvl in model.level_path(max(nbytes, 2 * block_bytes)):
            bw = model.bandwidth_for(lvl, m.name)
            if bw:
                t_data += traffic_elems * itemsize / bw
        t = max(t_core, t_data)
        out[rows] = declared / t / 1e9 if t > 0 else 0.0
    return out


def issue_ceiling(sms: int, clock_mhz: float,
                  per_sm_per_clock: int = 4) -> float:
    """The card's issue ceiling in warp instructions a second: ``sms`` SMs
    x ``per_sm_per_clock`` warp instructions a clock (an H100 SM issues one
    from each of its four sub-partitions) x the SM clock in MHz (read on
    the card: ``nvidia-smi --query-gpu=clocks.max.sm``)."""
    return float(sms) * per_sm_per_clock * clock_mhz * 1e6


def ecm_filter_rows(nbytes: int, model, candidates, keep: int = 3,
                    mix: str = "load_sum", itemsize: int = 4) -> tuple:
    """(kept, predicted) — the top-``keep`` candidates by ECM-predicted
    throughput, in the original candidate order (the autotuner's timed
    sweep then runs only these)."""
    predicted = predict_block_rows(nbytes, model, candidates, mix=mix,
                                   itemsize=itemsize)
    ranked = sorted(predicted, key=predicted.get, reverse=True)[:max(keep, 1)]
    kept = tuple(r for r in candidates if r in ranked)
    return kept, predicted
