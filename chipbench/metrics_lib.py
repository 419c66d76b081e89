"""Arithmetic the metric readers share."""
from __future__ import annotations

import importlib
import statistics

from chipbench.counts import peaks


def traced(run):
    """The window's trace, or None where no device operation ran inside
    the traced prefills (nothing to read)."""
    tr = run.window.trace
    if tr is None or not tr.serve or not tr.device_in(tr.serve):
        return None
    return tr


def ttft_quantile(run, q: int):
    """The q-th percentile (Python's inclusive quantiles) of the times to
    first token of the requests done by the window's close, ms; every
    request of a batch counted, those served under the profiler (a traced
    run's last batches) left out."""
    w = run.window
    ttft = [(d - s) * 1e3 for s, d, t in zip(w.started, w.done, w.traced)
            for _ in range(run.traffic["batch"])
            if not t and d <= w.close]
    if len(ttft) < 2:
        return None
    return statistics.quantiles(ttft, n=100, method="inclusive")[q - 1]


def service_s(run):
    """The mean service time of the batches done by the window's close and
    not served under the profiler, seconds (host clock), or None: a
    prefill as the program runs it, without the profiler's cost on the
    host."""
    w = run.window
    took = [d - s for s, d, t in zip(w.started, w.done, w.traced)
            if not t and d <= w.close]
    return sum(took) / len(took) if took else None


def roofline(run, kernel: str):
    """Bound over device time of ``kernel``'s launches inside the traced
    prefills, %. None where the prefill launches none, where the trace
    holds another number of them than the kernel's own launch counter
    counted while tracing, or where they are not a whole number of
    prefills' worth of the counted shapes (then the shapes counted are not
    the ones run)."""
    tr = traced(run)
    if tr is None:
        return None
    t = run.traffic
    shapes = run.counts.launches(run.arch, t["batch"],
                                 t["prompt_len"]).get(kernel)
    if not shapes:
        return None
    count = importlib.import_module(f"chipbench.counts.{kernel}")
    ops = [op for op in tr.device_in(tr.serve, ("kernel",))
           if any(k in op[2] for k in count.KERNELS)]
    if len(ops) != run.window.trace_launches.get(kernel) \
            or len(ops) != len(shapes) * len(tr.serve):
        return None
    bound = sum(peaks.bound_s(count.flops(s), count.nbytes(s))
                for s in shapes) * len(tr.serve)
    return 100.0 * bound / sum(e - s for s, e, *_ in ops)
