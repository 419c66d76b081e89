"""The program's own spans in a traced run: the device time of what each
part of the model launched, and the bytes its weight casts read.

While a torch profiler records, the program's tracer (``repro_torch.obs.
trace``) enters each of its spans as a profiler span too, so that the
trace holds them as host operations (``Trace.host``) on the profiler's
clock: ``prefill`` around ``DecoderLM.prefill``, ``prefill.attn`` and
``prefill.mlp`` once a layer, ``cast`` around each weight cast. A device
operation falls under the span in which the call that launched it ran,
as ``Trace.device_in`` places it in a service span. A program that
records no such span reads nothing, not 0.

``Trace`` takes a launch's time from the runtime call of the same
correlation; a kernel launched by ``cuLaunchKernelEx`` (cuBLAS's GEMMs)
has none there and stands at its own start on the device, which runs
behind the host: placed so, a GEMM falls into a later span. Here such
kernels take the times of the ``cuLaunchKernel*`` calls instead, in
order: one stream runs its kernels in the order they were launched.
"""
from __future__ import annotations

import bisect

from chipbench.metrics_lib import traced
from chipbench.trace import Trace

#: the CUDA API's low-level calls that launch a kernel
CU_LAUNCHES = ("cuLaunchKernel", "cuLaunchKernelEx")

#: the program's span around one prefill
PREFILL = "prefill"


def program_spans(tr, name: str) -> list:
    """(start, end) of the program's spans called ``name`` that start
    inside the trace's service spans, in order."""
    starts = [s for s, _ in tr.serve]
    out = []
    for s, e, n in tr.host:
        if n != name:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < tr.serve[i][1]:
            out.append((s, e))
    return out


def cu_launched(tr):
    """``tr`` with each kernel that ``Trace`` found no runtime call for
    (its launch time is its own start) launched at the time of the next
    ``CU_LAUNCHES`` call not made inside a runtime call, both in order;
    None where the two counts differ."""
    runtime = [(s, e) for s, e, n in tr.host if n.startswith("cuda")]
    starts = [s for s, _ in runtime]

    def inside_runtime(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= runtime[i][1]
    calls = [s for s, _, n in tr.host
             if n in CU_LAUNCHES and not inside_runtime(s)]
    bare = [i for i, op in enumerate(tr.device)
            if op[3] == "kernel" and op[4] == op[0]]
    if len(bare) != len(calls):
        return None
    device = list(tr.device)
    for i, at in zip(bare, calls):
        device[i] = (*device[i][:4], at)
    return Trace(device=device, host=tr.host, serve=tr.serve)


def device_ms(run, name: str):
    """The summed device time of the operations launched inside the
    program's ``name`` spans, over the number of service spans, ms; None
    where the trace holds no program span (no ``prefill`` in a service
    span), or where its ``CU_LAUNCHES`` calls do not pair with its
    kernels."""
    tr = traced(run)
    if tr is None or not program_spans(tr, PREFILL):
        return None
    tr = cu_launched(tr)
    if tr is None:
        return None
    ops = tr.device_in(program_spans(tr, name))
    return sum(e - s for s, e, *_ in ops) / len(tr.serve) * 1e3


def cast_gb(run):
    """The program's ``cast_bytes`` counter over the ``prefill`` spans its
    tracer kept in memory while on (the profiler's unread first batch
    included: the counter counts it too), GB; None where it kept none or
    has no such counter."""
    from repro_torch.obs import metrics, trace
    n = sum(e["name"] == PREFILL for e in trace.get_tracer().events())
    counted = metrics.REGISTRY.snapshot()["counters"].get("cast_bytes")
    if not n or counted is None:
        return None
    return counted / n / 1e9
