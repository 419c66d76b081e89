"""Reading a device trace: the profiler's Chrome trace reduced to the
intervals the per-layer metrics read.

A ``Trace`` holds, in seconds on the trace's own clock: the device's
operations (kernels, copies, sets) with their names, the host's operators,
and the service spans (``chipbench.serve``) the loop opens around each
traced prefill, from the tokens' copy to the device to the first tokens
back on the host.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

SERVE_SPAN = "chipbench.serve"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class Trace:
    #: (start, end, name, cat, launched): ``launched`` is the host time of
    #: the call that launched the operation
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)     # (start, end, name)
    serve: list = field(default_factory=list)    # (start, end)
    _host_starts: list = field(default_factory=list, repr=False)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return cls.from_events(events)

    @classmethod
    def from_events(cls, events) -> "Trace":
        """A device operation is placed in time by its own start, and in a
        service span by the host call that launched it (the runtime event
        of the same ``correlation``), so that the two clocks' offset
        moves no operation out of the prefill that launched it."""
        t = cls()
        launched = {e["args"]["correlation"]: float(e["ts"]) * 1e-6
                    for e in events if e.get("cat") == "cuda_runtime"
                    and "correlation" in e.get("args", {})}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"]) * 1e-6
            iv = (s, s + float(e["dur"]) * 1e-6)
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                at = launched.get(e.get("args", {}).get("correlation"), s)
                t.device.append((*iv, e.get("name", "?"), cat, at))
            elif cat in HOST_CATS:
                if e.get("name") == SERVE_SPAN:
                    t.serve.append(iv)
                elif cat != "user_annotation":
                    t.host.append((*iv, e.get("name", "?")))
        t.device.sort()
        t.host.sort()
        t.serve.sort()
        t._host_starts = [h[0] for h in t.host]
        return t

    # -- intervals -----------------------------------------------------------
    def window(self) -> tuple[float, float]:
        """From the first traced prefill's start to the last one's end."""
        return self.serve[0][0], self.serve[-1][1]

    def device_in(self, spans, cats=DEVICE_CATS) -> list:
        """The device operations of ``cats`` launched inside one of
        ``spans``."""
        starts = [s for s, _ in spans]
        out = []
        for op in self.device:
            if op[3] not in cats:
                continue
            i = bisect.bisect_right(starts, op[4]) - 1
            if i >= 0 and op[4] < spans[i][1]:
                out.append(op)
        return out

    def busy(self, spans) -> list:
        """The union of the device's operation intervals, clipped to
        ``spans`` (sorted, disjoint)."""
        merged: list = []
        for s, e, *_ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        ends = [e for _, e in merged]
        out = []
        for a, b in spans:
            for s, e in merged[bisect.bisect_right(ends, a):]:
                if s >= b:
                    break
                out.append((max(s, a), min(e, b)))
        return out

    def idle_gaps(self, spans) -> list:
        """(start, end) of every stretch of ``spans`` with nothing running
        on the device."""
        busy = self.busy(spans)
        gaps = []
        j = 0
        for a, b in spans:
            at = a
            while j < len(busy) and busy[j][0] < b:
                s, e = busy[j]
                if s > at:
                    gaps.append((at, s))
                at = max(at, e)
                j += 1
            if at < b:
                gaps.append((at, b))
        return gaps

    def host_op_at(self, t: float) -> str:
        """The innermost host operation running at ``t`` (the one that
        started last of those that cover it), or "host idle"."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - 2000, -1), -1):
            if self.host[j][1] >= t:
                return self.host[j][2]
        return "host idle"


def total(intervals) -> float:
    return sum(b - a for a, b, *_ in intervals)


def breakdown(trace: Trace, spans, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps summed by the host operation running over each, seconds."""
    ops: dict = defaultdict(float)
    for s, e, name, *_ in trace.device_in(spans):
        ops[name[:160]] += e - s
    gaps: dict = defaultdict(float)
    for a, b in trace.idle_gaps(spans):
        gaps[trace.host_op_at((a + b) / 2)[:160]] += b - a

    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": best(ops), "idle_gaps": best(gaps)}
