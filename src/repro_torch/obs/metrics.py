"""Counter/gauge registry — the numbers the trace's events add up to.

Stdlib-only and always on: increments are dict operations under one lock,
all of them on setup/teardown paths (plan, buffer build/release, cache
lookup, launcher supervision) — never inside the timed repetition loop, so
the measurement discipline is untouched.  The one in a model's call
(``cast_bytes``) counts only while spans are on, in a traced run.

Canonical counter names (what ``BenchResult.meta["obs"]`` carries — the
set is open, these are the ones the built-in instrumentation emits):

    cache_hits / cache_misses      Runner compiled-case cache outcomes
    buffers_built / buffers_released   lazy working-set lifecycle
    audit_waivers                  audit cases reported-but-not-checked
    straggler_kills                launcher processes killed after a peer
                                   failure or timeout
    adaptive_rounds                characterize refinement rounds driven
    cast_bytes                     bytes ``models.common.cast_compute``
                                   read from its source where it changed
                                   the dtype, while spans are on
                                   (``trace.on``: tracing enabled or a
                                   torch profiler recording)

Gauges:

    peak_working_set_bytes         high-water resident working set (the
                                   Runner's one-size-at-a-time discipline,
                                   made observable)

``Runner.run`` wraps itself in ``REGISTRY.scope()`` and stores the *delta*
(what this run did, not process-lifetime totals) into
``meta["obs"]["counters"]`` / ``["gauges"]`` — so the counters match the
run's own trace events one-for-one, which the obs CI gate asserts.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager


class MetricsRegistry:
    """Named monotonically increasing counters + high-water gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}

    # -- recording ----------------------------------------------------------
    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge_max(self, name: str, value: float) -> None:
        """High-water gauge: keeps the max ever seen (e.g. peak bytes)."""
        with self._lock:
            if value > self._gauges.get(name, float("-inf")):
                self._gauges[name] = value

    # -- reading ------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()

    @contextmanager
    def scope(self):
        """Yields a handle whose ``.delta()`` is the counter increments (and
        gauge values touched) since the scope opened — per-run accounting on
        a shared registry."""
        before = self.snapshot()
        handle = _Scope(self, before)
        yield handle

    def delta_since(self, before: dict) -> dict:
        after = self.snapshot()
        counters = {}
        for k, v in after["counters"].items():
            d = v - before["counters"].get(k, 0)
            if d:
                counters[k] = int(d) if float(d).is_integer() else d
        gauges = {k: v for k, v in after["gauges"].items()
                  if before["gauges"].get(k) != v}
        return {"counters": counters, "gauges": gauges}


class _Scope:
    def __init__(self, registry: MetricsRegistry, before: dict):
        self._registry = registry
        self._before = before

    def delta(self) -> dict:
        return self._registry.delta_since(self._before)


#: the process-wide default registry (what the built-in instrumentation
#: increments; tests construct their own for isolation)
REGISTRY = MetricsRegistry()


def merge_obs(snapshots: list[dict]) -> dict:
    """Fold several per-run ``meta["obs"]`` payloads into one (what
    ``Runner.run_many`` stores on the merged result): counters sum, gauges
    take the max (they are high-water marks), and the ``runner`` cumulative
    block — when present — comes from the last snapshot (it already spans
    the earlier runs of the same Runner)."""
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    runner: dict | None = None
    for s in snapshots:
        for k, v in (s.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in (s.get("gauges") or {}).items():
            if k not in gauges or v > gauges[k]:
                gauges[k] = v
        runner = s.get("runner", runner)
    out = {"counters": counters, "gauges": gauges}
    if runner is not None:
        out["runner"] = runner
    return out
