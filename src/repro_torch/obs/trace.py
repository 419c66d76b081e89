"""Zero-dependency span tracer — where does the wall-clock of a run go?

A benchmark harness that cannot show its own phase breakdown (compile vs
warmup vs timed reps vs buffer churn) invites exactly the unlabeled-number
mistakes the paper warns against.  This tracer is deliberately tiny:

* stdlib only — importable from anywhere (``core.timing`` uses it inside
  the repetition loop) without dragging torch/numpy in; torch is imported
  only once a span is asked for with torch already loaded;
* **off by default** and cheap when off: ``Tracer.span`` returns a shared
  no-op context manager without allocating, and the hot timed path in
  ``core.timing.time_fn`` checks ``enabled`` ONCE and runs the original
  untraced loop when tracing is off (zero per-rep overhead — guarded by a
  test);
* on while a torch profiler records, too (``on``): each span is then
  also a ``torch._C._profiler._RecordFunctionFast`` of its name, so it
  exports into the profiler's trace as a ``cpu_op`` on the profiler's
  clock, beside the device operations it launched.  ``enabled`` alone
  still chooses ``time_fn``'s loop: a profiler around a membench run does
  not change how it is timed;
* thread-safe (one lock around the event list, a thread-local span stack
  for depth/nesting) and process-aware (every event records its OS pid;
  ``merge_process_traces`` re-stamps per-process event streams for the
  distributed gather);
* exception-balanced: a span records its close in ``__exit__`` even when
  the body raises (the event gains an ``error`` arg), so traces from
  failed runs still load.

Span taxonomy: the bench (the instrumented subset of the reference
package's map): ``runner.run`` > ``runner.plan`` / ``runner.size`` >
``case.build`` / ``buffers.build`` / ``runner.case`` > ``timing.warmup``
/ ``timing.rep``; ``backend.<name>.make_case`` under the plan;
``launch.child`` and ``characterize.round`` at top level in their own
processes.  Instant events: ``cache`` (hit/miss), ``buffers.release``,
``launch.straggler_kill``, ``characterize.bisect``.  The model's prefill
(``models.transformer.DecoderLM.prefill``, category ``model``):
``prefill`` > ``prefill.attn`` / ``prefill.mlp`` once a layer (the norm,
the sublayer and its residual add), and ``cast`` (``common.cast_compute``
where the dtype changes; its source's bytes count in
``metrics.REGISTRY``'s ``cast_bytes``) under either, or under ``prefill``
for the embedding and the head.

Export formats:

* ``write(path)`` / ``to_chrome()`` — Chrome trace-event JSON (an object
  with a ``traceEvents`` list of ``"X"`` complete / ``"i"`` instant
  events), loadable in Perfetto or ``chrome://tracing``;
* ``write_jsonl(path)`` — one event object per line, headed by a
  ``{"trace_format": "repro.obs/v1", ...}`` line (grep/stream friendly).

Timestamps are microseconds relative to the tracer's epoch
(``perf_counter_ns`` at construction/``clear``); the wall-clock anchor of
the epoch is kept in the metadata so separate traces can be aligned.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path

TRACE_FORMAT = "repro.obs/v1"

#: environment switch: any non-empty value enables the default tracer at
#: import time (the CLI's ``--trace`` flag does the same at parse time)
TRACE_ENV = "REPRO_TRACE"


class _NullSpan:
    """Shared no-op context manager returned while spans are off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a single ``"X"`` complete event on exit, and
    is a profiler span of its name while a torch profiler records."""
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_depth", "_mark")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._mark = _MARK(self.name) if _profiling() else None
        if self._mark is not None:
            self._mark.__enter__()
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self._mark is not None:
            self._mark.__exit__(exc_type, exc, tb)
        stack = self._tracer._stack()
        # balance even if an inner span leaked (never happens with `with`,
        # but a trace must not corrupt on someone's manual __enter__)
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        args = dict(self.args)
        args["depth"] = self._depth
        if exc_type is not None:
            args["error"] = exc_type.__name__
        self._tracer._record({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": self._tracer._us(self._t0),
            "dur": (t1 - self._t0) / 1e3,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args,
        })
        return False        # never swallow the body's exception


class Tracer:
    """Collects span/instant events; thread-safe; one per process."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._tls = threading.local()
        self._epoch_ns = time.perf_counter_ns()
        self._epoch_unix = time.time()

    # -- internals ----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _us(self, t_ns: int) -> float:
        return (t_ns - self._epoch_ns) / 1e3

    def _record(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    # -- recording API ------------------------------------------------------
    def span(self, name: str, cat: str = "bench", **args):
        """Context manager timing a phase while the tracer is enabled or a
        torch profiler records; otherwise a no-op (and allocation-free)."""
        if self.enabled or _profiling():
            return _Span(self, name, cat, args)
        return _NULL_SPAN

    def event(self, name: str, cat: str = "bench", **args) -> None:
        """Instant event (Chrome ``"i"``, thread scope)."""
        if not self.enabled:
            return
        args = dict(args)
        args["depth"] = len(self._stack())
        self._record({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._us(time.perf_counter_ns()),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args,
        })

    # -- inspection / lifecycle --------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
        self._epoch_ns = time.perf_counter_ns()
        self._epoch_unix = time.time()

    def replace_events(self, events: list[dict]) -> None:
        """Install an externally merged event list (the distributed gather
        replaces each process's local view with the global merge)."""
        with self._lock:
            self._events = [dict(e) for e in events]

    def metadata(self) -> dict:
        return {"trace_format": TRACE_FORMAT,
                "epoch_unix_s": self._epoch_unix,
                "pid": os.getpid()}

    # -- export -------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms",
                "metadata": self.metadata()}

    def write(self, path: str | Path) -> Path:
        """Write Chrome trace JSON (or JSON-lines when path ends .jsonl)."""
        path = Path(path)
        if path.suffix == ".jsonl":
            return self.write_jsonl(path)
        path.write_text(json.dumps(self.to_chrome(), indent=1))
        return path

    def write_jsonl(self, path: str | Path) -> Path:
        path = Path(path)
        lines = [json.dumps(self.metadata())]
        lines += [json.dumps(e) for e in self.events()]
        path.write_text("\n".join(lines) + "\n")
        return path


# ---------------------------------------------------------------------------
# the torch profiler
# ---------------------------------------------------------------------------

def _watch_profiler() -> bool:
    """Install the profiler hook once torch is loaded (this module never
    imports torch first: without it no profiler can record): ``_profiling``
    then reads ``torch.autograd.profiler._is_profiler_enabled``, which the
    profiler sets on ``start`` and clears on ``stop``, and ``_MARK`` is the
    profiler's span class (``_RecordFunctionFast`` exports as ``cpu_op``;
    where it is missing, ``record_function``, which exports as
    ``user_annotation``)."""
    global _profiling, _MARK
    if "torch" not in sys.modules:
        return False
    import torch
    import torch.autograd.profiler as prof
    _MARK = getattr(torch._C._profiler, "_RecordFunctionFast",
                    prof.record_function)
    _profiling = lambda: prof._is_profiler_enabled  # noqa: E731
    return _profiling()


#: whether a torch profiler records now (``_watch_profiler`` until torch is
#: loaded and the hook installed)
_profiling = _watch_profiler
_MARK = None


# ---------------------------------------------------------------------------
# the default (per-process) tracer
# ---------------------------------------------------------------------------

_TRACER = Tracer(enabled=bool(os.environ.get(TRACE_ENV)))


def get_tracer() -> Tracer:
    return _TRACER


def configure(enabled: bool | None = None, clear: bool = False) -> Tracer:
    """Runtime switch for the default tracer (what ``--trace`` flips)."""
    if clear:
        _TRACER.clear()
    if enabled is not None:
        _TRACER.enabled = enabled
    return _TRACER


def span(name: str, cat: str = "bench", **args):
    """``Tracer.span`` on the default tracer (the check inlined: the
    model's prefill asks for hundreds of spans a call, off)."""
    if _TRACER.enabled or _profiling():
        return _Span(_TRACER, name, cat, args)
    return _NULL_SPAN


def on() -> bool:
    """Whether a span of the default tracer records now: the tracer is
    enabled, or a torch profiler records."""
    return _TRACER.enabled or _profiling()


def event(name: str, cat: str = "bench", **args) -> None:
    _TRACER.event(name, cat=cat, **args)


# ---------------------------------------------------------------------------
# multi-process merge
# ---------------------------------------------------------------------------

def merge_process_traces(per_process: list[list[dict]]) -> list[dict]:
    """Merge per-process event streams into one trace.

    ``per_process[i]`` is process i's event list; every event is re-stamped
    with ``pid = i`` (the *mesh process index*, stable and meaningful,
    unlike the OS pid which collides across hosts) and the merge is
    stable-sorted by ``(ts, pid)`` so interleaving is deterministic given
    the timestamps.  Each process's clock is its own epoch — spans stay
    internally consistent per pid; cross-pid ordering is best-effort, which
    is all a straggler investigation needs.
    """
    merged: list[dict] = []
    for i, events in enumerate(per_process):
        for e in events:
            e = dict(e)
            e["pid"] = i
            merged.append(e)
    merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    return merged

