"""Zero-dependency span tracer — where does the wall-clock of a run go?

A benchmark harness that cannot show its own phase breakdown (compile vs
warmup vs timed reps vs buffer churn) invites exactly the unlabeled-number
mistakes the paper warns against.  This tracer is deliberately tiny:

* stdlib only — importable from anywhere (``core.timing`` uses it inside
  the repetition loop) without dragging torch/numpy in;
* **off by default** and cheap when off: ``Tracer.span`` returns a shared
  no-op context manager without allocating, and the hot timed path in
  ``core.timing.time_fn`` checks ``enabled`` ONCE and runs the original
  untraced loop when tracing is off (zero per-rep overhead — guarded by a
  test);
* thread-safe (one lock around the event list, a thread-local span stack
  for depth/nesting) and process-aware (every event records its OS pid;
  ``merge_process_traces`` re-stamps per-process event streams for the
  distributed gather);
* exception-balanced: a span records its close in ``__exit__`` even when
  the body raises (the event gains an ``error`` arg), so traces from
  failed runs still load.

Span taxonomy (the instrumented subset of the reference package's map):
``runner.run`` > ``runner.plan`` / ``runner.size`` > ``case.build`` /
``buffers.build`` / ``runner.case`` > ``timing.warmup`` / ``timing.rep``;
``backend.<name>.make_case`` under the plan; ``launch.child`` and
``characterize.round`` at top level in their own processes.  Instant
events: ``cache`` (hit/miss), ``buffers.release``,
``launch.straggler_kill``, ``characterize.bisect``.

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
import threading
import time
from pathlib import Path

TRACE_FORMAT = "repro.obs/v1"

#: environment switch: any non-empty value enables the default tracer at
#: import time (the CLI's ``--trace`` flag does the same at parse time)
TRACE_ENV = "REPRO_TRACE"


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a single ``"X"`` complete event on exit."""
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
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
        """Context manager timing a phase; no-op (and allocation-free)
        while disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

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
    """Module-level convenience on the default tracer."""
    return _TRACER.span(name, cat=cat, **args)


def event(name: str, cat: str = "bench", **args) -> None:
    _TRACER.event(name, cat=cat, **args)


# ---------------------------------------------------------------------------
# multi-process merge + trace analysis helpers
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


def validate_chrome(doc: dict) -> list[str]:
    """Structural checks on a Chrome trace-event document; returns a list
    of problems (empty = valid).  This is the schema the obs CI gate and
    the trace tests assert — Perfetto is lenient, the gate is not."""
    problems = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, e in enumerate(evs):
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in e:
                problems.append(f"event {i} missing {k!r}: {e}")
                break
        else:
            if e["ph"] not in ("X", "i", "M", "C"):
                problems.append(f"event {i} has unknown phase {e['ph']!r}")
            if e["ph"] == "X" and not (isinstance(e.get("dur"), (int, float))
                                       and e["dur"] >= 0):
                problems.append(f"event {i} ('{e['name']}') bad dur: "
                                f"{e.get('dur')!r}")
    return problems


def span_tree(events: list[dict]) -> dict:
    """Group complete-span events into per-(pid, tid) lists sorted by start
    time — nesting is recoverable from interval containment + ``depth``."""
    by_track: dict[tuple, list[dict]] = {}
    for e in events:
        if e.get("ph") == "X":
            by_track.setdefault((e["pid"], e["tid"]), []).append(e)
    for track in by_track.values():
        track.sort(key=lambda e: e["ts"])
    return by_track


def span_coverage(events: list[dict], root: str = "runner.run") -> float:
    """Fraction of the (longest) ``root`` span's duration covered by its
    direct children — the ≥95% wall-clock accounting check.  Returns 0.0
    when no root span is present."""
    roots = [e for e in events if e.get("ph") == "X" and e["name"] == root]
    if not roots:
        return 0.0
    r = max(roots, key=lambda e: e["dur"])
    if r["dur"] <= 0:
        return 0.0
    depth = r.get("args", {}).get("depth", 0)
    lo, hi = r["ts"], r["ts"] + r["dur"]
    covered = 0.0
    for e in events:
        if (e.get("ph") == "X" and e is not r
                and e.get("pid") == r["pid"] and e.get("tid") == r["tid"]
                and e.get("args", {}).get("depth") == depth + 1
                and e["ts"] >= lo - 1e-6 and e["ts"] + e["dur"] <= hi + 1e-6):
            covered += e["dur"]
    return covered / r["dur"]
