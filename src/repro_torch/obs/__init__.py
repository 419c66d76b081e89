"""repro_torch.obs — observability for the benchmark subsystem.

The paper's whole argument is that a throughput number only means something
with its measurement conditions attached.  This package attaches them three
ways, each consumable on its own:

* ``trace``   — a zero-dependency span tracer (stdlib only).  Off by
  default; enabled via ``--trace`` on the CLI, ``REPRO_TRACE=1`` in the
  environment, or ``trace.configure(enabled=True)`` in code.  The Runner,
  the backends and the timing loop are instrumented; spans export as JSON-lines or Chrome trace-event JSON
  (loadable in Perfetto / ``chrome://tracing``).
* ``metrics`` — a counter/gauge registry (cache hits/misses, buffers
  built/released, peak resident working-set bytes, audit waivers,
  straggler kills, adaptive rounds).  Always on (increments are dict ops
  outside the timed path); every ``Runner.run`` snapshots its delta into
  ``BenchResult.meta["obs"]`` (result schema v6).
* ``ledger``  — a persistent on-disk run history (``BENCH_history/``):
  every CLI ``run`` invocation appends one compact record (spec digest,
  machine identity, per-mix bandwidth curves with noise statistics,
  latency knees, trace path); ``ledger.diff_records`` gates regressions
  with a noise-aware two-sample test.

Import discipline: ``trace`` and ``metrics`` import ONLY the stdlib (they
are safe from any module, including ``core.timing``); ``ledger`` defers its
``repro_torch.bench`` import into a function body.
"""
from repro_torch.obs import ledger, metrics, trace
from repro_torch.obs.ledger import append_record, diff_records, read_ledger
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import Tracer, configure, get_tracer

__all__ = [
    "trace", "metrics", "ledger",
    "Tracer", "configure", "get_tracer",
    "REGISTRY", "MetricsRegistry",
    "append_record", "read_ledger", "diff_records",
]
