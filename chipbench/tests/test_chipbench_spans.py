"""The readers of the program's spans (``chipbench/spans.py``): on a
hand-made Chrome trace, device operations put down to the span whose call
launched them, only inside the service spans; nothing read where the
program records no span; the cast counter over the kept prefills; and a
traced run on the CPU, where the counter reads and the device readers
find no device operation."""
from __future__ import annotations

import math
import time

import pytest
import torch

from chipbench import harness
from chipbench.loops.prefill import Window, arch_config
from chipbench.trace import SERVE_SPAN, Trace, breakdown
from conftest import CELLS, small_cell
from repro_torch.models.common import tree_leaves_with_paths
from repro_torch.models.registry import build
from repro_torch.obs import metrics, trace

DEVICE_READERS = ("attn_device_ms", "mlp_device_ms", "cast_device_ms")


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(at, corr, name, start, dur):
    """A launch at host time ``at`` and its kernel on the device."""
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 1, corr),
            _x("kernel", name, start, dur, corr)]


def _cu_launch(at, corr, name, start, dur):
    """A launch by ``cuLaunchKernelEx`` (cuBLAS's), which ``Trace`` finds
    no runtime call for."""
    return [_x("cuda_driver", "cuLaunchKernelEx", at, 1, corr),
            _x("kernel", name, start, dur, corr)]


def _prefill(t0, corr):
    """One prefill's program spans at ``t0`` (us): the embedding's cast,
    a layer's attention (a weight cast, a GEMM launched by
    ``cuLaunchKernelEx`` that runs only once the MLP's span has opened,
    and flash) and MLP (a weight cast and a GEMM), the head; a
    ``cuLaunchKernel`` inside a runtime call is that call's own launch."""
    return [
        _x("cpu_op", "prefill", t0, 100),
        _x("cpu_op", "cast", t0 + 1, 3),
        *_launch(t0 + 2, corr, "embed_cast", t0 + 3, 2),
        _x("cuda_driver", "cuLaunchKernel", t0 + 2.5, 0.2, corr),
        _x("cpu_op", "prefill.attn", t0 + 10, 30),
        _x("cpu_op", "cast", t0 + 11, 4),
        *_launch(t0 + 12, corr + 1, "w_cast", t0 + 12.5, 4),
        *_cu_launch(t0 + 16, corr + 6, "q_gemm", t0 + 41, 3),
        *_launch(t0 + 20, corr + 2, "flash_fwd_tc", t0 + 44, 15),
        _x("cpu_op", "prefill.mlp", t0 + 40, 40),
        _x("cpu_op", "cast", t0 + 41, 4),
        *_launch(t0 + 42, corr + 3, "w_cast", t0 + 59, 6),
        *_cu_launch(t0 + 50, corr + 4, "gemm", t0 + 65, 25),
        *_launch(t0 + 90, corr + 5, "head_gemm", t0 + 91, 5),
    ]


#: the profiler's unread first batch (no service span), then two traced
EVENTS = (_prefill(0, 100)
          + [_x("user_annotation", SERVE_SPAN, 1000, 200)]
          + _prefill(1050, 200)
          + [_x("user_annotation", SERVE_SPAN, 2000, 200)]
          + _prefill(2050, 300))


def _run(events):
    w = Window(seconds=1.0, opened=10.0, started=[10.0], done=[10.1],
               traced=[False])
    w.trace = Trace.from_events(events)
    return harness.Run(arch={}, traffic={"batch": 1, "prompt_len": 8},
                       setup_s=1.0, seconds=1.0, window=w)


def test_device_time_by_program_span():
    run = _run(EVENTS)
    read = {n: harness.reader(n).read(run) for n in DEVICE_READERS}
    # a prefill: attention 4 + 3 + 15, MLP 6 + 25, casts 2 + 4 + 6 (us);
    # the q GEMM by its own start would read in the MLP and a cast
    assert read["attn_device_ms"] == pytest.approx(22e-3)
    assert read["mlp_device_ms"] == pytest.approx(31e-3)
    assert read["cast_device_ms"] == pytest.approx(12e-3)
    busy = harness.reader("prefill_busy_ms").read(run)
    assert busy == pytest.approx((2 + 22 + 31 + 5) * 1e-3)


def test_unpaired_cu_launches_read_nothing():
    """A ``cuLaunchKernelEx`` the trace holds no kernel for: the kernels it
    launched cannot be placed, and nothing is read."""
    extra = _x("cuda_driver", "cuLaunchKernelEx", 2060, 1, 999)
    run = _run(EVENTS + [extra])
    for name in DEVICE_READERS:
        assert harness.reader(name).read(run) is None


def test_idle_gaps_name_the_program_spans():
    tr = _run(EVENTS).window.trace
    gaps = dict(breakdown(tr, tr.serve)["idle_gaps"])
    # the device idle while the host is in the attention, past its cast
    assert gaps["prefill.attn"] == pytest.approx(2 * 24.5e-6)


@pytest.mark.parametrize("name", DEVICE_READERS)
def test_no_program_span_reads_nothing(name):
    no_spans = [e for e in EVENTS if e["cat"] != "cpu_op"]
    assert harness.reader("prefill_busy_ms").read(_run(no_spans))
    assert harness.reader(name).read(_run(no_spans)) is None


def test_cast_gb_over_the_kept_prefills(monkeypatch):
    tracer, registry = trace.Tracer(enabled=True), metrics.MetricsRegistry()
    monkeypatch.setattr(trace, "_TRACER", tracer)
    monkeypatch.setattr(metrics, "REGISTRY", registry)
    run = _run(EVENTS)
    assert harness.reader("cast_gb").read(run) is None
    for _ in range(4):
        with tracer.span("prefill", cat="model"):
            registry.inc("cast_bytes", 2.5e9)
    assert harness.reader("cast_gb").read(run) == pytest.approx(2.5)


@pytest.mark.parametrize("workload", list(CELLS))
def test_traced_run_reads_the_cast_counter(workload, monkeypatch):
    """A ``--trace 1`` run on the CPU (its own tracer and counters, as a
    run's process has): the cast counter reads the float32 bytes a
    prefill casts; the device readers find no device operation here, and
    read nothing."""
    monkeypatch.setattr(trace, "_TRACER", trace.Tracer())
    monkeypatch.setattr(metrics, "REGISTRY", metrics.MetricsRegistry())
    arch, traffic = small_cell(workload)
    r = harness.execute(workload, 2 ** 31 + 97, 0.5, True,
                        time.perf_counter(), device=torch.device("cpu"),
                        arch_override=arch, traffic_override=traffic)
    assert r["correct"], r["checks"]
    specs = build(arch_config(arch)).param_specs()
    weights = sum(math.prod(s.shape) * 4
                  for name, s in tree_leaves_with_paths(specs)
                  if not name.endswith("/scale"))
    rows = traffic["batch"] * traffic["prompt_len"] * arch["d_model"] * 4
    assert r["metrics"]["cast_gb"]["value"] == pytest.approx(
        (weights + rows) / 1e9)
    assert not set(DEVICE_READERS) & set(r["metrics"])
