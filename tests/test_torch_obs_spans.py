"""The port's spans in the model's prefill (``repro_torch.obs.trace``,
``models.transformer.DecoderLM.prefill``, ``models.common.cast_compute``)
on the CPU.

A span is on while the default tracer is enabled or a torch profiler
records; under a profiler it also exports into the profiler's trace as a
``cpu_op`` on the profiler's clock, which is where the benchmark's readers
find it.  Small size: granite-3-2b ``reduced`` (2 layers, d_model 128,
vocab 512, tied head), batch 2, 16 tokens.
"""
import json
import math
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch, reduced
from repro_torch.core import timing
from repro_torch.models.common import init_params, tree_leaves_with_paths
from repro_torch.models.registry import build
from repro_torch.models.variant import BASELINE
from repro_torch.obs import metrics, trace

B, S = 2, 16
NAMES = ("prefill", "prefill.attn", "prefill.mlp", "cast")
#: a layer's weight casts: wq, wk, wv, wo; w_gate, w_up, w_down
CASTS = {"prefill.attn": 4, "prefill.mlp": 3}


@pytest.fixture(scope="module")
def granite():
    cfg = reduced(get_arch("granite-3-2b"))
    model = build(cfg)
    params = init_params(model.param_specs(),
                         torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens


@pytest.fixture
def kept():
    """The default tracer's events and switch, and the registry's
    counters, as each test found them (spans under a profiler are kept in
    memory)."""
    tr = trace.get_tracer()
    events, enabled = tr.events(), tr.enabled
    yield tr
    tr.enabled = enabled
    tr.replace_events(events)


def _prefill(granite, use_pallas=False):
    cfg, model, params, tokens = granite
    with torch.inference_mode():
        return model.prefill(params, tokens, None,
                             replace(BASELINE, use_pallas=use_pallas))


def _cast_bytes() -> float:
    return metrics.REGISTRY.snapshot()["counters"].get("cast_bytes", 0)


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel-route"])
def test_prefill_spans_export_as_cpu_ops(granite, kept, tmp_path,
                                         use_pallas):
    """Under a CPU profiler: one ``prefill``, then ``prefill.attn`` /
    ``prefill.mlp`` in turn once a layer, each with its layer's weight
    casts nested in it; the embedding's and the head's casts directly
    under ``prefill``. The logits are the same as without spans."""
    cfg = granite[0]
    plain_logits, _ = _prefill(granite, use_pallas)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits, _ = _prefill(granite, use_pallas)
    assert torch.equal(logits, plain_logits)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ours = sorted((e for e in events if e.get("name") in NAMES
                   and e.get("ph") == "X"), key=lambda e: e["ts"])
    assert {e["cat"] for e in ours} == {"cpu_op"}
    (root,) = [e for e in ours if e["name"] == "prefill"]
    layers = [e for e in ours if e["name"] in CASTS]
    assert [e["name"] for e in layers] == \
        ["prefill.attn", "prefill.mlp"] * cfg.n_layers
    assert all(_inside(e, root) for e in layers)
    casts = [e for e in ours if e["name"] == "cast"]
    assert all(_inside(c, root) for c in casts)
    for span in layers:
        assert sum(_inside(c, span) for c in casts) == CASTS[span["name"]]
    outside = [c for c in casts if not any(_inside(c, s) for s in layers)]
    # the looked-up embedding rows first, the tied head's table last
    assert len(outside) == 2
    assert outside[0]["ts"] < layers[0]["ts"]
    assert outside[1]["ts"] > layers[-1]["ts"] + layers[-1]["dur"]
    # the tracer kept the same spans in memory
    names = [e["name"] for e in kept.events() if e.get("cat") == "model"]
    assert sorted(names) == sorted(e["name"] for e in ours)


def test_no_event_without_a_profiler_and_tracing_off(granite, kept):
    assert not kept.enabled and not trace.on()
    before, counted = len(kept.events()), _cast_bytes()
    _prefill(granite)
    assert len(kept.events()) == before
    assert _cast_bytes() == counted
    assert trace.span("prefill") is trace._NULL_SPAN


@pytest.mark.parametrize("switch", ["profiler", "tracer"])
def test_cast_bytes_is_the_float32_weights_and_the_rows(granite, kept,
                                                         switch):
    """One prefill reads, where it casts, every float32 leaf of
    ``param_specs`` but the norms' scales (the tied embedding whole, for
    the head) and the embedding rows it looked up."""
    cfg, model = granite[:2]
    weights = sum(math.prod(s.shape) * 4 for name, s in
                  tree_leaves_with_paths(model.param_specs())
                  if not name.endswith("/scale"))
    rows = B * S * cfg.d_model * 4
    before = _cast_bytes()
    if switch == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            _prefill(granite)
    else:
        trace.configure(enabled=True)
        _prefill(granite)
    assert _cast_bytes() - before == weights + rows


def test_time_fn_keeps_the_untraced_loop_under_a_profiler(kept,
                                                          monkeypatch):
    """A profiler turns spans on, but ``time_fn`` chooses its loop from
    ``enabled`` alone: the timed reps open no span."""
    def refuse(*a, **k):
        raise AssertionError("time_fn took the traced loop")
    monkeypatch.setattr(trace.Tracer, "span", refuse)
    calls = []
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.on()
        t = timing.time_fn(lambda: calls.append(1), reps=3, warmup=1,
                           device="cpu")
    assert len(t.times_s) == 3 and len(calls) == 4


def test_profiler_span_falls_back_to_record_function(kept, monkeypatch,
                                                     tmp_path):
    """Without ``_RecordFunctionFast`` a span is a ``record_function``,
    which exports as ``user_annotation`` (the benchmark's readers then
    find no program span)."""
    monkeypatch.setattr(trace, "_profiling", trace._profiling)
    monkeypatch.setattr(trace, "_MARK", trace._MARK)
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    assert trace._watch_profiler() is False
    assert trace._MARK is torch.autograd.profiler.record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("prefill", cat="model"):
            torch.ones(4).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name") == "prefill"}
    assert cats == {"user_annotation"}


def test_tracer_imports_no_torch():
    """``obs.trace`` stays importable, and its spans usable, where torch
    is not loaded (``core.timing``'s import discipline)."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from repro_torch.obs import trace;"
            "trace.configure(enabled=True);"
            "span = trace.span('prefill');"
            "span.__enter__(); span.__exit__(None, None, None);"
            "print(trace.on(), len(trace.get_tracer().events()),"
            " 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, str(src)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "1", "False"]
