"""The host-clock readers on a hand-made window of the closed loop: tokens
a second count only the batches done by the close, times to first token
run from a batch's start to its end, each request of a batch done by the
close counted, the traced batches left out."""
from __future__ import annotations

import statistics

import pytest

from chipbench import harness
from chipbench.loops.prefill import Window


def _run(started, done, traced):
    w = Window(seconds=1.0, opened=10.0, started=started, done=done,
               traced=traced)
    return harness.Run(arch={}, traffic={"batch": 2, "prompt_len": 8},
                       setup_s=3.5, seconds=1.0, window=w)


def test_readers():
    # four batches; the last ends after the close (11.0); the third traced
    run = _run([10.0, 10.2, 10.5, 10.8], [10.2, 10.5, 10.8, 11.1],
               [False, False, True, False])
    read = {n: harness.reader(n).read(run)
            for n in ("prefill_tok_s", "ttft_p95_ms", "ttft_p50_ms",
                      "setup_s")}
    assert read["prefill_tok_s"] == pytest.approx(3 * 2 * 8 / 1.0)
    ttft = [200.0] * 2 + [300.0] * 2
    q = statistics.quantiles(ttft, n=100, method="inclusive")
    assert read["ttft_p95_ms"] == pytest.approx(q[94])
    assert read["ttft_p50_ms"] == pytest.approx(q[49])
    assert read["setup_s"] == 3.5


def test_readers_find_nothing_in_an_empty_window():
    run = _run([], [], [])
    assert harness.reader("prefill_tok_s").read(run) is None
    assert harness.reader("ttft_p95_ms").read(run) is None
    for name in ("prefill_busy_ms", "prefill_mfu", "flash_roofline",
                 "device_idle_share", "launches_per_prefill"):
        assert harness.reader(name).read(run) is None


def test_mfu_and_idle_read_the_untraced_service_time():
    from chipbench.counts import model_dense, peaks
    from chipbench.trace import SERVE_SPAN, Trace
    arch = harness.load_json(harness.BENCH / "configs" /
                             "granite-3-2b.json")["arch"]
    # two untraced batches of 80 ms, one traced of 160 ms (the profiler's
    # cost on the host) whose device time is 60 ms
    w = Window(seconds=1.0, opened=10.0, started=[10.0, 10.08, 10.16],
               done=[10.08, 10.16, 10.32], traced=[False, False, True])
    w.trace = Trace.from_events([
        {"ph": "X", "cat": "user_annotation", "name": SERVE_SPAN, "ts": 0,
         "dur": 160e3},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 60e3,
         "args": {"correlation": 1}}])
    run = harness.Run(arch=arch, traffic={"batch": 1, "prompt_len": 4096},
                      setup_s=1.0, seconds=1.0, window=w)
    flops = model_dense.model_flops(arch, 1, 4096)
    assert harness.reader("prefill_mfu").read(run) == pytest.approx(
        100 * flops / (0.08 * peaks.BF16_FLOPS))
    assert harness.reader("device_idle_share").read(run) == pytest.approx(
        100 * (1 - 0.06 / 0.08))
    assert harness.reader("prefill_busy_ms").read(run) == pytest.approx(60)
