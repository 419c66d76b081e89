"""The trace reduction on a hand-made Chrome trace: device operations
placed in a prefill by the call that launched them, busy and idle time
inside the service spans, the host operation over each gap."""
from __future__ import annotations

import pytest

from chipbench.trace import SERVE_SPAN, Trace, breakdown, total


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", SERVE_SPAN, 0, 100),
    _x("cpu_op", "aten::mm", 5, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 2, corr=2),
    # launched inside the span; its device clock reads before the span
    _x("kernel", "gemm", -3, 23, corr=1),
    _x("kernel", "flash_fwd_tc", 40, 30, corr=2),
    _x("cpu_op", "aten::copy_", 70, 25),
    _x("gpu_memcpy", "Memcpy DtoH", 80, 10, corr=3),
    _x("user_annotation", SERVE_SPAN, 200, 50),
    _x("cuda_runtime", "cudaLaunchKernel", 201, 1, corr=4),
    _x("kernel", "gemm", 210, 30, corr=4),
    # between the spans: launched outside either
    _x("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=5),
    _x("kernel", "stray", 150, 10, corr=5),
]


def test_reduction():
    tr = Trace.from_events(EVENTS)
    us = 1e-6
    assert tr.serve == [(0, 100 * us), (200 * us, 250 * us)]
    assert tr.window() == (0, 250 * us)
    names = [op[2] for op in tr.device_in(tr.serve, ("kernel",))]
    assert names == ["gemm", "flash_fwd_tc", "gemm"]
    assert total(tr.busy(tr.serve)) == pytest.approx((20 + 30 + 10 + 30)
                                                      * us)
    gaps = tr.idle_gaps(tr.serve)
    assert total(gaps) == pytest.approx((150 - 90) * us)
    assert gaps[0] == pytest.approx((20 * us, 40 * us))
    bd = breakdown(tr, tr.serve)
    assert bd["device_ops"][0] == ["gemm", pytest.approx(53 * us)]
    gap_by = dict(bd["idle_gaps"])
    assert gap_by["aten::copy_"] == pytest.approx(20 * us)
    assert gap_by["cudaLaunchKernel"] == pytest.approx(20 * us)
    assert gap_by["host idle"] == pytest.approx(20 * us)
    assert tr.host_op_at(21 * us) == "aten::mm"
    assert tr.host_op_at(150.5 * us) == "cudaLaunchKernel"
    assert tr.host_op_at(175 * us) == "host idle"
