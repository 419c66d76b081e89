"""The control of the comparison: the plain reference put in the program's
place with float8 (e4m3, one scale a tensor) products, one precision below
the bfloat16 compute the configurations state, served through the loop and
read by the harness's own comparison. It has to come out not correct under
each cell's limits: on the CPU at a small size here, and on the card at
the cell's own size (``-m chip``)."""
from __future__ import annotations

import time

import pytest
import torch

from chipbench import check, harness
from chipbench.loops import prefill
from conftest import CELLS, small_cell

SEEDS = (2 ** 31 + 3, 2 ** 32 + 17, 5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", list(CELLS))
def test_control_fails_small(workload, seed, monkeypatch):
    monkeypatch.setattr(prefill.PrefillCell, "serve", check.control_serve)
    arch, traffic = small_cell(workload)
    r = harness.execute(workload, seed, 0.3, False, time.perf_counter(),
                        device=torch.device("cpu"), arch_override=arch,
                        traffic_override=traffic)
    assert r["notes"]["compared"]["batches"] > 0
    assert not r["correct"], r["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", list(CELLS))
def test_control_fails_on_the_card(workload, seed, cuda_device, monkeypatch):
    monkeypatch.setattr(prefill.PrefillCell, "serve", check.control_serve)
    r = harness.execute(workload, seed, 48.0, False, time.perf_counter(),
                        device=cuda_device)
    assert not r["correct"], r["checks"]
