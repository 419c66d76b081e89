"""A whole run of each cell on the CPU at a small size (the harness's look
for a card skipped), once sound and once with the timed path broken
underneath, under the cell's own limits: the sound run comes out correct,
every fault the cell can have comes out not correct."""
from __future__ import annotations

import time

import pytest
import torch

from chipbench import harness
from chipbench.loops import prefill
from conftest import CELLS, small_cell

_serve = prefill.PrefillCell.serve


def _unchanged_state(self, tokens_host):
    """The prefill hands back its cache as it found it: zeros."""
    first, logits, cache = _serve(self, tokens_host)
    return first, logits, _map(torch.zeros_like, cache)


def _half_batch(self, tokens_host):
    """Half of the batch left out: the other half's mean stands in."""
    B = tokens_host.shape[0]
    first, logits, cache = _serve(self, tokens_host[:B // 2])

    def widen(t):
        rest = t.to(torch.float32).mean(0, keepdim=True).to(t.dtype)
        return torch.cat([t, rest.expand(B - B // 2, *t.shape[1:])])
    logits = widen(logits)
    first = torch.argmax(logits[:, :self.cfg["vocab_size"]], -1).cpu()
    return first, logits, _map_batch(widen, cache)


def _altered_token(self, tokens_host):
    """The first token altered where it is produced."""
    first, logits, cache = _serve(self, tokens_host)
    return (first + 1) % self.cfg["vocab_size"], logits, cache


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map_batch(fn, tree):
    """``fn`` over the batch dim of every cache leaf (stacked: (layers, B,
    ...))."""
    if isinstance(tree, dict):
        return {k: _map_batch(fn, v) for k, v in tree.items()}
    return torch.stack([fn(x) for x in tree])


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_token": _altered_token}


def _run(workload: str, monkeypatch, fault=None) -> dict:
    arch, traffic = small_cell(workload)
    if fault is not None:
        monkeypatch.setattr(prefill.PrefillCell, "serve", FAULTS[fault])
    return harness.execute(workload, 2 ** 31 + 99, 1.0, False,
                           time.perf_counter(), device=torch.device("cpu"),
                           arch_override=arch, traffic_override=traffic)


@pytest.mark.parametrize("workload", list(CELLS))
def test_sound_run_is_correct(workload, monkeypatch):
    r = _run(workload, monkeypatch)
    assert r["correct"], r["checks"]
    assert list(r)[-2:] == ["checks", "notes"]    # notes go to stderr
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["notes"]["compared"]["with cache"] > 0
    assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in FAULTS
    if f != "half_batch" or CELLS[w]["traffic"]["batch"] > 1])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    r = _run(workload, monkeypatch, fault)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("workload", list(CELLS))
def test_traced_run_traces_batches_after_the_close(workload):
    """A ``--trace 1`` run on the CPU: the profiler's batches come after
    the window's close, are left out of its metrics, and the run is still
    judged."""
    arch, traffic = small_cell(workload)
    r = harness.execute(workload, 2 ** 31 + 98, 1.0, True,
                        time.perf_counter(), device=torch.device("cpu"),
                        arch_override=arch, traffic_override=traffic)
    assert r["correct"], r["checks"]
    assert r["notes"]["trace"]["launches"] is not None
    assert "window_s" in r["device"] and "breakdown" in r
