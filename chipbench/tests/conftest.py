"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest -q chipbench/tests`` from the checkout's root; the card
tests with ``-m chip`` on a machine with an H100)."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA device (an H100); skips here")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def small_arch(config_name: str, full_depth: bool = False) -> dict:
    """The configuration's ``arch`` at the program's reduced CPU size
    (every width cut, same family and topology; 2 layers, or with
    ``full_depth`` the configuration's own layers and attention period,
    where rounding grows as it does at full size)."""
    from repro_torch.configs import get_arch, reduced
    whole = get_arch(config_name)
    d = dataclasses.asdict(reduced(whole))
    for k in ("moe", "mla", "ssm"):
        if d.get(k) is None:
            d.pop(k, None)
    d.pop("source", None)
    if full_depth:
        d["n_layers"], d["attn_every"] = whole.n_layers, whole.attn_every
    return d


def _cells() -> dict:
    from chipbench import harness
    spec = harness.bench()
    return {w["name"]: harness.cell(spec, w["name"])
            for w in spec["workloads"]}


#: the cells of ``BENCHMARK.json`` by name (the harness's view of each)
CELLS = _cells()


def small_cell(workload: str) -> tuple[dict, dict]:
    """A cell's ``arch`` at the CPU size, full depth, and its traffic with
    the batch kept and prompts cut to 256 tokens a batch or fewer."""
    c = CELLS[workload]
    t = c["traffic"]
    S = min(t["prompt_len"], 256 // max(t["batch"], 4))
    return (small_arch(c["arch"]["name"], full_depth=True),
            dict(t, prompt_len=S))
