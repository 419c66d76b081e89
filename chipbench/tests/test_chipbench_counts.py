"""The counts the rooflines and the MFU divide by, against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
the CPU at small sizes: the products the reference does outside attention
are exactly the model count's; the reference's attention (whole blocks)
does at least the kernel's counted work. So
no count is above the work done, and no share can read over 100 %."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from chipbench.counts import flash, model_dense, peaks
from chipbench.loops.prefill import arch_config
from chipbench.reference import dense, ops
from chipbench.weights import make_params
from conftest import small_arch


def _flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def _params(arch):
    from repro_torch.models.registry import build
    return make_params(build(arch_config(arch)).param_specs(), 0,
                       torch.device("cpu"))


@pytest.mark.parametrize("name,ref,count", [
    ("granite-3-2b", dense, model_dense)])
@pytest.mark.parametrize("B,S", [(1, 64), (2, 32)])
def test_model_count_is_the_references_products(monkeypatch, name, ref,
                                                count, B, S):
    arch = small_arch(name)
    params = _params(arch)
    tokens = torch.randint(0, arch["vocab_size"], (B, S))
    launches = count.launches(arch, B, S)
    kernel_work = sum(flash.flops(s) for s in launches["flash"])
    # attention out of the way (an output of the right shape and no
    # products), the rest of the forward pass
    monkeypatch.setattr(ops, "causal_attention",
                        lambda rnd, q, k, v: torch.zeros_like(q))
    with torch.inference_mode():
        rest = _flops(ref.forward, arch, params, tokens)
    assert rest == count.model_flops(arch, B, S) - kernel_work


@pytest.mark.parametrize("B,S,H,KV,D", [(1, 64, 4, 2, 32), (2, 128, 8, 8, 16),
                                        (1, 1024, 2, 1, 64)])
def test_flash_count_at_most_the_references_attention(B, S, H, KV, D):
    q = torch.randn(B, S, H, D)
    k = torch.randn(B, S, KV, D)
    v = torch.randn(B, S, KV, D)
    done = _flops(ops.causal_attention, ops.exact, q, k, v)
    shape = {"B": B, "S": S, "H": H, "KV": KV, "D": D, "Dv": D}
    # the reference multiplies whole blocks, the kernel's need is the
    # causal half: between a half and all of the reference's products
    assert done / 2 <= flash.flops(shape) <= done
    assert flash.nbytes(shape) == 2 * (q.numel() + k.numel() + v.numel()
                                       + q.numel())


def test_full_size_counts():
    """The counts at the cells' shapes, as ``PERF.md`` quotes them."""
    from chipbench import harness
    g = harness.load_json(harness.BENCH / "configs" / "granite-3-2b.json")
    assert model_dense.model_flops(g["arch"], 1, 4096) == pytest.approx(
        22.7e12, rel=0.01)
    assert len(model_dense.launches(g["arch"], 8, 512)["flash"]) == 40
    assert peaks.bound_s(989e12, 0) == 1.0
