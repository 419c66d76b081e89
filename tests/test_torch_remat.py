"""The port's training variants against the JAX package and against each
other, on the CPU: ``remat_wrap`` (full, dots, none), the ``folded``
causal attention, the moe dispatch with capacity drops.  The models,
batches, bounds and the reference's side are ``tests/test_torch_train.py``'s
(reduced width, batch 2, 64 tokens)."""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.variant import VARIANTS as J_VARIANTS
from repro_torch.models import moe
from repro_torch.models.common import tree_leaves
from repro_torch.models.variant import BASELINE
from test_torch_train import (B, GRAD_RMS_TOL, S, batch_from_reference,
                              case, hold,
                              params_from_reference, port_value_and_grad,
                              ref_value_and_grad, rel_rms)

#: a KV block below S, so that the folded variant folds (4 blocks of 16)
FOLD_BLOCK = 16


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_gradients_with_capacity_drops(arch):
    """``cap_0.5``: C = ceil(128 x 2 / 4 x 0.5) = 32 slots an expert for
    the 64 choices each takes on average, so choices drop (sent to the
    dispatch's spare row, their weight zeroed); the gradients through the
    ``index_put`` dispatch and the gate's ``topv`` still match the
    reference's scatter."""
    cfg = case(arch)[1]
    jv = replace(J_VARIANTS["baseline"], moe_capacity_factor=0.5)
    ref = ref_value_and_grad(arch, jv)
    C = moe.capacity(cfg, B * S, 0.5)
    assert C == 32
    for _, topi in ref[3][:cfg.n_layers]:
        per_expert = np.bincount(np.asarray(topi).ravel(),
                                 minlength=cfg.moe.n_experts)
        assert per_expert.max() > C, per_expert      # some choices drop
    port = port_value_and_grad(
        arch, replace(BASELINE, moe_capacity_factor=0.5), ref[3])
    hold(ref, port, cfg, f"{arch} with drops")
    # the dropped choices reach no expert weight: the router's gradient
    # flows through the kept choices' weights and the aux loss only
    assert np.all(np.isfinite(port[2]["/blocks/moe/router"]))


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b",
                                  "deepseek-v2-236b"])
def test_remat_modes_give_the_same_gradients(arch):
    """``remat`` full, dots and none recompute (or keep) the same
    operations on the same inputs: the loss and every gradient leaf are
    bit-equal on the CPU (zamba2: the hybrid's nested remat)."""
    out = {r: port_value_and_grad(arch, replace(BASELINE, remat=r),
                                  ref_value_and_grad(arch)[3])
           for r in ("full", "dots", "none")}
    for r in ("dots", "none"):
        assert out[r][0] == out["full"][0]
        for p, g in out["full"][2].items():
            assert np.array_equal(out[r][2][p], g), (r, p)


class CountOps(TorchDispatchMode):
    """Counts the aten operations run under it: all of them, and the
    matrix products without a batch dimension (``mm`` / ``addmm``)."""

    def __init__(self):
        super().__init__()
        self.ops = self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def backward_ops(arch: str, remat: str) -> tuple[int, int]:
    """(operations, mm products) the backward pass of one port loss runs
    under the remat mode: its own, and what it recomputes."""
    _, cfg, _, m, jp, jb = case(arch)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    tb = batch_from_reference(jax.tree.map(np.asarray, jb))
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = m.loss(tp, tb, None, replace(BASELINE, remat=remat))
    with CountOps() as count:
        torch.autograd.grad(loss, leaves)
    return count.ops, count.mm


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b"])
def test_remat_recomputes_what_it_does_not_keep(arch):
    """Only memory and recompute differ: ``none`` keeps every activation
    and recomputes nothing, ``dots`` keeps the projections (every
    ``mm``) and recomputes the rest, ``full`` keeps each checkpointed
    body's inputs and recomputes the whole body, its projections too."""
    ops = {r: backward_ops(arch, r) for r in ("none", "dots", "full")}
    assert ops["none"][0] < ops["dots"][0] < ops["full"][0], ops
    assert ops["none"][1] == ops["dots"][1] < ops["full"][1], ops


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v2-236b",
                                  "zamba2-2.7b"])
def test_folded_attention(arch):
    """``attn_variant="folded"`` at a KV block of 16 (4 blocks of the 64
    tokens): query block i visits KV blocks [0, i] only.  Against the
    reference's folded variant, to the bounds of the masked one.  Against
    the port's masked attention at the same block: the blocks it skips are
    fully masked there and add exactly 0, so the loss is bit-equal; the
    gradients part by bf16 roundings, not ulps: folded sums each key and
    value block's gradient over the query blocks in bf16 (k and v's
    dtype), masked once in float32.  The reference parts the same way
    (measured, worst leaf folded against masked: reference 0.0062, 0.0075,
    0.0038 for granite, deepseek, zamba2; port 0.0062, 0.0073, 0.0039), so
    the port's is held to GRAD_RMS_TOL."""
    cfg = case(arch)[1]
    folded = replace(BASELINE, attn_variant="folded", kv_block=FOLD_BLOCK)
    jv = replace(J_VARIANTS["baseline"], attn_variant="folded",
                 kv_block=FOLD_BLOCK)
    ref = ref_value_and_grad(arch, jv)
    port = port_value_and_grad(arch, folded, ref[3])
    hold(ref, port, cfg, f"{arch} folded")
    masked = port_value_and_grad(arch, replace(folded, attn_variant="masked"),
                                 ref[3])
    assert masked[0] == port[0]
    for p, g in port[2].items():
        assert rel_rms(masked[2][p], g) <= GRAD_RMS_TOL, p


