"""The port's training side of the models (``hidden_states`` / ``loss`` of
every family, ``chunked_softmax_xent``, ``gqa_attention``, ``ssm_block``)
against the JAX package, on the CPU; ``tests/test_torch_remat.py`` holds
the variants (remat, folded attention, capacity drops) with the helpers
of this file.

Every architecture ``reduced`` (2 layers, d_model 128; the hybrid one site
of shared attention and its Mamba layers), batch 2, 64 tokens.  The
weights are the reference's ``init_params`` carried across with
``params_from_reference``, the batch is drawn from a seeded numpy generator
and carried with ``batch_from_reference``, so both sides start from the
same bits.  The reference's ``jax.value_and_grad(model.loss)`` is compiled
with ``xla_allow_excess_precision`` off, under ``make_smoke_ctx()``, as
``tests/test_torch_models.py`` says; the port's gradients come from
``torch.autograd.grad``.

Bounds.  The loss within LOSS_RTOL relative (measured <= 6.9e-5, arctic);
each gradient leaf within GRAD_RMS_TOL relative RMS, ``|g_port - g_ref| /
|g_ref|`` (measured <= 0.0133, zamba2's conv_C: the backward's bf16
cotangents round where each framework's transpose rounds them, one bf16
unit roundoff 2**-9 a rounding, and the SSD's chain holds the most).

moe and mla.  The reference's routing is recorded as
``tests/test_torch_moe.py`` records it; under its remat the forward of each
layer runs again in the backward pass, so the log holds 2 L entries (the
layers, then the layers again in reverse), and the port, whose checkpoints
recompute in the same order, is checked against each (a differing choice
must be a near-tie) and routed with the reference's choices.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as j_common
import repro.models.moe as j_moe
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.models.registry import build as j_build
from repro.models.variant import VARIANTS as J_VARIANTS
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.convert import batch_from_reference, params_from_reference
from repro_torch.models import moe
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import build
from repro_torch.models.variant import BASELINE, VARIANTS
from test_torch_models import CTX, j_compile, leaves_with_paths
from test_torch_moe import ForcedRouting, recording_moe_layer

ARCHS = sorted(list_archs())
B, S = 2, 64
#: see the module docstring for what each was measured at
LOSS_RTOL = 2e-3
GRAD_RMS_TOL = 2e-2


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@functools.lru_cache(maxsize=None)
def case(arch: str):
    """(jcfg, cfg, jm, m, reference params, reference batch) of an arch."""
    jcfg, cfg = j_reduced(j_get_arch(arch)), reduced(get_arch(arch))
    jm, m = j_build(jcfg), build(cfg)
    jp = j_common.init_params(jm.param_specs(), jax.random.key(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(np.roll(tokens, -1, axis=1))}
    if cfg.family == "encdec":
        jb["frames"] = jnp.asarray(rng.standard_normal(
            (B, cfg.n_audio_ctx, cfg.d_model)) * 0.02, jnp.bfloat16)
    return jcfg, cfg, jm, m, jp, jb


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(arch: str, variant="baseline"):
    """The reference's (loss, metrics, gradient leaves by path, routing
    log) under a variant (or the name of one); computed once a pair."""
    _, cfg, jm, _, jp, jb = case(arch)
    jv = J_VARIANTS[variant] if isinstance(variant, str) else variant
    log: list = []

    def vg(p, b):
        return jax.value_and_grad(lambda p, b: jm.loss(p, b, CTX, jv),
                                  has_aux=True)(p, b)
    with pytest.MonkeyPatch.context() as mp:
        if cfg.moe is not None:
            mp.setattr(j_moe, "moe_layer", recording_moe_layer(log))
        (loss, metrics), grads = j_compile(vg, jp, jb)(jp, jb)
    grads = dict(leaves_with_paths(jax.tree.map(np.asarray, grads)))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads, log


def port_value_and_grad(arch: str, variant=BASELINE, log=None):
    """The port's (loss, metrics, gradient leaves by path, forced routing
    or None) from the reference's params and batch."""
    _, cfg, _, m, jp, jb = case(arch)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    tb = batch_from_reference(jax.tree.map(np.asarray, jb))
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    routing = None
    with pytest.MonkeyPatch.context() as mp:
        if log is not None and cfg.moe is not None:
            routing = ForcedRouting(log, cfg.moe.top_k)
            mp.setattr(moe, "route", routing)
        loss, metrics = m.loss(tp, tb, None, variant)
        grads = torch.autograd.grad(loss, leaves)
    paths = [p for p, _ in leaves_with_paths(tp)]
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            {p: g.float().numpy() for p, g in zip(paths, grads)}, routing)


def hold(ref, port, cfg, what: str) -> None:
    rl, rm, rg, _ = ref
    pl, pm, pg, _ = port
    assert abs(pl - rl) <= LOSS_RTOL * abs(rl), (what, pl, rl)
    assert rm.keys() == pm.keys()
    for k in rm:
        assert abs(pm[k] - rm[k]) <= LOSS_RTOL * max(abs(rm[k]), 1e-6), \
            (what, k, pm[k], rm[k])
    assert rg.keys() == pg.keys()
    errs = {p: rel_rms(pg[p], rg[p]) for p in rg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RMS_TOL, (what, worst, errs[worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    """``value_and_grad(model.loss)`` of every family: dense, vlm, moe and
    mla through ``DecoderLM`` (the aux loss averaged over the layers and
    weighted into the loss), the hybrid with its nested remat, the
    ssm-only and the encdec models."""
    cfg = case(arch)[1]
    ref = ref_value_and_grad(arch)
    port = port_value_and_grad(arch, BASELINE, ref[3])
    hold(ref, port, cfg, arch)
    if cfg.moe is not None:
        assert len(ref[3]) == 2 * cfg.n_layers
        assert port[3].calls == 2 * cfg.n_layers
        assert port[3].forced <= 4
        assert set(port[1]) == {"xent", "aux"}
        assert abs(port[0] - (port[1]["xent"] + cfg.moe.aux_loss_weight
                              * port[1]["aux"])) <= 1e-6 * port[0]
    else:
        assert set(port[1]) <= {"xent", "aux"}


def test_xent_chunks_and_remainder():
    """``chunked_softmax_xent`` over chunks of 24 (two of 24 and the
    remainder of 16) equals the whole-sequence cross-entropy, and matches
    the reference's at the same chunk; the padded vocab columns take no
    probability."""
    import repro.models.common as jc
    from repro_torch.models.common import chunked_softmax_xent, lm_logits
    _, cfg, _, _, jp, _ = case("granite-3-2b")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    y = rng.integers(0, cfg.vocab_size, (B, S))
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    th = torch.from_numpy(h).to(torch.bfloat16)
    ty = torch.from_numpy(y)
    got = chunked_softmax_xent(cfg, tp["embed"], th, ty, chunk=24)
    logits = lm_logits(cfg, tp["embed"], th)
    whole = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), ty.reshape(-1))
    assert abs(float(got) - float(whole)) <= 1e-5 * float(whole)
    ref = jc.chunked_softmax_xent(j_reduced(j_get_arch("granite-3-2b")),
                                  jp["embed"], jnp.asarray(h, jnp.bfloat16),
                                  jnp.asarray(y, jnp.int32), chunk=24)
    assert abs(float(got) - float(ref)) <= 1e-5 * float(ref)


def test_variants_cross_field_for_field():
    """``VARIANTS`` holds the reference's named variants, field for field,
    so that ``--variant`` names the same knobs on both sides."""
    assert VARIANTS.keys() == J_VARIANTS.keys()
    for name, v in VARIANTS.items():
        assert v.__dict__ == J_VARIANTS[name].__dict__, name
