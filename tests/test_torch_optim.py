"""The port's optimiser side (``repro_torch.optim.adamw``,
``repro_torch.optim.compression``, ``repro_torch.train.step``) against the
JAX package, on the CPU.

AdamW and the compression are held on identical float32 inputs, carried
across as numpy: to ULPS float32 units in the last place (AdamW) and equal
int8 codes with scales within one ulp (compression).  A whole train step is
held on its loss and gradient norm, and on its update only where the sign
of the step is settled: at step 1 Adam's update is about ±lr per element
whatever the gradient's size, so an element whose tiny gradient differs in
sign between the frameworks (their bf16 gradients part by up to 0.0133
relative RMS a leaf, ``tests/test_torch_train.py``, and elementwise by up
to ~2 % of the leaf's RMS) moves 2 lr apart.  Elements with |g_ref| above
SETTLED (10 %) of their leaf's RMS gradient and well above Adam's eps are
compared.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                     # optional dep; see pyproject [test]
    from _hypothesis_stub import given, settings, st

from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro.train.step import make_train_step as j_make_train_step
from repro.models.variant import VARIANTS as J_VARIANTS
from repro_torch.convert import (batch_from_reference,
                                 params_from_reference, tree_to_reference)
from repro_torch.models.common import tree_leaves
from repro_torch.models.variant import VARIANTS
from repro_torch.optim import adamw
from repro_torch.optim.compression import (compress_grads, dequantize,
                                           init_error, quantize)
from repro_torch.train.step import make_train_step
from test_torch_models import CTX, j_compile, leaves_with_paths
from test_torch_train import case

ULPS = 4
CFG = dict(lr=1e-3, warmup_steps=10, total_steps=100)
#: Adam's eps (the configs' default): at step 1 an element's update is
#: lr g / (|g| + eps), which depends on |g| only where |g| is within a
#: few hundred eps
CFG_EPS = 1e-8
#: an element's gradient is settled (its sign and size agree between the
#: frameworks) above this share of its leaf's RMS gradient: elementwise
#: the two sides' bf16 gradients part by up to ~2 % of the leaf's RMS
#: (granite's wk: 1.59e-6 against -1.32e-6 at an RMS of 1.35e-4), so at
#: 1 % some signs flip
SETTLED = 0.1
#: steps of the schedule's three sections: warmup, cosine, past the end
STEPS = (1, 5, 10, 11, 57, 99, 100, 140)


def ulps(got, want, scale=None) -> float:
    """Largest distance in float32 units in the last place of ``want``
    (or of ``scale``, where the value is a sum whose terms are larger than
    it: an ulp of the terms is what their rounding leaves)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ref = np.abs(want) if scale is None else np.maximum(np.abs(want), scale)
    spacing = np.spacing(ref.astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(got.astype(np.float64) - want) / spacing))


def f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": {"a": (rng.standard_normal((16, 8)) * scale).astype(np.float32),
                  "b": (rng.standard_normal((4,)) * scale).astype(np.float32)},
            "stack": (rng.standard_normal((3, 5, 7)) * scale).astype(np.float32)}


def _state(params, seed, step, dtype):
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape) * 0.01, dtype), params)
    nu = jax.tree.map(lambda p: jnp.asarray(
        rng.random(p.shape) * 1e-4, dtype), params)
    return {"mu": mu, "nu": nu, "step": jnp.int32(step)}


@pytest.mark.parametrize("adam_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["noclip", "clip"])
def test_adamw_apply_matches_the_reference(step, adam_dtype, grad_scale):
    """One ``apply`` from a state at ``step - 1`` (random moments, stored
    in ``adam_dtype``) on identical gradients: the parameters, both
    moments, the step, the gradient norm and the learning rate, each within
    ULPS float32 ulps (mu, whose two terms b1 mu and (1 - b1) g may
    cancel: ulps of the larger term; bf16 moments: within one bf16
    rounding, i.e. equal or one bf16 ulp apart where the float32 values
    straddle a rounding boundary)."""
    cfg_kw = dict(CFG)
    jcfg, cfg = j_adamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    params = jax.tree.map(jnp.asarray, _tree(0))
    grads = jax.tree.map(jnp.asarray, _tree(1, grad_scale))
    state = _state(params, 2, step - 1, jnp.dtype(adam_dtype))
    jp, js, jm = jax.jit(lambda p, s, g: j_adamw.apply(jcfg, p, s, g))(
        params, state, grads)
    tp = params_from_reference(jax.tree.map(np.asarray, params))
    ts = params_from_reference(jax.tree.map(np.asarray, state))
    tg = params_from_reference(jax.tree.map(np.asarray, grads))
    tp2, ts2, tm = adamw.apply(cfg, tp, ts, tg)
    assert tp2 is tp                      # updated in place
    assert int(ts2["step"]) == int(js["step"]) == step
    assert (gnorm_clip := float(jm["grad_norm"])) > 1.0 or grad_scale < 1
    assert ulps(f32(tm["grad_norm"]), jm["grad_norm"]) <= ULPS, gnorm_clip
    assert ulps(f32(tm["lr"]), jm["lr"]) <= ULPS
    for (path, want), got in zip(leaves_with_paths(jax.tree.map(
            np.asarray, jp)), tree_leaves(tp2)):
        assert ulps(f32(got), want) <= ULPS, path
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    terms = {path: np.maximum(0.9 * np.abs(np.asarray(m, np.float32)),
                              0.1 * clip * np.abs(g))
             for (path, m), (_, g) in zip(
                 leaves_with_paths(jax.tree.map(np.asarray, state["mu"])),
                 leaves_with_paths(jax.tree.map(np.asarray, grads)))}
    for k in ("mu", "nu"):
        for (path, want), got in zip(leaves_with_paths(jax.tree.map(
                np.asarray, js[k])), tree_leaves(ts2[k])):
            assert str(got.dtype).removeprefix("torch.") == adam_dtype
            if adam_dtype == "float32":
                assert ulps(f32(got), want,
                            terms[path] if k == "mu" else None) <= ULPS, \
                    (k, path)
            else:
                w = np.asarray(want, np.float32)
                assert np.all(np.abs(f32(got) - w)
                              <= np.spacing(np.abs(w)) * 2 ** 16), (k, path)


def test_schedule_matches_the_reference():
    """Warmup, the cosine section and the floor after ``total_steps``,
    every step 0..150, within ULPS."""
    jcfg, cfg = j_adamw.AdamWConfig(**CFG), adamw.AdamWConfig(**CFG)
    steps = np.arange(151, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: j_adamw.schedule(jcfg, s))(steps))
    got = adamw.schedule(cfg, torch.from_numpy(steps)).numpy()
    # the cosine section sums min_lr_ratio and a term up to (1 -
    # min_lr_ratio) lr: ulps of lr, the largest term
    assert ulps(got, want, np.float32(cfg.lr)) <= ULPS
    assert got[0] == 0 and abs(got[10] - 1e-3) < 1e-9
    assert abs(got[140] - 1e-4) < 1e-9


def test_init_state_and_global_norm():
    params = params_from_reference(_tree(0))
    st = adamw.init_state(params, "bfloat16")
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert all(t.dtype == torch.bfloat16 and not t.any()
               for t in tree_leaves(st["mu"]) + tree_leaves(st["nu"]))
    want = j_adamw.global_norm(jax.tree.map(jnp.asarray, _tree(0)))
    assert ulps(f32(adamw.global_norm(params)), want) <= ULPS


def test_opt_state_crosses_bit_for_bit():
    """A bf16 moment and the int32 step cross both ways with their bits."""
    state = _state(jax.tree.map(jnp.asarray, _tree(0)), 3, 7, jnp.bfloat16)
    ts = params_from_reference(jax.tree.map(np.asarray, state))
    assert ts["step"].shape == () and int(ts["step"]) == 7
    back = tree_to_reference(ts)
    for (p, a), (_, b) in zip(leaves_with_paths(jax.tree.map(np.asarray,
                                                              state)),
                              leaves_with_paths(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_quantize_matches_the_reference(seed):
    """Equal int8 codes, scales within one ulp, also on values exactly
    half-way between two codes (round half to even on both sides)."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(257) * 10 ** rng.uniform(-4, 3)).astype(np.float32)
    g[:8] = np.float32(g.max() / 127) * np.array([0.5, 1.5, 2.5, -0.5, -1.5,
                                                  -2.5, 3.5, 126.5],
                                                 np.float32)
    jq, js = j_comp.quantize(jnp.asarray(g))
    q, s = quantize(torch.from_numpy(g))
    assert ulps(f32(s), js) <= 1
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8
    assert ulps(f32(dequantize(q, s)), j_comp.dequantize(jq, js)) <= 1


def test_compress_grads_matches_the_reference():
    grads = _tree(4)
    err = jax.tree.map(lambda a: (a * 1e-3).astype(np.float32), _tree(5))
    jd, je = j_comp.compress_grads(jax.tree.map(jnp.asarray, grads),
                                   jax.tree.map(jnp.asarray, err))
    td, te = compress_grads(params_from_reference(grads),
                            params_from_reference(err))
    for tree_j, tree_t in ((jd, td), (je, te)):
        for (path, want), got in zip(leaves_with_paths(jax.tree.map(
                np.asarray, tree_j)), tree_leaves(tree_t)):
            assert ulps(f32(got), want) <= 1 or np.allclose(
                f32(got), want, atol=1e-7), path


@settings(max_examples=20, deadline=None)
@given(st.floats(min_value=1e-4, max_value=1e3))
def test_quantize_roundtrip_bounded(scale_mag):
    g = torch.tensor([0.5, -1.0, 0.25, 1.0]) * scale_mag
    q, s = quantize(g)
    err = (dequantize(q, s) - g).abs()
    assert float(err.max()) <= float(s) / 2 * (1 + 1e-5)  # half an int8 step


def test_error_feedback_preserves_signal():
    """The sum of compressed gradients over steps tracks the true sum."""
    true_g = torch.full((64,), 0.001)        # below one int8 step
    grads = {"w": true_g}
    err = init_error(grads)
    total = torch.zeros(64)
    for _ in range(100):
        cg, err = compress_grads(grads, err)
        total = total + cg["w"]
    np.testing.assert_allclose(total.numpy(), (true_g * 100).numpy(),
                               rtol=0.15)


def test_compressed_sgd_converges():
    w = torch.tensor([5.0, -3.0, 2.0])
    target = torch.ones(3)
    err = init_error({"w": w})
    for _ in range(300):
        cg, err = compress_grads({"w": 2 * (w - target)}, err)
        w = w - 0.05 * cg["w"]
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=1e-2)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def variants(name: str):
    """(the reference's variant, the port's) of a name: a named variant, or
    ``accum2`` (baseline with two microbatches of the batch of 2)."""
    if name == "accum2":
        return (replace(J_VARIANTS["baseline"], accum_steps=2),
                replace(VARIANTS["baseline"], accum_steps=2))
    return J_VARIANTS[name], VARIANTS[name]


@functools.lru_cache(maxsize=None)
def ref_step(arch: str, variant: str, compression: bool):
    """The reference's step from its init: (params after, the gradients of
    the loss at the init, metrics, state after)."""
    jcfg, _, jm, _, jp, jb = case(arch)
    jv = variants(variant)[0]
    step = j_make_train_step(jcfg, CTX, opt_cfg=j_adamw.AdamWConfig(**CFG),
                             variant=jv, grad_compression=compression)
    state = j_adamw.init_state(jp)
    if compression:
        state["ef_error"] = j_comp.init_error(jp)
    new_p, new_s, metrics = j_compile(step, jp, state, jb)(jp, state, jb)
    grads = j_compile(jax.grad(lambda p, b: jm.loss(p, b, CTX, jv)[0]),
                      jp, jb)(jp, jb)
    return (jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, grads),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, new_s))


@pytest.mark.parametrize("arch,variant,compression", [
    ("granite-3-2b", "baseline", False),
    ("granite-3-2b", "accum2", False),
    ("granite-3-2b", "cast_bf16", False),
    ("granite-3-2b", "baseline", True),
    ("zamba2-2.7b", "baseline", False),
])
def test_train_step_matches_the_reference(arch, variant, compression):
    """One ``make_train_step`` step from the same params and batch: the
    loss within 2e-3, the gradient norm within 2e-2 relative (both sides'
    bf16 gradients, ``tests/test_torch_train.py``), the learning rate
    within ULPS, the step counter, and the update p_new - p on every
    element whose |g_ref| is above ``SETTLED`` (10 %) of its leaf's RMS,
    within 1 % of lr (at 1 % a sign flips: granite's wk).  ``accum2``: two
    microbatches, their float32 gradients summed and halved, loss and
    metrics their mean; ``cast_bf16``: bf16 weights inside the graph,
    float32 gradients on the float32 parameters; compression: int8 error
    feedback before AdamW, its residual in ``ef_error``."""
    _, cfg, _, _, jp, jb = case(arch)
    want_p, want_g, want_m, want_s = ref_step(arch, variant, compression)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    before = {p: f32(t).copy() for p, t in leaves_with_paths(tp)}
    tb = batch_from_reference(jax.tree.map(np.asarray, jb))
    step = make_train_step(cfg, None, opt_cfg=adamw.AdamWConfig(**CFG),
                           variant=variants(variant)[1],
                           grad_compression=compression)
    state = adamw.init_state(tp)
    if compression:
        state["ef_error"] = init_error(tp)
    new_p, new_s, metrics = step(tp, state, tb)
    assert int(new_s["step"]) == 1
    assert set(new_s) == set(want_s)
    assert set(metrics) == set(want_m)
    assert abs(float(metrics["loss"]) - want_m["loss"]) \
        <= 2e-3 * want_m["loss"]
    assert abs(float(metrics["grad_norm"]) - want_m["grad_norm"]) \
        <= 2e-2 * want_m["grad_norm"]
    assert ulps(f32(metrics["lr"]), want_m["lr"]) <= ULPS
    lr = float(metrics["lr"])
    wp, wg = dict(leaves_with_paths(want_p)), dict(leaves_with_paths(want_g))
    for path, got in leaves_with_paths(new_p):
        g = np.asarray(wg[path], np.float32)
        big = (np.abs(g) > SETTLED * np.sqrt(np.mean(g * g))) \
            & (np.abs(g) > 100 * CFG_EPS)
        d_port = (f32(got) - before[path])[big]
        d_ref = (np.asarray(wp[path], np.float32) - before[path])[big]
        assert big.any(), path
        assert np.max(np.abs(d_port - d_ref)) <= 0.01 * lr, path
