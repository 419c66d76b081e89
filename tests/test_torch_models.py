"""The port's model side (``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.launch.serve``) against the JAX package, on the CPU.

Small size: ``zamba2-2.7b`` reduced to two attention sites,
``replace(reduced(cfg), n_layers=4)`` (d_model 128, 4 heads of 32, SSM 16
heads of P 16, N 16, chunk 32), batch 2, 64 tokens.  The weights are the
reference's ``init_params``, carried across with ``params_from_reference``,
so both sides compute on the same bits; tokens come from a seeded numpy
generator.

The JAX side is compiled with ``xla_allow_excess_precision`` off: by default
XLA may skip a bfloat16 rounding the code asks for inside a fused body (the
norm output feeding a projection in the scanned layers), and the port rounds
where the code says.  Whole-model comparisons are normalised by the largest
magnitude of the reference leaf: after four bfloat16 layers one rounding
that falls the other way moves later values by an ulp of the residual
stream, so an elementwise bound on small values would measure that, not the
port.  Each tolerance below says what it was measured at.
"""
import dataclasses
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as j_attn
import repro.models.common as j_common
import repro.models.ssm as j_ssm
from repro.configs import get_arch as j_get_arch
from repro.configs import param_count as j_param_count
from repro.configs import reduced as j_reduced
from repro.distributed.sharding import make_smoke_ctx
from repro.kernels.flash_attention.ops import flash as j_flash
from repro.kernels.ssd_scan.ops import ssd as j_ssd
from repro.models.registry import build as j_build
from repro.models.registry import init_cache as j_init_cache
from repro.models.variant import BASELINE as J_BASELINE
from repro_torch.configs import ArchConfig, get_arch, list_archs, param_count
from repro_torch.configs import reduced
from repro_torch.convert import (cache_from_reference, params_from_reference,
                                 tensor_from_reference)
from repro_torch.launch import serve
from repro_torch.models import attention, common, ssm
from repro_torch.models.common import init_params, spec_map, tree_leaves
from repro_torch.models.registry import build, init_cache, make_batch
from repro_torch.models.variant import BASELINE, Variant

ROOT = Path(__file__).resolve().parents[1]
CTX = make_smoke_ctx()
B, S, G = 2, 64, 4
ARCH = "zamba2-2.7b"
#: normalised max error (max |port - ref| / max |ref|) of a whole-model
#: comparison: the reference's bf16 attention tolerance.  Measured:
#: plain route <= 0.0094, kernel route against the reference with its own
#: Pallas kernels <= 0.0142, decode continuation <= 0.0092 on the logits and
#: <= 0.0135 on the final cache (the worst leaf is the SSD state each time).
MODEL_TOL = 2e-2


def T(a):
    """A JAX array -> a CPU tensor with the same bits."""
    return tensor_from_reference(np.asarray(a))


def npf(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def norm_err(ref, got) -> float:
    ref, got = npf(ref), npf(got)
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def j_compile(fn, *args):
    """jit + compile on the smoke mesh, rounding where the code says."""
    with jax.set_mesh(CTX.mesh):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})


def j_kernel_ssd(xh, dt, A, Bm, Cm, chunk):
    """The reference's ``ssd_chunked`` signature through its own Pallas SSD
    kernel (interpret mode), mapped as ``tests/test_kernels.py`` maps it."""
    Bb, Sq, H, P = xh.shape
    N = Bm.shape[-1]
    xdt = (xh.astype(jnp.float32) * dt[..., None]).astype(xh.dtype)
    dA = dt * A[None, None, :]
    per_head = lambda m: jnp.broadcast_to(m, (Bb, Sq, H, N)).transpose(
        0, 2, 1, 3).reshape(Bb * H, Sq, N)
    y, st = j_ssd(xdt.transpose(0, 2, 1, 3).reshape(Bb * H, Sq, P),
                  dA.transpose(0, 2, 1).reshape(Bb * H, Sq), per_head(Bm),
                  per_head(Cm), chunk=min(chunk, Sq))
    return (y.reshape(Bb, H, Sq, P).transpose(0, 2, 1, 3).astype(jnp.float32),
            st.reshape(Bb, H, N, P).swapaxes(-1, -2))


def j_kernel_attention(q, k, v, *, causal, **_):
    return j_flash(q, k, v, causal=causal)


@pytest.fixture(scope="module")
def setup():
    jcfg = replace(j_reduced(j_get_arch(ARCH)), n_layers=4)
    cfg = replace(reduced(get_arch(ARCH)), n_layers=4)
    jm, m = j_build(jcfg), build(cfg)
    jp = j_common.init_params(jm.param_specs(), jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefill = lambda p, t: jm.prefill(p, t, CTX, J_BASELINE)
    ref = j_compile(prefill, jp, jnp.asarray(tokens))(jp, jnp.asarray(tokens))
    # the reference's model with its own Pallas kernels in the prefill: what
    # Variant.use_pallas declares, which the reference never wires
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ssm, "ssd_chunked", j_kernel_ssd)
        mp.setattr(j_attn, "chunked_attention", j_kernel_attention)
        # a new function, so that jit traces it anew under the patch
        ref_kernels = j_compile(lambda p, t: jm.prefill(p, t, CTX, J_BASELINE),
                                jp, jnp.asarray(tokens))(jp, jnp.asarray(tokens))
    with torch.inference_mode():
        plain = m.prefill(tp, torch.from_numpy(tokens).long(), None, BASELINE)
        kern = m.prefill(tp, torch.from_numpy(tokens).long(), None,
                         replace(BASELINE, use_pallas=True))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, m=m, jp=jp, tp=tp, tokens=tokens,
                ref=ref, ref_kernels=ref_kernels, plain=plain, kern=kern)


def _hold_prefill(ref, got, cfg, tol, what):
    (jl, jc), (l, c) = ref, got
    V = cfg.vocab_size
    errs = {"logits": norm_err(np.asarray(jl)[:, :V], l[:, :V])}
    jl_pad = np.asarray(jl)[:, V:]
    assert np.all(jl_pad < -1e29) and bool(torch.all(l[:, V:] < -1e29))
    jleaves = dict(leaves_with_paths(jax.tree.map(np.asarray, jc)))
    tleaves = dict(leaves_with_paths(c))
    assert jleaves.keys() == tleaves.keys()
    for path, a in jleaves.items():
        t = tleaves[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), path
        errs[path] = norm_err(a, t)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} off by {errs[worst]:.4g} " \
                               f"of its scale (tolerance {tol}); {errs}"


# ---------------------------------------------------------------------------
# configs and parameter specs
# ---------------------------------------------------------------------------

def test_config_matches_the_reference():
    j, t = j_get_arch(ARCH), get_arch(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(reduced(t)) == dataclasses.asdict(j_reduced(j))
    assert param_count(t) == j_param_count(j) == (2_420_826_560,) * 2
    # the registry holds every config of the reference
    from repro.configs import list_archs as j_list_archs
    assert list_archs() == j_list_archs()


@pytest.mark.parametrize("full", [False, True], ids=["reduced4", "full"])
def test_param_specs_match_the_reference(full):
    """Every leaf's shape, axes, initialiser and scale, at the test size and
    at full width (specs only: nothing is allocated)."""
    jcfg, cfg = j_get_arch(ARCH), get_arch(ARCH)
    if not full:
        jcfg = replace(j_reduced(jcfg), n_layers=4)
        cfg = replace(reduced(cfg), n_layers=4)
    js = dict(leaves_with_paths(j_common.spec_map(
        lambda s: (s.shape, s.axes, s.init, s.scale), j_build(jcfg).param_specs())))
    ts = dict(leaves_with_paths(spec_map(
        lambda s: (s.shape, s.axes, s.init, s.scale), build(cfg).param_specs())))
    assert ts == js
    n = sum(int(np.prod(s[0])) for s in ts.values())
    if full:
        # the tensors the serve path allocates: param_count's analytic
        # estimate plus the norms, conv kernels and dt biases it leaves out
        assert n == 2_422_409_888 == param_count(cfg)[0] + 1_583_328


def test_init_params_follow_the_specs():
    cfg = replace(reduced(get_arch(ARCH)), n_layers=4)
    specs = build(cfg).param_specs()
    a = init_params(specs, torch.Generator().manual_seed(3))
    b = init_params(specs, torch.Generator().manual_seed(3))
    for s, x, y in zip(tree_leaves(specs), tree_leaves(a), tree_leaves(b)):
        assert tuple(x.shape) == s.shape and x.dtype == torch.float32
        assert torch.equal(x, y)                       # the seed fixes them
        if s.init in ("zeros", "ones"):
            assert torch.all(x == (1.0 if s.init == "ones" else 0.0))
        elif x.numel() >= 4096:
            std = s.scale if s.scale is not None else (
                0.02 if s.init == "embed"
                else 1 / np.sqrt(np.prod(s.shape[:-1])))
            # sample std of >= 4096 normal draws: within 5 % (20 sigma)
            assert abs(float(x.std()) / std - 1) < 0.05, (s, float(x.std()))


def test_params_carried_across_bit_for_bit(setup):
    jl = dict(leaves_with_paths(jax.tree.map(np.asarray, setup["jp"])))
    tl = dict(leaves_with_paths(setup["tp"]))
    assert jl.keys() == tl.keys()
    for path, a in jl.items():
        assert np.array_equal(tl[path].numpy(), a), path
    bf = jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16)
    t = params_from_reference({"a": {"b": np.asarray(bf)}})["a"]["b"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(bf).view(np.uint16))


def test_registry_builds_only_the_hybrid_family():
    """Every family the reference registers builds its class: the hybrid
    ``HybridLM``; dense, vlm and moe ``DecoderLM``; ssm ``SSMLM``; encdec
    ``EncDecLM``; an unknown family raises."""
    from repro_torch.configs import MoEConfig, SSMConfig
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.ssm_lm import SSMLM
    from repro_torch.models.transformer import DecoderLM
    cfg = get_arch(ARCH)
    assert build(cfg).n_sites == 9
    small = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=2, d_ff=16,
                 vocab_size=32)
    for family, extra, cls in (
            ("dense", {}, DecoderLM), ("vlm", {}, DecoderLM),
            ("moe", dict(moe=MoEConfig(n_experts=4, top_k=2,
                                       d_ff_expert=16)), DecoderLM),
            ("ssm", dict(ssm=SSMConfig()), SSMLM),
            ("encdec", dict(n_encoder_layers=2), EncDecLM)):
        assert type(build(ArchConfig(name="d", family=family, **small,
                                     **extra))) is cls
    with pytest.raises(ValueError):
        build(ArchConfig(name="d", family="other", **small))


def test_init_cache_matches_the_reference():
    jcfg = replace(j_reduced(j_get_arch(ARCH)), n_layers=4)
    cfg = replace(reduced(get_arch(ARCH)), n_layers=4)
    jc = dict(leaves_with_paths(jax.tree.map(
        lambda a: (a.shape, str(a.dtype)), j_init_cache(jcfg, B, S + G))))
    tc = dict(leaves_with_paths(init_cache(cfg, B, S + G, "cpu")))
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tc.items()} == jc
    assert all(bool(torch.all(t == 0)) for t in tc.values())


def test_make_batch_is_seeded():
    cfg = reduced(get_arch(ARCH))
    a = make_batch(cfg, (2, 8), torch.Generator().manual_seed(1))
    b = make_batch(cfg, (2, 8), torch.Generator().manual_seed(1))
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, dims=1))
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < cfg.vocab_size


def test_variant_keeps_the_reference_fields():
    from repro.models.variant import Variant as JVariant
    assert [f.name for f in dataclasses.fields(Variant)] == \
        [f.name for f in dataclasses.fields(JVariant)]
    assert dataclasses.asdict(BASELINE) == dataclasses.asdict(J_BASELINE)


# ---------------------------------------------------------------------------
# modules, on the same inputs
# ---------------------------------------------------------------------------

def _rand(shape, dtype, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return jnp.asarray(a, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_matches(dtype):
    x, w = _rand((2, 5, 128), dtype, 1), _rand((128,), jnp.float32, 2)
    got = common.rms_norm(T(x), T(w), 1e-5)
    want = j_common.rms_norm(x, w, 1e-5)
    # one float32 rounding apart at most, then the cast to dtype
    tol = 0.0 if dtype == jnp.bfloat16 else 1e-6
    np.testing.assert_allclose(npf(got), npf(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("rope_pct", [1.0, 0.5])
def test_apply_rope_matches(rope_pct):
    x = _rand((2, 16, 4, 32), jnp.bfloat16, 3)
    pos = np.arange(16, dtype=np.int32) + 5
    got = attention.apply_rope(T(x), torch.from_numpy(pos),
                               attention.rope_freqs(32, rope_pct, 1e4))
    want = j_attn.apply_rope(x, jnp.asarray(pos),
                             j_attn.rope_freqs(32, rope_pct, 1e4))
    # float32 sin/cos of the two libraries, then one bf16 rounding: 1 ulp
    np.testing.assert_allclose(npf(got), npf(want), rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_apply_mlp_matches(mlp):
    cfg = replace(reduced(get_arch(ARCH)), mlp=mlp)
    jcfg = replace(j_reduced(j_get_arch(ARCH)), mlp=mlp)
    jp = j_common.init_params(
        {k: j_common.ParamSpec(s.shape, s.axes) for k, s in
         common.mlp_specs(cfg, 128, 256).items()}, jax.random.key(4))
    x = _rand((2, 8, 128), jnp.bfloat16, 5)
    got = common.apply_mlp(cfg, params_from_reference(
        jax.tree.map(np.asarray, jp)), T(x))
    want = j_common.apply_mlp(jcfg, jp, x)
    # bf16 products, f32 sums in another order: 1 bf16 ulp of the output
    np.testing.assert_allclose(npf(got), npf(want), rtol=2**-7, atol=2**-9)


def test_lm_logits_matches(setup):
    h = _rand((2, 3, 128), jnp.bfloat16, 6)
    got = common.lm_logits(setup["cfg"], setup["tp"]["embed"], T(h))
    want = j_common.lm_logits(setup["jcfg"], setup["jp"]["embed"], h)
    # one bf16 product, f32 out: exact up to the sum order (1 bf16 ulp)
    V = setup["cfg"].vocab_size
    np.testing.assert_allclose(npf(got)[..., :V], npf(want)[..., :V],
                               rtol=2**-7, atol=2**-7)
    assert bool(torch.all(got[..., V:] == -1e30)) or got.shape[-1] == V


@pytest.mark.parametrize("q_block", [64, 16])
def test_chunked_attention_matches(q_block):
    q, k, v = (_rand((2, 64, 8, 32), jnp.bfloat16, 10),
               _rand((2, 64, 4, 32), jnp.bfloat16, 11),
               _rand((2, 64, 4, 32), jnp.bfloat16, 12))
    got = attention.chunked_attention(T(q), T(k), T(v), causal=True,
                                      kv_block=16, q_block=q_block)
    want = j_attn.chunked_attention(q, k, v, causal=True, kv_block=16,
                                    q_block=q_block)
    # same blocks and roundings; float32 sums in another order: 1 bf16 ulp
    np.testing.assert_allclose(npf(got), npf(want), rtol=2**-7, atol=2**-8)


def test_gqa_decode_matches(setup):
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    pa_j = setup["jp"]["shared"]["attn"]
    pa_t = setup["tp"]["shared"]["attn"]
    x = _rand((B, 1, 128), jnp.bfloat16, 13)
    ck, cv = (_rand((B, 16, 4, 32), jnp.bfloat16, 14),
              _rand((B, 16, 4, 32), jnp.bfloat16, 15))
    out, nk, nv = attention.gqa_decode(cfg, pa_t, T(x), T(ck), T(cv), 9)
    step = lambda *a: j_attn.gqa_decode(jcfg, pa_j, *a)
    args = (x, ck, cv, jnp.int32(9))
    jout, jk, jv = j_compile(step, *args)(*args)
    np.testing.assert_array_equal(npf(nk), npf(jk))
    np.testing.assert_array_equal(npf(nv), npf(jv))
    # bf16 projections and softmax weights, f32 sums: 2 bf16 ulp
    np.testing.assert_allclose(npf(out), npf(jout), rtol=2**-6, atol=2**-8)


def test_ssm_decode_matches(setup):
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    pj = jax.tree.map(lambda a: a[0, 1], setup["jp"]["mamba"])["ssm"]
    pt = {k: v[0, 1] for k, v in setup["tp"]["mamba"]["ssm"].items()}
    x = _rand((B, 1, 128), jnp.bfloat16, 16)
    cache_j = {"state": _rand((B, 16, 16, 16), jnp.float32, 17),
               "conv_x": _rand((B, 3, 256), jnp.bfloat16, 18),
               "conv_B": _rand((B, 3, 16), jnp.bfloat16, 19),
               "conv_C": _rand((B, 3, 16), jnp.bfloat16, 20)}
    out, cache = ssm.ssm_decode(cfg, pt, T(x), cache_from_reference(
        jax.tree.map(np.asarray, cache_j)))
    jout, jcache = j_compile(lambda *a: j_ssm.ssm_decode(jcfg, pj, *a), x,
                             cache_j)(x, cache_j)
    for k in cache:
        # the state: f32 products in another association, 1e-5 of its scale;
        # the conv windows are shifted bf16 values: exact
        assert norm_err(jcache[k], cache[k]) <= (1e-5 if k == "state" else 0), k
    # after the gate norm and a bf16 projection: 1 bf16 ulp
    np.testing.assert_allclose(npf(out), npf(jout), rtol=2**-7, atol=2**-8)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_chunked_matches(dtype):
    """The port of ``ssd_chunked`` against the reference's, with its bf16
    einsum roundings, on ``test_model_ssd_matches_kernel``'s shapes."""
    xh = _rand((2, 128, 4, 16), dtype, 21, 0.5)
    dt = jnp.abs(_rand((2, 128, 4), jnp.float32, 22, 0.5)) + 0.1
    A = -jnp.ones((4,)) * 0.5
    Bm, Cm = (_rand((2, 128, 1, 8), dtype, 23, 0.5),
              _rand((2, 128, 1, 8), dtype, 24, 0.5))
    y, st = ssm.ssd_chunked(T(xh), T(dt), T(A), T(Bm), T(Cm), 32)
    jy, jst = jax.jit(j_ssm.ssd_chunked, static_argnums=5)(xh, dt, A, Bm, Cm,
                                                          32)
    # the same roundings, f32 sums in another order: 1e-5 of the scale
    assert norm_err(jy, y) <= 1e-5 and norm_err(jst, st) <= 1e-5


# ---------------------------------------------------------------------------
# the slice as a whole: prefill, both routes, and the decode continuation
# ---------------------------------------------------------------------------

def test_prefill_plain_route_matches(setup):
    _hold_prefill(setup["ref"], setup["plain"], setup["cfg"], MODEL_TOL,
                  "use_pallas=False vs the reference's prefill")


def test_prefill_kernel_route_matches(setup):
    """use_pallas=True against the reference's model with its own Pallas
    kernels in the prefill (same algorithm, same roundings)."""
    _hold_prefill(setup["ref_kernels"], setup["kern"], setup["cfg"],
                  MODEL_TOL, "use_pallas=True vs the reference with its "
                             "Pallas kernels")
    # the first Mamba layer's state sees identical inputs on both sides:
    # only the kernels' float32 sum order differs
    assert norm_err(setup["ref_kernels"][1]["ssm"]["state"][0, 0],
                    setup["kern"][1]["ssm"]["state"][0, 0]) <= 1e-5


def test_prefill_kernel_route_near_the_default_route(setup):
    """use_pallas=True against the reference's default prefill.  The routes
    round at different places by design (the kernels keep the SSD's CB*L,
    decays and carried state and the attention probabilities in float32,
    ``ssd_chunked``/``chunked_attention`` round them to bf16; ROADMAP Queue
    C), so the measure is the relative RMS error of each leaf, held to
    MODEL_TOL (measured <= 0.0154, the SSD state; the normalised max error
    reaches 0.0203 on the second site's k/v)."""
    (jl, jc), (l, c) = setup["ref"], setup["kern"]
    V = setup["cfg"].vocab_size
    pairs = [("logits", np.asarray(jl)[:, :V], l[:, :V])]
    tl = dict(leaves_with_paths(c))
    pairs += [(p, a, tl[p]) for p, a in
              leaves_with_paths(jax.tree.map(np.asarray, jc))]
    for path, a, t in pairs:
        a, t = npf(a), npf(t)
        rms = float(np.sqrt(((a - t) ** 2).mean() / (a ** 2).mean()))
        assert rms <= MODEL_TOL, (path, rms)


def test_prefill_then_decode_matches(setup):
    """Prefill, the cache padded by G as ``init_cache`` zeros it, then G
    decode steps fed the same tokens on both sides: every step's logits and
    the final cache."""
    cfg, jm, m = setup["cfg"], setup["jm"], setup["m"]
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, G))
    pad = lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, G), (0, 0), (0, 0)))
    jcache = dict(setup["ref"][1])
    jcache["k"], jcache["v"] = pad(jcache["k"]), pad(jcache["v"])
    step = lambda p, c, t, pos: jm.decode_step(p, c, t, pos, CTX, J_BASELINE)
    tok0 = jnp.asarray(feed[:, :1], jnp.int32)
    jstep = j_compile(step, setup["jp"], jcache, tok0, jnp.int32(S))
    _, tcache = setup["plain"]
    tcache = {"ssm": {k: v.clone() for k, v in tcache["ssm"].items()},
              "k": torch.nn.functional.pad(tcache["k"], (0, 0, 0, 0, 0, G)),
              "v": torch.nn.functional.pad(tcache["v"], (0, 0, 0, 0, 0, G))}
    V = cfg.vocab_size
    with torch.inference_mode():
        for i in range(G):
            tok = feed[:, i:i + 1]
            jl, jcache = jstep(setup["jp"], jcache, jnp.asarray(tok, jnp.int32),
                               jnp.int32(S + i))
            tl, tcache = m.decode_step(setup["tp"], tcache,
                                       torch.from_numpy(tok).long(), S + i)
            assert tl.shape == (B, 1, jl.shape[-1])
            err = norm_err(np.asarray(jl)[..., :V], tl[..., :V])
            assert err <= MODEL_TOL, (i, err)
    jleaves = dict(leaves_with_paths(jax.tree.map(np.asarray, jcache)))
    for path, t in leaves_with_paths(tcache):
        assert norm_err(jleaves[path], t) <= MODEL_TOL, path


# ---------------------------------------------------------------------------
# the serving entry point on the CPU
# ---------------------------------------------------------------------------

def test_serve_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "32",
         "--gen", "4"], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0 and len(lines) == 4, (out.stdout, out.stderr)
    assert lines[0] == "arch=zamba2-2.7b batch=2 prompt=32 gen=4"
    gen = eval(lines[1].split(": ", 1)[1])
    assert len(gen) == 4 and all(0 <= t < 512 for t in gen)
    assert lines[2].startswith("decode throughput: ")
    assert lines[3].startswith("prefill: ") and "for 64 tokens" in lines[3]


def test_serve_generates_the_greedy_continuation():
    """serve.run's tokens are the greedy argmax of prefill, then of each
    decode step, with the kernel route (here: the plain versions)."""
    cfg = reduced(get_arch(ARCH))
    dev = torch.device("cpu")
    r = serve.run(cfg, batch=2, prompt_len=32, gen=3, seed=5, device=dev)
    m = build(cfg)
    params = init_params(m.param_specs(), torch.Generator().manual_seed(5))
    toks = make_batch(cfg, (2, 32), torch.Generator().manual_seed(6))["tokens"]
    with torch.inference_mode():
        logits, cache = m.prefill(params, toks, None,
                                  replace(BASELINE, use_pallas=True))
        first = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    assert [row[0] for row in r["tokens"]] == first.tolist()
    assert r["decode_steps"] == 2 and len(r["tokens"][0]) == 3


def test_serve_needs_the_device_flag_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                    "--prompt-len", "32", "--gen", "2"])


def test_serve_checks_the_prompt_length():
    cfg = get_arch(ARCH)
    serve.check_prompt_len(cfg, 256)
    serve.check_prompt_len(cfg, 512)
    serve.check_prompt_len(cfg, 100)
    with pytest.raises(ValueError, match="prompt length"):
        serve.check_prompt_len(cfg, 300)
    with pytest.raises(ValueError, match="SSD chunk 32"):
        serve.check_prompt_len(reduced(cfg), 48)
