"""The port's moe family (``repro_torch.configs`` arctic-480b and
deepseek-v2-236b; ``repro_torch.models.moe``, ``repro_torch.models.mla``;
``DecoderLM``'s moe and mla branches; ``launch.serve`` on them) against the
JAX package, on the CPU.

Small size: each config ``reduced`` (2 layers, d_model 128, 4 heads, 4
experts of 64, top 2; deepseek's latent 32, nope 32 + rope 16, v 32, one
shared expert; arctic's dense residual), batch 2, 64 tokens.  The weights
are the reference's ``init_params`` carried across with
``params_from_reference``; the reference is compiled with
``xla_allow_excess_precision`` off, its moe layer under
``make_smoke_ctx()`` (one device: ``E_local = E``, no psum), as
``tests/test_torch_models.py`` says.

Routing.  Both sides round the router product to bf16, so equal logits are
frequent, and ``moe.route`` breaks such ties by the lower expert index, as
``jax.lax.top_k`` does (with ``torch.topk``, which promises no tie order,
5 tokens of the four reduced prefills took another expert, each at a gap of
exactly 0).  The hidden state entering the router still differs by bf16
roundings: where a token's K-th and (K+1)-th router logits lie within that
error of each other, the two sides may pick different experts, and the
token's output then differs by a whole expert.  A choice is a near-tie
when the gap between the K-th and (K+1)-th logit is at most NEAR_TIE of the
larger of the two: the rounding of the bf16 product, u = 2**-8 relative on
either side's logit, twice (both logits), on each side (4u), and as much
again for the inputs' own bf16 roundings.  Every comparison first compares
the experts chosen (as sets per token: the order within a token changes no
slot, tokens take slots first-come over (token, k)), and asserts that every
token whose choice differs is a near-tie.  The module test then holds the
outputs of the tokens whose choices agree.  The whole-model tests route the
port with the reference's choices (``moe.route`` patched to take the
reference's top-K, weighted by the port's own probabilities) once that
check has passed, so that a near-tie cannot move a whole row, and hold the
logits and every cache leaf to MODEL_TOL (measured: plain route <= 0.0059,
kernel route <= 0.0071, decode <= 0.0060; no token took another expert at
these seeds).
"""
import dataclasses
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as j_attn
import repro.models.common as j_common
import repro.models.mla as j_mla
import repro.models.moe as j_moe
from repro.configs import get_arch as j_get_arch
from repro.configs import param_count as j_param_count
from repro.configs import reduced as j_reduced
from repro.models.registry import build as j_build
from repro.models.registry import init_cache as j_init_cache
from repro.models.variant import BASELINE as J_BASELINE
from repro_torch.configs import get_arch, param_count, reduced
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import mla, moe
from repro_torch.models.common import init_params, spec_map
from repro_torch.models.registry import (build, cache_shapes, init_cache,
                                         make_batch)
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.variant import BASELINE
from test_torch_models import (CTX, MODEL_TOL, T, _hold_prefill, j_compile,
                               j_kernel_attention, leaves_with_paths,
                               norm_err, npf)

ARCHS = ("deepseek-v2-236b", "arctic-480b")
#: the reference's moe layer, unpatched
J_MOE_LAYER = j_moe.moe_layer
B, S, G = 2, 64, 2
#: the near-tie measure (module docstring): 8 bf16 unit roundoffs of the
#: larger logit
NEAR_TIE = 8 * 2.0**-8


def _rand(shape, dtype, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return jnp.asarray(a, dtype)


# ---------------------------------------------------------------------------
# routing: the reference's choices, recorded; the near-tie rule
# ---------------------------------------------------------------------------

def recording_moe_layer(log: list):
    """The reference's ``moe_layer``, also handing its routing (the bf16
    router logits, and ``top_k`` of their softmax, as its body computes
    them) to ``log``, one entry a call, in call order."""

    def moe_layer(ctx, cfg, p, x, **kw):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.bfloat16)
        logits = (xf @ p["router"].astype(jnp.bfloat16)).astype(jnp.float32)
        _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                cfg.moe.top_k)
        jax.debug.callback(
            lambda lg, ti: log.append((np.asarray(lg), np.asarray(ti))),
            logits, topi, ordered=True)
        return J_MOE_LAYER(ctx, cfg, p, x, **kw)
    return moe_layer


def near_ties(logits: np.ndarray, K: int) -> np.ndarray:
    """Per token: whether its K-th and (K+1)-th logits lie within NEAR_TIE
    of the larger of the two."""
    srt = -np.sort(-logits, axis=-1)
    a, b = srt[:, K - 1], srt[:, K]
    return a - b <= NEAR_TIE * np.maximum(np.abs(a), np.abs(b))


def differing(ref_topi, port_topi) -> np.ndarray:
    """Per token: whether the two sides chose another set of experts."""
    return np.any(np.sort(np.asarray(ref_topi), -1)
                  != np.sort(np.asarray(port_topi), -1), axis=-1)


class ForcedRouting:
    """``moe.route`` that checks the port's choices against the reference's
    recorded ones (each differing token a near-tie of the reference's
    logits), then routes with the reference's choices, weighted by the
    port's probabilities."""

    def __init__(self, log: list, K: int):
        self.log, self.K, self.calls, self.forced = log, K, 0, 0
        self.orig = moe.route

    def __call__(self, cfg, p, xf):
        probs, topv, topi = self.orig(cfg, p, xf)
        ref_logits, ref_topi = self.log[self.calls]
        self.calls += 1
        diff = differing(ref_topi, topi.numpy())
        ties = near_ties(ref_logits, self.K)
        assert not np.any(diff & ~ties), \
            f"call {self.calls}: tokens {np.argwhere(diff & ~ties).ravel()} " \
            f"chose other experts without a near-tie"
        self.forced += int(diff.sum())
        ti = torch.from_numpy(np.array(ref_topi)).long()
        tv = torch.gather(probs, 1, ti)
        return probs, tv / torch.sum(tv, dim=-1, keepdim=True), ti


# ---------------------------------------------------------------------------
# the family as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, cfg = j_reduced(j_get_arch(arch)), reduced(get_arch(arch))
    jm, m = j_build(jcfg), build(cfg)
    jp = j_common.init_params(jm.param_specs(), jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    logs = {"plain": [], "kern": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_moe, "moe_layer", recording_moe_layer(logs["plain"]))
        ref = j_compile(lambda p, t: jm.prefill(p, t, CTX, J_BASELINE),
                        jp, jt)(jp, jt)
        mp.setattr(j_moe, "moe_layer", recording_moe_layer(logs["kern"]))
        mp.setattr(j_attn, "chunked_attention", j_kernel_attention)
        ref_kernels = j_compile(lambda p, t: jm.prefill(p, t, CTX, J_BASELINE),
                                jp, jt)(jp, jt)
    fa.reset_launch_counts()
    out, forced = {}, {}
    for route, variant in (("plain", BASELINE),
                           ("kern", replace(BASELINE, use_pallas=True))):
        routing = ForcedRouting(logs[route], cfg.moe.top_k)
        with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
            mp.setattr(moe, "route", routing)
            out[route] = m.prefill(tp, tt, None, variant)
        assert routing.calls == cfg.n_layers
        forced[route] = routing.forced
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, m=m, jp=jp, tp=tp, tokens=tokens,
                ref=ref, ref_kernels=ref_kernels, plain=out["plain"],
                kern=out["kern"], forced=forced, calls=dict(fa.launch_counts))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_reference(arch):
    j, t = j_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(reduced(t)) == dataclasses.asdict(j_reduced(j))
    assert param_count(t) == j_param_count(j)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, full):
    """Every leaf's shape, axes, initialiser and scale (specs only: nothing
    is allocated at full width)."""
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    if not full:
        jcfg, cfg = j_reduced(jcfg), reduced(cfg)
    key = lambda s: (s.shape, s.axes, s.init, s.scale)  # noqa: E731
    js = dict(leaves_with_paths(
        j_common.spec_map(key, j_build(jcfg).param_specs())))
    ts = dict(leaves_with_paths(spec_map(key, build(cfg).param_specs())))
    assert ts == js


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_cache_shapes_match_the_reference(arch):
    jcfg, cfg = j_reduced(j_get_arch(arch)), reduced(get_arch(arch))
    jc = dict(leaves_with_paths(jax.tree.map(
        lambda a: (a.shape, str(a.dtype)), j_init_cache(jcfg, B, S + G))))
    tc = dict(leaves_with_paths(init_cache(cfg, B, S + G, "cpu")))
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tc.items()} == jc
    assert all(bool(torch.all(t == 0)) for t in tc.values())
    shapes = {p: (shp, str(dt).removeprefix("torch.")) for p, (shp, dt) in
              leaves_with_paths(cache_shapes(cfg, B, S + G))}
    assert shapes == jc
    # the mla cache is the compressed latent and the shared rope key
    assert set(tc) == ({"/c", "/k_rope"} if cfg.mla else {"/k", "/v"})


def test_the_registry_builds_both_branches():
    for arch in ARCHS:
        m = build(reduced(get_arch(arch)))
        assert isinstance(m, DecoderLM) and m.is_moe
        assert m.is_mla == (arch == "deepseek-v2-236b")


def test_prefill_plain_route_matches(setup):
    _hold_prefill(setup["ref"], setup["plain"], setup["cfg"], MODEL_TOL,
                  "use_pallas=False vs the reference's prefill")


def test_prefill_kernel_route_matches(setup):
    """use_pallas=True against the reference's model with its Pallas flash
    attention in the prefill (mla: q/k of 48 dims against v of 32 here,
    192 / 128 at full width); the wrapper's plain version on the CPU, so
    the counter stays 0."""
    _hold_prefill(setup["ref_kernels"], setup["kern"], setup["cfg"],
                  MODEL_TOL, "use_pallas=True vs the reference with its "
                             "Pallas flash attention")
    assert setup["calls"] == {"flash_attn": 0}


def test_routing_differs_only_at_near_ties(setup):
    """ForcedRouting held every prefill's choices (the fixture raises
    otherwise); at most a few tokens of the 2 x 128 routed ones took
    another expert, each a near-tie."""
    assert all(n <= 4 for n in setup["forced"].values()), setup["forced"]


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_breaks_ties_by_the_lower_index(arch):
    """Equal router logits (here all of them: a zero router) choose the
    lowest expert indices, in order, as ``jax.lax.top_k`` does; the weights
    are equal and sum to 1."""
    cfg = reduced(get_arch(arch))
    K, E = cfg.moe.top_k, cfg.moe.n_experts
    xf = _rand((6, cfg.d_model), jnp.bfloat16, 8)
    router = jnp.zeros((cfg.d_model, E), jnp.float32)
    _, jtopi = jax.lax.top_k(jax.nn.softmax(
        (xf @ router.astype(jnp.bfloat16)).astype(jnp.float32), -1), K)
    _, topv, topi = moe.route(cfg, {"router": T(router)}, T(xf))
    assert np.array_equal(topi.numpy(), np.asarray(jtopi))
    assert topi.tolist() == [list(range(K))] * 6
    assert torch.allclose(topv, torch.full((6, K), 1.0 / K))


def test_prefill_cache_is_stacked_by_layer(setup):
    cfg, (_, cache) = setup["cfg"], setup["kern"]
    if cfg.mla:
        m = cfg.mla
        want = {"c": (cfg.n_layers, B, S, m.kv_lora_rank),
                "k_rope": (cfg.n_layers, B, S, m.rope_head_dim)}
    else:
        kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        want = {"k": kv, "v": kv}
    assert {k: tuple(t.shape) for k, t in cache.items()} == want
    assert all(t.dtype == torch.bfloat16 for t in cache.values())


def test_prefill_then_decode_matches(setup):
    """Prefill, the cache padded by G as ``init_cache`` zeros it, then G
    decode steps fed the same tokens on both sides, the routing of every
    step checked and forced as the prefill's: every step's logits and the
    final cache.  At decode T = B = 2 tokens route, C = ceil(2 x 2 / 4 x
    1.25) = 2 slots an expert: tokens drop as in the reference."""
    cfg, jm, m = setup["cfg"], setup["jm"], setup["m"]
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, G))
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, G)) + ((0, 0),) * (v.ndim - 3))
              for k, v in setup["ref"][1].items()}
    log: list = []

    def step(p, c, t, pos):
        return jm.decode_step(p, c, t, pos, CTX, J_BASELINE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_moe, "moe_layer", recording_moe_layer(log))
        tok0 = jnp.asarray(feed[:, :1], jnp.int32)
        jstep = j_compile(step, setup["jp"], jcache, tok0, jnp.int32(S))
    _, tcache = setup["plain"]
    tcache = serve.pad_cache(cfg, {k: v.clone() for k, v in tcache.items()},
                             B, S, G)
    V = cfg.vocab_size
    routing = ForcedRouting(log, cfg.moe.top_k)
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        mp.setattr(moe, "route", routing)
        for i in range(G):
            tok = feed[:, i:i + 1]
            jl, jcache = jstep(setup["jp"], jcache,
                               jnp.asarray(tok, jnp.int32), jnp.int32(S + i))
            jax.effects_barrier()
            tl, tcache = m.decode_step(setup["tp"], tcache,
                                       torch.from_numpy(tok).long(), S + i)
            assert tl.shape == (B, 1, jl.shape[-1])
            err = norm_err(np.asarray(jl)[..., :V], tl[..., :V])
            assert err <= MODEL_TOL, (i, err)
    assert routing.calls == G * cfg.n_layers
    jleaves = dict(leaves_with_paths(jax.tree.map(np.asarray, jcache)))
    for path, t in leaves_with_paths(tcache):
        assert norm_err(jleaves[path], t) <= MODEL_TOL, path


# ---------------------------------------------------------------------------
# modules, on the same inputs
# ---------------------------------------------------------------------------

def _layer0(setup_arch):
    jcfg, cfg = j_reduced(j_get_arch(setup_arch)), reduced(get_arch(setup_arch))
    jp = j_common.init_params(j_build(jcfg).param_specs(), jax.random.key(0))
    jl = jax.tree.map(lambda a: a[0], jp["blocks"])
    return jcfg, cfg, jl, params_from_reference(jax.tree.map(np.asarray, jl))


@pytest.mark.parametrize("tokens,cf", [((2, 64), None), ((4, 1), None),
                                       ((4, 1), 0.5)],
                         ids=["prefill", "decode", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches(arch, tokens, cf):
    """One moe layer on the same bf16 input (a prefill's 128 tokens; a
    decode step's 4, capacity 3 an expert; the same at capacity factor 0.5,
    capacity 1 for 8 choices, so that tokens drop): the choices, then the
    outputs of the tokens whose choices agree (bf16 products in another
    order, f32 combine: 2 bf16 ulps of the largest output), and the aux
    loss (float32 means: 1e-6)."""
    jcfg, cfg, jl, tl = _layer0(arch)
    x = _rand(tokens + (cfg.d_model,), jnp.bfloat16, 3)
    jy, jaux = j_compile(
        lambda p, a: j_moe.moe_layer(CTX, jcfg, p, a, capacity_factor=cf),
        jl["moe"], x)(jl["moe"], x)
    ty, taux = moe.moe_layer(None, cfg, tl["moe"], T(x), capacity_factor=cf)
    assert ty.shape == jy.shape and ty.dtype == torch.bfloat16
    xf = x.reshape(-1, cfg.d_model)
    logits = np.asarray((xf @ jl["moe"]["router"].astype(jnp.bfloat16))
                        .astype(jnp.float32))
    _, jtopi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                             cfg.moe.top_k)
    _, _, ttopi = moe.route(cfg, tl["moe"], T(xf))
    diff = differing(jtopi, ttopi.numpy())
    assert not np.any(diff & ~near_ties(logits, cfg.moe.top_k))
    keep = ~diff.reshape(tokens)
    a, b = npf(jy)[keep], npf(ty)[keep]
    assert np.abs(a - b).max() <= 2 * 2**-8 * np.abs(a).max()
    if not diff.any():
        assert abs(float(jaux) - float(taux)) <= 1e-6


def test_capacity_follows_the_reference():
    """C = max(1, ceil(T K / E cf)), T = B S: deepseek at full width, a
    batch-4 prefill of 512 tokens and a decode step; arctic's likewise."""
    ds, ar = get_arch("deepseek-v2-236b"), get_arch("arctic-480b")
    assert moe.capacity(ds, 4 * 512) == math.ceil(2048 * 6 / 160 * 1.25) == 96
    assert moe.capacity(ds, 4) == 1
    assert moe.capacity(ar, 4 * 512) == math.ceil(2048 * 2 / 128 * 1.25) == 40
    assert moe.capacity(ar, 4, capacity_factor=1.0) == 1


def test_mla_attention_matches():
    """The expanded form on the same bf16 input (the same roundings, float32
    sums in another order: 1 bf16 ulp of the scale)."""
    jcfg, cfg, jl, tl = _layer0("deepseek-v2-236b")
    x = _rand((2, 64, cfg.d_model), jnp.bfloat16, 4)
    want = j_compile(lambda p, a: j_mla.mla_attention(jcfg, p, a),
                     jl["attn"], x)(jl["attn"], x)
    got = mla.mla_attention(cfg, tl["attn"], T(x))
    assert norm_err(want, got) <= 2**-8


def test_mla_decode_matches():
    """The absorbed form against a compressed cache: the cache written in
    place at pos exactly as the reference writes it, the output within 2
    bf16 ulps of its scale (bf16 products, float32 sums in another
    order)."""
    jcfg, cfg, jl, tl = _layer0("deepseek-v2-236b")
    m = cfg.mla
    x = _rand((B, 1, cfg.d_model), jnp.bfloat16, 5)
    cc = _rand((B, 16, m.kv_lora_rank), jnp.bfloat16, 6)
    ckr = _rand((B, 16, m.rope_head_dim), jnp.bfloat16, 7)
    step = lambda *a: j_mla.mla_decode(jcfg, jl["attn"], *a)  # noqa: E731
    args = (x, cc, ckr, jnp.int32(9))
    jout, jc, jkr = j_compile(step, *args)(*args)
    tc, tkr = cache_from_reference({"c": np.asarray(cc),
                                    "k_rope": np.asarray(ckr)}).values()
    out, c2, kr2 = mla.mla_decode(cfg, tl["attn"], T(x), tc, tkr, 9)
    assert c2 is tc and kr2 is tkr                   # in place
    # the new entries: c after a bf16 product and the norm, k_rope after
    # the rope's float32 sin / cos: 1 bf16 ulp; the old entries untouched
    for got, want in ((c2, jc), (kr2, jkr)):
        np.testing.assert_allclose(npf(got), npf(want), rtol=2**-7, atol=0)
        np.testing.assert_array_equal(npf(got)[:, :9], npf(want)[:, :9])
    assert norm_err(jout, out) <= 2 * 2**-8


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32", "--gen",
                       "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={arch} batch=2 prompt=32 gen=3"
    assert len(eval(lines[1].split(": ", 1)[1])) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_pads_exactly_the_sequence_caches(arch):
    """``serve.pad_cache`` grows the sequence axis of mla's c / k_rope (or
    k / v) by the generated tokens, to ``init_cache``'s shapes, the
    prefill's values kept and zeros after."""
    cfg = reduced(get_arch(arch))
    m = build(cfg)
    params = init_params(m.param_specs(), torch.Generator().manual_seed(0))
    toks = make_batch(cfg, (B, 32), torch.Generator().manual_seed(1))["tokens"]
    with torch.inference_mode():
        _, cache = m.prefill(params, toks, None, BASELINE)
    padded = serve.pad_cache(cfg, cache, B, 32, G)
    want = cache_shapes(cfg, B, 32 + G)
    for k, t in padded.items():
        assert tuple(t.shape) == want[k][0]
        assert torch.equal(t[:, :, :32], cache[k])
        assert bool(torch.all(t[:, :, 32:] == 0))
