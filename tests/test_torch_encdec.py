"""The port's encdec family (``repro_torch.configs.whisper_medium``,
``repro_torch.models.encdec.EncDecLM``, the registry's ``frames``,
``launch.serve`` on it) against the JAX package, on the CPU.

Small size: ``whisper-medium`` reduced (2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, layer norm, gelu, 16 audio frames), batch 2,
64 tokens.  The weights are the reference's ``init_params`` carried across
with ``params_from_reference``, the frames one bf16 array from a seeded
numpy generator handed to both; the reference is compiled with
``xla_allow_excess_precision`` off (``tests/test_torch_models.py`` says
why).  Prefill is held on both routes: the plain route against the
reference's default prefill, the kernel route against the reference's model
with its own Pallas flash attention (interpret mode) in the encoder, the
decoder's self-attention and its cross-attention.  Then 2 decode steps.
Every whole-model comparison is held to MODEL_TOL, the normalised max error
of ``test_torch_models.py`` (measured here: the encoder alone <= 0.0097,
plain route <= 0.0052, kernel route <= 0.0043, decode <= 0.0054).
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as j_attn
import repro.models.common as j_common
import repro.models.encdec as j_encdec
from repro.configs import get_arch as j_get_arch
from repro.configs import param_count as j_param_count
from repro.configs import reduced as j_reduced
from repro.models.registry import build as j_build
from repro.models.registry import init_cache as j_init_cache
from repro.models.variant import BASELINE as J_BASELINE
from repro_torch.configs import get_arch, param_count, reduced
from repro_torch.convert import params_from_reference
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.models.common import init_params, spec_map
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import (build, cache_shapes, init_cache,
                                         make_batch)
from repro_torch.models.variant import BASELINE
from test_torch_models import (CTX, MODEL_TOL, T, _hold_prefill, j_compile,
                               j_kernel_attention, leaves_with_paths,
                               norm_err)

ARCH = "whisper-medium"
B, S, G = 2, 64, 2


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = j_reduced(j_get_arch(ARCH)), reduced(get_arch(ARCH))
    jm, m = j_build(jcfg), build(cfg)
    jp = j_common.init_params(jm.param_specs(), jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = jnp.asarray(rng.standard_normal((B, cfg.n_audio_ctx,
                                              cfg.d_model)) * 0.02,
                         jnp.bfloat16)
    jb = {"tokens": jnp.asarray(tokens), "frames": frames}
    tb = {"tokens": torch.from_numpy(tokens).long(), "frames": T(frames)}
    ref = j_compile(lambda p, b: jm.prefill(p, b, CTX, J_BASELINE),
                    jp, jb)(jp, jb)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_attn, "chunked_attention", j_kernel_attention)
        ref_kernels = j_compile(lambda p, b: jm.prefill(p, b, CTX, J_BASELINE),
                                jp, jb)(jp, jb)
    fa.reset_launch_counts()
    with torch.inference_mode():
        plain = m.prefill(tp, tb, None, BASELINE)
        kern = m.prefill(tp, tb, None, replace(BASELINE, use_pallas=True))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, m=m, jp=jp, tp=tp, jb=jb, tb=tb,
                ref=ref, ref_kernels=ref_kernels, plain=plain, kern=kern,
                calls=dict(fa.launch_counts))


def test_config_matches_the_reference():
    j, t = j_get_arch(ARCH), get_arch(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(reduced(t)) == dataclasses.asdict(j_reduced(j))
    assert param_count(t) == j_param_count(j)
    assert isinstance(build(t), EncDecLM)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_specs_match_the_reference(full):
    """Every leaf's shape, axes, initialiser and scale (specs only: nothing
    is allocated at full width)."""
    jcfg, cfg = j_get_arch(ARCH), get_arch(ARCH)
    if not full:
        jcfg, cfg = j_reduced(jcfg), reduced(cfg)
    key = lambda s: (s.shape, s.axes, s.init, s.scale)  # noqa: E731
    js = dict(leaves_with_paths(
        j_common.spec_map(key, j_build(jcfg).param_specs())))
    ts = dict(leaves_with_paths(spec_map(key, build(cfg).param_specs())))
    assert ts == js


def test_init_cache_and_cache_shapes_match_the_reference():
    jcfg, cfg = j_reduced(j_get_arch(ARCH)), reduced(get_arch(ARCH))
    jc = dict(leaves_with_paths(jax.tree.map(
        lambda a: (a.shape, str(a.dtype)), j_init_cache(jcfg, B, S + G))))
    tc = dict(leaves_with_paths(init_cache(cfg, B, S + G, "cpu")))
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tc.items()} == jc
    assert all(bool(torch.all(t == 0)) for t in tc.values())
    shapes = {p: (shp, str(dt).removeprefix("torch.")) for p, (shp, dt) in
              leaves_with_paths(cache_shapes(cfg, B, S + G))}
    assert shapes == jc


@pytest.mark.parametrize("S_,D,offset", [(1500, 1024, 0), (64, 128, 0),
                                         (1, 128, 37)])
def test_sinusoid_matches(S_, D, offset):
    """float32 sin / cos of two libraries at angles up to 1500 rad (the
    audio context): 1e-4 absolute (the angle's last ulp at 1500 rad is
    1.2e-4; measured 3.1e-5, and 6e-8 below 64 rad)."""
    want = np.asarray(j_encdec.sinusoid(S_, D, offset))
    got = encdec.sinusoid(S_, D, offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_flash_block_spans_a_sequence_256_does_not_divide():
    assert encdec.flash_block(512) == 256 == encdec.flash_block(256)
    assert encdec.flash_block(1500) == 1500
    assert encdec.flash_block(16) == 16


def test_make_batch_adds_the_frames():
    cfg = reduced(get_arch(ARCH))
    a = make_batch(cfg, (B, 8), torch.Generator().manual_seed(1))
    b = make_batch(cfg, (B, 8), torch.Generator().manual_seed(1))
    assert a["frames"].shape == (B, cfg.n_audio_ctx, cfg.d_model)
    assert a["frames"].dtype == torch.bfloat16
    assert torch.equal(a["frames"], b["frames"])
    # bf16 normal x 0.02, as the reference draws them: the std within 10 %
    assert abs(float(a["frames"].float().std()) / 0.02 - 1) < 0.1
    assert "frames" not in make_batch(reduced(get_arch("granite-3-2b")),
                                      (B, 8), torch.Generator())


def test_encode_matches(setup):
    """The encoder alone on both routes (plain, and the flash kernel's plain
    version on the CPU) against the reference's encode."""
    jm, m = setup["jm"], setup["m"]
    want = j_compile(lambda p, f: jm.encode(p, f, CTX, J_BASELINE),
                     setup["jp"], setup["jb"]["frames"])(setup["jp"],
                                                         setup["jb"]["frames"])
    for variant in (BASELINE, replace(BASELINE, use_pallas=True)):
        got = m.encode(setup["tp"], setup["tb"]["frames"], None, variant)
        assert got.dtype == torch.bfloat16
        assert norm_err(want, got) <= MODEL_TOL


def test_prefill_plain_route_matches(setup):
    _hold_prefill(setup["ref"], setup["plain"], setup["cfg"], MODEL_TOL,
                  "use_pallas=False vs the reference's prefill")


def test_prefill_kernel_route_matches(setup):
    """use_pallas=True against the reference's model with its Pallas flash
    attention in the encoder, the self- and the cross-attention (three
    launches a layer on the card; here the plain version, so the counter
    stays 0)."""
    _hold_prefill(setup["ref_kernels"], setup["kern"], setup["cfg"],
                  MODEL_TOL, "use_pallas=True vs the reference with its "
                             "Pallas flash attention")
    assert setup["calls"] == {"flash_attn": 0}


def test_prefill_cache_is_stacked_by_layer(setup):
    cfg, (_, cache) = setup["cfg"], setup["kern"]
    kv, hd, A = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_audio_ctx
    assert {k: tuple(t.shape) for k, t in cache.items()} == {
        "k": (cfg.n_layers, B, S, kv, hd), "v": (cfg.n_layers, B, S, kv, hd),
        "xk": (cfg.n_layers, B, A, kv, hd), "xv": (cfg.n_layers, B, A, kv, hd)}
    assert all(t.dtype == torch.bfloat16 for t in cache.values())


def test_prefill_then_decode_matches(setup):
    """Prefill, the self-attention cache padded by G as ``init_cache``
    zeros it (xk / xv as they are), then G decode steps fed the same
    tokens on both sides: every step's logits and the final cache."""
    cfg, jm, m = setup["cfg"], setup["jm"], setup["m"]
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, G))
    jcache = dict(setup["ref"][1])
    for k in ("k", "v"):
        jcache[k] = jnp.pad(jcache[k], ((0, 0), (0, 0), (0, G), (0, 0), (0, 0)))

    def step(p, c, t, pos):
        return jm.decode_step(p, c, t, pos, CTX, J_BASELINE)
    tok0 = jnp.asarray(feed[:, :1], jnp.int32)
    jstep = j_compile(step, setup["jp"], jcache, tok0, jnp.int32(S))
    tcache = serve.pad_cache(cfg, {k: v.clone() for k, v in
                                   setup["plain"][1].items()}, B, S, G)
    V = cfg.vocab_size
    with torch.inference_mode():
        for i in range(G):
            tok = feed[:, i:i + 1]
            jl, jcache = jstep(setup["jp"], jcache,
                               jnp.asarray(tok, jnp.int32), jnp.int32(S + i))
            tl, tcache = m.decode_step(setup["tp"], tcache,
                                       torch.from_numpy(tok).long(), S + i)
            assert tl.shape == (B, 1, jl.shape[-1])
            err = norm_err(np.asarray(jl)[..., :V], tl[..., :V])
            assert err <= MODEL_TOL, (i, err)
    jleaves = dict(leaves_with_paths(jax.tree.map(np.asarray, jcache)))
    for path, t in leaves_with_paths(tcache):
        assert norm_err(jleaves[path], t) <= MODEL_TOL, path


def test_serve_runs_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32", "--gen",
                       "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={ARCH} batch=2 prompt=32 gen=3"
    gen = eval(lines[1].split(": ", 1)[1])
    assert len(gen) == 3 and all(0 <= t < 512 for t in gen)


def test_serve_pads_exactly_the_sequence_caches():
    """``serve.pad_cache`` grows k / v on the sequence axis to
    ``init_cache``'s shapes (the prefill's values kept, zeros after) and
    leaves xk / xv, which hold the encoder frames, as they are."""
    cfg = reduced(get_arch(ARCH))
    m = build(cfg)
    params = init_params(m.param_specs(), torch.Generator().manual_seed(0))
    batch = make_batch(cfg, (B, 32), torch.Generator().manual_seed(1))
    with torch.inference_mode():
        _, cache = m.prefill(params, batch, None, BASELINE)
    padded = serve.pad_cache(cfg, cache, B, 32, G)
    want = cache_shapes(cfg, B, 32 + G)
    for k in ("k", "v"):
        assert tuple(padded[k].shape) == want[k][0]
        assert torch.equal(padded[k][:, :, :32], cache[k])
        assert bool(torch.all(padded[k][:, :, 32:] == 0))
    for k in ("xk", "xv"):
        assert padded[k] is cache[k]
