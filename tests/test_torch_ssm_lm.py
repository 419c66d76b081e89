"""The port's ssm-only family (``repro_torch.configs.mamba2_2p7b``,
``repro_torch.models.ssm_lm.SSMLM``, its Mamba layer
``models.ssm.mamba_prefill`` shared with the hybrid; ``launch.serve`` on
it) against the JAX package, on the CPU.

Small size: ``mamba2-2.7b`` reduced (2 layers, d_model 128, 16 SSD heads
of P 16, N 16, chunk 32), batch 2, 64 tokens.  The weights are the
reference's ``init_params`` carried across with ``params_from_reference``;
the reference is compiled with ``xla_allow_excess_precision`` off
(``tests/test_torch_models.py`` says why).  Prefill is held on both routes:
the plain route against the reference's default prefill, the kernel route
against the reference's model with its own Pallas SSD kernel (interpret
mode) in place of ``ssd_chunked``.  Then 2 decode steps.  Every
whole-model comparison is held to MODEL_TOL, the normalised max error of
``test_torch_models.py`` (measured here: plain route <= 0.0047, kernel
route <= 0.0047, decode <= 0.0047).
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as j_common
import repro.models.ssm_lm as j_ssm_lm
from repro.configs import get_arch as j_get_arch
from repro.configs import param_count as j_param_count
from repro.configs import reduced as j_reduced
from repro.models.registry import build as j_build
from repro.models.registry import init_cache as j_init_cache
from repro.models.variant import BASELINE as J_BASELINE
from repro_torch.configs import get_arch, param_count, reduced
from repro_torch.convert import params_from_reference
from repro_torch.kernels.ssd_scan import ssd_scan as sk
from repro_torch.launch import serve
from repro_torch.models import hybrid, ssm
from repro_torch.models.common import init_params, spec_map
from repro_torch.models.registry import (build, cache_shapes, init_cache,
                                         make_batch)
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.variant import BASELINE
from test_torch_models import (CTX, MODEL_TOL, _hold_prefill, j_compile,
                               j_kernel_ssd, leaves_with_paths, norm_err)

ARCH = "mamba2-2.7b"
B, S, G = 2, 64, 2


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = j_reduced(j_get_arch(ARCH)), reduced(get_arch(ARCH))
    jm, m = j_build(jcfg), build(cfg)
    jp = j_common.init_params(jm.param_specs(), jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jt = jnp.asarray(tokens)
    ref = j_compile(lambda p, t: jm.prefill(p, t, CTX, J_BASELINE),
                    jp, jt)(jp, jt)
    with pytest.MonkeyPatch.context() as mp:
        # ssm_lm imports ssd_chunked by name: patch its binding
        mp.setattr(j_ssm_lm, "ssd_chunked", j_kernel_ssd)
        ref_kernels = j_compile(lambda p, t: jm.prefill(p, t, CTX, J_BASELINE),
                                jp, jt)(jp, jt)
    sk.reset_launch_counts()
    with torch.inference_mode():
        plain = m.prefill(tp, torch.from_numpy(tokens).long(), None, BASELINE)
        kern = m.prefill(tp, torch.from_numpy(tokens).long(), None,
                         replace(BASELINE, use_pallas=True))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, m=m, jp=jp, tp=tp, tokens=tokens,
                ref=ref, ref_kernels=ref_kernels, plain=plain, kern=kern,
                calls=dict(sk.launch_counts))


def test_config_matches_the_reference():
    j, t = j_get_arch(ARCH), get_arch(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(reduced(t)) == dataclasses.asdict(j_reduced(j))
    assert param_count(t) == j_param_count(j)
    assert isinstance(build(t), SSMLM)


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
    if full:
        # the float32 weights serving allocates at full width (11.33 GB)
        n = sum(int(np.prod(s[0])) for s in ts.values())
        assert 4 * n == 11_326_920_704


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
    # nothing grows with the sequence
    assert cache_shapes(cfg, B, S) == cache_shapes(cfg, B, S + G)


def test_the_mamba_layer_is_written_once():
    """The hybrid and the ssm-only model both run ``ssm.mamba_prefill``."""
    assert hybrid.mamba_prefill is ssm.mamba_prefill
    assert not hasattr(hybrid.HybridLM, "_mamba_prefill")


def test_prefill_plain_route_matches(setup):
    _hold_prefill(setup["ref"], setup["plain"], setup["cfg"], MODEL_TOL,
                  "use_pallas=False vs the reference's prefill")


def test_prefill_kernel_route_matches(setup):
    """use_pallas=True against the reference's model with its Pallas SSD
    kernel; one SSD launch a layer (here: its plain version, the tensors
    are on the CPU, so the counter stays 0)."""
    _hold_prefill(setup["ref_kernels"], setup["kern"], setup["cfg"],
                  MODEL_TOL, "use_pallas=True vs the reference with its "
                             "Pallas SSD kernel")
    assert setup["calls"] == {"ssd_scan": 0}
    # the first layer's state sees identical inputs on both sides: only
    # the kernels' float32 sum order differs
    assert norm_err(setup["ref_kernels"][1]["state"][0],
                    setup["kern"][1]["state"][0]) <= 1e-5


def test_prefill_cache_is_stacked_by_layer(setup):
    cfg, (_, cache) = setup["cfg"], setup["kern"]
    want = cache_shapes(cfg, B, S)
    assert {k: (tuple(t.shape), t.dtype) for k, t in cache.items()} == want


def test_prefill_then_decode_matches(setup):
    """Prefill, then G decode steps fed the same tokens on both sides (the
    cache needs no room: it is the recurrent state and the conv windows):
    every step's logits and the final cache."""
    cfg, jm, m = setup["cfg"], setup["jm"], setup["m"]
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, G))
    jcache = setup["ref"][1]

    def step(p, c, t, pos):
        return jm.decode_step(p, c, t, pos, CTX, J_BASELINE)
    tok0 = jnp.asarray(feed[:, :1], jnp.int32)
    jstep = j_compile(step, setup["jp"], jcache, tok0, jnp.int32(S))
    tcache = {k: v.clone() for k, v in setup["plain"][1].items()}
    assert serve.pad_cache(cfg, tcache, B, S, G) == tcache
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


def test_serve_leaves_the_recurrent_cache_as_it_is():
    """``serve.pad_cache`` pads nothing of an ssm cache (no entry grows with
    the sequence), where ``serve.run`` used to look for k/v."""
    cfg = reduced(get_arch(ARCH))
    m = build(cfg)
    params = init_params(m.param_specs(), torch.Generator().manual_seed(0))
    toks = make_batch(cfg, (B, 32), torch.Generator().manual_seed(1))["tokens"]
    with torch.inference_mode():
        _, cache = m.prefill(params, toks, None, BASELINE)
    padded = serve.pad_cache(cfg, cache, B, 32, G)
    assert all(padded[k] is cache[k] for k in cache)
    r = serve.run(cfg, batch=B, prompt_len=32, gen=G, seed=0,
                  device=torch.device("cpu"))
    assert r["decode_steps"] == G - 1 and len(r["tokens"][0]) == G
