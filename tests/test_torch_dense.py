"""The port's dense and vlm families (``repro_torch.configs`` granite,
stablelm, internlm2, phi3, chameleon; ``repro_torch.models.transformer``;
the registry's dense branch; ``launch.serve`` on them) against the JAX
package, on the CPU.

Small size: each config ``reduced`` at two layers (d_model 128, 4 heads of
32, vocab 512), plus granite with 2 kv heads so that a GQA group of 2 is
exercised (``reduced`` gives every config 4 kv heads for 4 query heads);
batch 2, 64 tokens.  The weights are the reference's ``init_params``
carried across with ``params_from_reference``; the reference is compiled
with ``xla_allow_excess_precision`` off (``tests/test_torch_models.py``
says why).  Prefill is held on both routes: the plain route against the
reference's default prefill, the kernel route against the reference's
model with its own Pallas flash attention (interpret mode) in the prefill.
Then 3 decode steps.  Every whole-model comparison is held to MODEL_TOL,
the normalised max error of ``test_torch_models.py`` (measured over the
six cases: plain route <= 0.0077, kernel route <= 0.0076, the worst leaf
the logits or a layer's k/v).
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
from repro.configs import get_arch as j_get_arch
from repro.configs import param_count as j_param_count
from repro.configs import reduced as j_reduced
from repro.models.registry import build as j_build
from repro.models.registry import init_cache as j_init_cache
from repro.models.variant import BASELINE as J_BASELINE
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs import param_count, reduced
from repro_torch.convert import params_from_reference
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models.common import spec_map
from repro_torch.models.registry import (build, cache_shapes, init_cache,
                                         make_batch)
from repro_torch.models.variant import BASELINE
from test_torch_models import (CTX, MODEL_TOL, _hold_prefill, j_compile,
                               j_kernel_attention, leaves_with_paths,
                               norm_err)

ARCHS = ("granite-3-2b", "stablelm-3b", "internlm2-20b", "phi3-medium-14b",
         "chameleon-34b")
#: (arch, kv heads or None for reduced's): the five configs, and granite at
#: a GQA group of 2
CASES = [(a, None) for a in ARCHS] + [("granite-3-2b", 2)]
IDS = [a if kv is None else f"{a}-kv{kv}" for a, kv in CASES]
B, S, G = 2, 64, 3


def small(get, red, arch, kv):
    cfg = replace(red(get(arch)), n_layers=2)
    return cfg if kv is None else replace(cfg, n_kv_heads=kv)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def setup(request):
    arch, kv = request.param
    jcfg, cfg = small(j_get_arch, j_reduced, arch, kv), \
        small(get_arch, reduced, arch, kv)
    jm, m = j_build(jcfg), build(cfg)
    jp = j_common.init_params(jm.param_specs(), jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jt = jnp.asarray(tokens)
    ref = j_compile(lambda p, t: jm.prefill(p, t, CTX, J_BASELINE),
                    jp, jt)(jp, jt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_attn, "chunked_attention", j_kernel_attention)
        # a new function, so that jit traces it anew under the patch
        ref_kernels = j_compile(lambda p, t: jm.prefill(p, t, CTX, J_BASELINE),
                                jp, jt)(jp, jt)
    fa.reset_launch_counts()
    with torch.inference_mode():
        plain = m.prefill(tp, torch.from_numpy(tokens).long(), None, BASELINE)
        kern = m.prefill(tp, torch.from_numpy(tokens).long(), None,
                         replace(BASELINE, use_pallas=True))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, m=m, jp=jp, tp=tp, tokens=tokens,
                ref=ref, ref_kernels=ref_kernels, plain=plain, kern=kern,
                calls=dict(fa.launch_counts))


# ---------------------------------------------------------------------------
# configs, parameter specs, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_reference(arch):
    j, t = j_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(reduced(t)) == dataclasses.asdict(j_reduced(j))
    assert param_count(t) == j_param_count(j)


def test_registry_lists_the_ported_archs():
    """Every architecture the reference registers: the five dense / vlm
    configs, the hybrid, and the ssm, moe and encdec ones."""
    from repro.configs import list_archs as j_list_archs
    assert list_archs() == j_list_archs() == sorted(
        ARCHS + ("zamba2-2.7b", "mamba2-2.7b", "arctic-480b",
                 "deepseek-v2-236b", "whisper-medium"))


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


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_init_cache_and_cache_shapes_match_the_reference(case):
    jcfg, cfg = small(j_get_arch, j_reduced, *case), \
        small(get_arch, reduced, *case)
    jc = dict(leaves_with_paths(jax.tree.map(
        lambda a: (a.shape, str(a.dtype)), j_init_cache(jcfg, B, S + G))))
    tc = dict(leaves_with_paths(init_cache(cfg, B, S + G, "cpu")))
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tc.items()} == jc
    assert all(bool(torch.all(t == 0)) for t in tc.values())
    shapes = {p: (shp, str(dt).removeprefix("torch.")) for p, (shp, dt) in
              leaves_with_paths(cache_shapes(cfg, B, S + G))}
    assert shapes == jc


# ---------------------------------------------------------------------------
# the family as a whole: prefill on both routes, then decode
# ---------------------------------------------------------------------------

def test_prefill_plain_route_matches(setup):
    _hold_prefill(setup["ref"], setup["plain"], setup["cfg"], MODEL_TOL,
                  "use_pallas=False vs the reference's prefill")


def test_prefill_kernel_route_matches(setup):
    """use_pallas=True against the reference's model with its Pallas flash
    attention in the prefill; one flash launch a layer (here: its plain
    version, the tensors are on the CPU, so the counter stays 0)."""
    _hold_prefill(setup["ref_kernels"], setup["kern"], setup["cfg"],
                  MODEL_TOL, "use_pallas=True vs the reference with its "
                             "Pallas flash attention")
    assert setup["calls"] == {"flash_attn": 0}


def test_prefill_cache_is_stacked_by_layer(setup):
    cfg, (_, cache) = setup["cfg"], setup["kern"]
    hd = cfg.resolved_head_dim
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == (cfg.n_layers, B, S, cfg.n_kv_heads,
                                         hd)
        assert cache[k].dtype == torch.bfloat16


def test_prefill_then_decode_matches(setup):
    """Prefill, the cache padded by G as ``init_cache`` zeros it, then G
    decode steps fed the same tokens on both sides: every step's logits
    and the final cache."""
    cfg, jm, m = setup["cfg"], setup["jm"], setup["m"]
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, G))
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, G), (0, 0), (0, 0)))
              for k, v in setup["ref"][1].items()}

    def step(p, c, t, pos):
        return jm.decode_step(p, c, t, pos, CTX, J_BASELINE)
    tok0 = jnp.asarray(feed[:, :1], jnp.int32)
    jstep = j_compile(step, setup["jp"], jcache, tok0, jnp.int32(S))
    _, tcache = setup["plain"]
    tcache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, G))
              for k, v in tcache.items()}
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


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b"])
def test_serve_runs_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32", "--gen",
                       "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={arch} batch=2 prompt=32 gen=3"
    assert len(eval(lines[1].split(": ", 1)[1])) == 3


def test_serve_checks_only_the_kernels_the_model_has():
    """A dense model has no SSD: only the flash block rule applies."""
    cfg = reduced(get_arch("granite-3-2b"))
    serve.check_prompt_len(cfg, 48)        # the hybrid's SSD chunk 32 refuses
    with pytest.raises(ValueError, match="SSD chunk 32"):
        serve.check_prompt_len(reduced(get_arch("zamba2-2.7b")), 48)
    with pytest.raises(ValueError, match="flash-attention block 256"):
        serve.check_prompt_len(get_arch("granite-3-2b"), 300)


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b"])
def test_serve_pads_the_sequence_dim_of_either_cache(arch):
    """serve.run pads the prefill's k/v by ``gen`` on the sequence dim:
    (L, B, S, KV, hd) for the dense family, (sites, B, S, KV, hd) for the
    hybrid — the shapes ``init_cache`` makes for S + gen."""
    cfg = reduced(get_arch(arch))
    m = build(cfg)
    from repro_torch.models.common import init_params
    params = init_params(m.param_specs(), torch.Generator().manual_seed(0))
    toks = make_batch(cfg, (B, 32), torch.Generator().manual_seed(1))["tokens"]
    with torch.inference_mode():
        _, cache = m.prefill(params, toks, None, BASELINE)
    want = cache_shapes(cfg, B, 32 + G)
    for k in ("k", "v"):
        padded = torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, G))
        assert tuple(padded.shape) == want[k][0]
        assert torch.equal(padded[:, :, :32], cache[k])
