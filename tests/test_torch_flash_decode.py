"""The port's sequence-sharded decode (``repro_torch.serve.flash_decode``,
``HybridLM.decode_step(seq_shard_decode=True)``, ``make_decode_step``)
against the plain decode and against the reference, on the CPU.

The port of ``tests/test_flash_decode.py``: reduced zamba2's shared
attention, batch 1, a 64-token cache (the ``long_500k`` regime: seq over
``data``), on the mesh (1, 2, 2) of 4 gloo processes, so that each rank
holds 32 positions of 2 KV heads, at ``pos`` 5 (the first data shard), 37
and 63 (the last).  The same numpy inputs go to the reference's
``seq_sharded_gqa_decode`` on 4 forced host devices in a subprocess.  Then
the whole hybrid decode step, ``make_decode_step(seq_shard_decode=True)``
on (1, 2, 1) over 2 gloo processes, against the reference's on 2 forced
host devices (one site: reduced zamba2 has 2 layers, ``attn_every`` 2).

Tolerances.  Sequence-sharded against plain: the reference's own bound,
2e-2 on the largest absolute difference of the attention output (the
probabilities reach the value product in bf16 with another max in each
shard), and the cache bit for bit.  Port against reference: the same 2e-2
on the attention output (both sides round q, k, v and o to bf16, in other
orders of their float32 sums); the cache bit for bit where both write the
same bf16 projections (the attention case), and, for the whole step,
``MODEL_TOL`` of ``tests/test_torch_models.py`` (2e-2 of the largest
value) on the logits and every cache leaf, as its decode test holds them.
The reference is compiled with ``xla_allow_excess_precision`` off.
Measured: sharded against plain <= 1.95e-3 (pos 5, where few positions
weigh most), against the reference <= 1.95e-3; the whole step's logits
0.0044 of plain's (the SSM caches 0.0068), equal to the reference's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as j_attn
import repro.models.common as j_common
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.models.registry import build as j_build
from repro_torch.bench import distributed as dist
from repro_torch.core.device import CPU_DEVICES_ENV
from repro_torch.models.common import tree_leaves_with_paths

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCH = "zamba2-2.7b"
S, POSITIONS, STEP_POS = 64, (5, 37, 63), 37
#: the reference's bound (``tests/test_flash_decode.py``), and the model
#: tests' (``tests/test_torch_models.py``)
DECODE_TOL = 2e-2
MODEL_TOL = 2e-2
ENV_ALL = (dist.ENV_COORDINATOR + dist.ENV_NUM_PROCESSES
           + dist.ENV_PROCESS_ID)

#: npz keys -> nested dicts, on either side
TREE = r"""
def tree(inp, prefix):
    t = {}
    for key in inp.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            d = t
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = inp[key]
    return t
"""

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_arch, reduced
from repro.distributed.sharding import ShardCtx
from repro.launch.mesh import make_mesh
from repro.models.registry import cache_abstract
from repro.models.variant import BASELINE
from repro.serve.flash_decode import seq_sharded_gqa_decode
from repro.train.step import make_decode_step
%s
out = sys.argv[1]
inp = np.load(f"{out}/inputs.npz")
cfg = reduced(get_arch(%r))
res = {}


def run(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


p = jax.tree.map(jnp.asarray, tree(inp, "attn/"))
x = jnp.asarray(inp["x"])
ck, cv = (jnp.asarray(inp[k], jnp.bfloat16) for k in ("ck", "cv"))
mesh = make_mesh((1, 2, 2), ("pod", "data", "model"))
ctx = ShardCtx(mesh)
with jax.set_mesh(mesh):
    for pos in %r:
        o, k, v = run(lambda x, ck, cv, pos: seq_sharded_gqa_decode(
            ctx, cfg, p, x, ck, cv, pos), x, ck, cv, jnp.int32(pos))
        res[f"o/{pos}"] = np.asarray(o, np.float32)
        res[f"k/{pos}"] = np.asarray(k.astype(jnp.float32))
        res[f"v/{pos}"] = np.asarray(v.astype(jnp.float32))

mesh2 = jax.make_mesh((1, 2, 1), ("pod", "data", "model"),
                      axis_types=(jax.sharding.AxisType.Auto,) * 3,
                      devices=jax.devices()[:2])
ctx2 = ShardCtx(mesh2)
params = jax.tree.map(jnp.asarray, tree(inp, "hp/"))
abs_t, _ = cache_abstract(cfg, 1, %d)
cache = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype),
                     tree(inp, "hc/"), abs_t)
step = make_decode_step(cfg, ctx2, BASELINE, seq_shard_decode=True)
with jax.set_mesh(mesh2):
    logits, new = run(lambda p, c, t, pos: step(p, c, {"tokens": t}, pos),
                      params, cache, jnp.asarray(inp["tok"]),
                      jnp.int32(%d))
res["step/logits"] = np.asarray(logits, np.float32)
for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
    name = "/".join(k.key for k in path)
    res[f"step/cache/{name}"] = np.asarray(leaf.astype(jnp.float32))
np.savez(f"{out}/ref.npz", **res)
print("REF_OK")
""" % (TREE, ARCH, POSITIONS, S, STEP_POS)

PORT = r"""
import json, sys
import numpy as np
import torch
from repro_torch.bench import distributed as dist
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.attention import gqa_decode
from repro_torch.models.common import tree_leaves_with_paths
from repro_torch.models.registry import cache_abstract
from repro_torch.models.variant import BASELINE
from repro_torch.serve import flash_decode as fd
from repro_torch.train.step import make_decode_step
%s
out, mode = sys.argv[1], sys.argv[2]
dist.ensure_initialized("cpu")
rank = dist.process_index()
inp = np.load(f"{out}/inputs.npz")
cfg = reduced(get_arch(%r))
res, report = {}, {}


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def walk(fn, tree):
    return ({k: walk(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


with torch.no_grad():
    if mode == "attention":
        ctx = ShardCtx(make_mesh((1, 2, 2), ("pod", "data", "model"),
                                 device="cpu"))
        p = walk(t, tree(inp, "attn/"))
        x = t(inp["x"])
        ck, cv = t(inp["ck"], torch.bfloat16), t(inp["cv"], torch.bfloat16)
        spec = fd.cache_spec(ctx, cfg)
        report["spec"] = list(spec)
        for pos in %r:
            kp, vp = ck.clone(), cv.clone()
            o_plain, _, _ = gqa_decode(cfg, p, x, kp, vp, pos)
            kb, vb = ctx.shard(ck, spec), ctx.shard(cv, spec)
            k0, v0 = kb.clone(), vb.clone()
            o, kb2, vb2 = fd.seq_sharded_gqa_decode(ctx, cfg, p, x, kb, vb,
                                                    pos)
            assert kb2 is kb and vb2 is vb        # in place
            rows = ((kb != k0) | (vb != v0)).flatten(2).any(-1).any(0)
            report[f"changed/{pos}"] = torch.nonzero(rows).flatten().tolist()
            report[f"block/{pos}"] = list(kb.shape)
            report["coords"] = ctx.mesh.coords
            res[f"o/{pos}"] = o.float().numpy()
            res[f"plain/{pos}"] = o_plain.float().numpy()
            res[f"k/{pos}"] = ctx.gather(kb, spec).float().numpy()
            res[f"v/{pos}"] = ctx.gather(vb, spec).float().numpy()
            res[f"kplain/{pos}"] = kp.float().numpy()
            res[f"vplain/{pos}"] = vp.float().numpy()
    else:
        ctx = ShardCtx(make_mesh((1, 2, 1), ("pod", "data", "model"),
                                 device="cpu"))
        params = walk(t, tree(inp, "hp/"))
        abs_t, _ = cache_abstract(cfg, 1, %d)
        raw = tree(inp, "hc/")

        def cache():
            return {"ssm": {k: t(raw["ssm"][k], abs_t["ssm"][k].dtype)
                            for k in raw["ssm"]},
                    "k": t(raw["k"], abs_t["k"].dtype),
                    "v": t(raw["v"], abs_t["v"].dtype)}
        tok = torch.from_numpy(inp["tok"]).long()
        held = fd.shard_cache(ctx, cfg, cache())
        report["block"] = list(held["k"].shape)
        step = make_decode_step(cfg, ctx, BASELINE, seq_shard_decode=True)
        logits, new = step(params, held, {"tokens": tok}, %d)
        spec = (None,) + fd.cache_spec(ctx, cfg)
        new = dict(new, k=ctx.gather(new["k"], spec),
                   v=ctx.gather(new["v"], spec))
        plain_logits, plain = make_decode_step(cfg, None, BASELINE)(
            params, cache(), {"tokens": tok}, %d)
        res["step/logits"] = logits.float().numpy()
        res["plain/logits"] = plain_logits.float().numpy()
        for path, leaf in tree_leaves_with_paths(new):
            res[f"step/cache/{path}"] = leaf.float().numpy()
        for path, leaf in tree_leaves_with_paths(plain):
            res[f"plain/cache/{path}"] = leaf.float().numpy()
np.savez(f"{out}/{mode}{rank}.npz", **res)
with open(f"{out}/{mode}{rank}.json", "w") as f:
    json.dump(report, f)
""" % (TREE, ARCH, POSITIONS, S, STEP_POS, STEP_POS)


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    for k in ("XLA_FLAGS", CPU_DEVICES_ENV) + ENV_ALL:
        env.pop(k, None)
    return env


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values that bfloat16 holds exactly."""
    return torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(path: Path) -> None:
    """Every input, from numpy seeds and the reference's ``init_params``."""
    jcfg = j_reduced(j_get_arch(ARCH))
    rng = np.random.default_rng(0)
    hd, KV = jcfg.resolved_head_dim, jcfg.n_kv_heads
    arrays = {"x": (rng.standard_normal((1, 1, jcfg.d_model)) * 0.3
                    ).astype(np.float32),
              "ck": _bf16(rng.standard_normal((1, S, KV, hd)) * 0.3),
              "cv": _bf16(rng.standard_normal((1, S, KV, hd)) * 0.3)}
    attn = j_common.init_params(j_attn.gqa_specs(jcfg, jcfg.d_model),
                                jax.random.key(0))
    params = j_common.init_params(j_build(jcfg).param_specs(),
                                  jax.random.key(1))
    for prefix, tree in (("attn/", attn), ("hp/", params)):
        for p, leaf in tree_leaves_with_paths(jax.tree.map(np.asarray,
                                                           tree)):
            arrays[prefix + p] = leaf
    from repro.models.registry import cache_abstract
    abs_t, _ = cache_abstract(jcfg, 1, S)
    for p, leaf in tree_leaves_with_paths(abs_t):
        a = rng.standard_normal(leaf.shape) * (0.1 if "state" in p else 0.3)
        arrays["hc/" + p] = (a.astype(np.float32) if leaf.dtype == jnp.float32
                             else _bf16(a))
    arrays["tok"] = rng.integers(0, jcfg.vocab_size, (1, 1)).astype(np.int32)
    np.savez(path, **arrays)


class _Sink(list):
    def write(self, s):
        self.append(s)

    def flush(self):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("flash_decode")
    _inputs(out / "inputs.npz")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(out)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=_env())
    try:
        for mode, n in (("attention", 4), ("step", 2)):
            sink = _Sink()
            rc = dist.launch_local([sys.executable, "-c", PORT, str(out),
                                    mode], processes=n, env=_env(),
                                   timeout=300, stream_to=sink, device="cpu")
            assert rc == 0, "".join(sink)[-4000:]
        stdout, stderr = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
    return dict(
        ref=dict(np.load(out / "ref.npz")),
        att=[dict(np.load(out / f"attention{r}.npz")) for r in range(4)],
        att_rep=[json.loads((out / f"attention{r}.json").read_text())
                 for r in range(4)],
        step=[dict(np.load(out / f"step{r}.npz")) for r in range(2)],
        step_rep=[json.loads((out / f"step{r}.json").read_text())
                  for r in range(2)])


def norm_err(ref, got) -> float:
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def test_cache_blocks_follow_the_reference_kv_spec(runs):
    """seq over data (2 x 32 positions), the 4 KV heads over model (2
    each): the reference's ``kv_spec`` on (1, 2, 2)."""
    for r in runs["att_rep"]:
        assert r["spec"] == [None, "data", "model"]
        assert all(r[f"block/{pos}"] == [1, S // 2, 2, 32]
                   for pos in POSITIONS)


@pytest.mark.parametrize("pos", POSITIONS)
def test_seq_sharded_decode_matches_plain(runs, pos):
    """Against the port's plain ``gqa_decode`` on the whole cache: the
    output within 2e-2, the gathered cache bit for bit, every rank's
    output the same."""
    r0 = runs["att"][0]
    do = float(np.abs(r0[f"o/{pos}"] - r0[f"plain/{pos}"]).max())
    assert do < DECODE_TOL, do
    assert np.array_equal(r0[f"k/{pos}"], r0[f"kplain/{pos}"])
    assert np.array_equal(r0[f"v/{pos}"], r0[f"vplain/{pos}"])
    for r in runs["att"][1:]:
        assert np.array_equal(r[f"o/{pos}"], r0[f"o/{pos}"])
        assert np.array_equal(r[f"k/{pos}"], r0[f"k/{pos}"])


@pytest.mark.parametrize("pos", POSITIONS)
def test_only_the_owner_of_pos_writes(runs, pos):
    """Only the data shard that owns ``pos`` changes a row (both its model
    ranks: each holds half the heads), and only row ``pos - start``; the
    other shard's cache does not change."""
    owner = pos // (S // 2)
    for r in runs["att_rep"]:
        if r["coords"]["data"] == owner:
            assert r[f"changed/{pos}"] == [pos - owner * (S // 2)]
        else:
            assert r[f"changed/{pos}"] == []


@pytest.mark.parametrize("pos", POSITIONS)
def test_seq_sharded_decode_matches_the_reference(runs, pos):
    """Against the reference's ``seq_sharded_gqa_decode`` on 4 forced host
    devices, mesh (1, 2, 2): the output within 2e-2, the cache bit for
    bit."""
    ref, r0 = runs["ref"], runs["att"][0]
    do = float(np.abs(r0[f"o/{pos}"] - ref[f"o/{pos}"]).max())
    assert do < DECODE_TOL, do
    assert np.array_equal(r0[f"k/{pos}"], ref[f"k/{pos}"])
    assert np.array_equal(r0[f"v/{pos}"], ref[f"v/{pos}"])


def test_decode_step_seq_sharded_matches_plain(runs):
    """``make_decode_step(seq_shard_decode=True)`` on (1, 2, 1) against the
    port's one-device step: the site's k / v (written before its
    attention, gathered) bit for bit; the logits and the SSM caches, which
    the attention's output feeds, within 2e-2 of their scale."""
    r0 = runs["step"][0]
    assert runs["step_rep"][0]["block"] == [1, 1, S // 2, 4, 32]
    assert norm_err(r0["plain/logits"], r0["step/logits"]) <= DECODE_TOL
    for key in (k for k in r0 if k.startswith("plain/cache/")):
        got = r0[key.replace("plain/", "step/")]
        if key.endswith(("/k", "/v")):
            assert np.array_equal(r0[key], got), key
        else:
            assert norm_err(r0[key], got) <= DECODE_TOL, key
    assert np.array_equal(runs["step"][1]["step/logits"], r0["step/logits"])


def test_decode_step_seq_sharded_matches_the_reference(runs):
    """The same step against the reference's on 2 forced host devices:
    logits and every cache leaf within MODEL_TOL."""
    ref, r0 = runs["ref"], runs["step"][0]
    assert norm_err(ref["step/logits"], r0["step/logits"]) <= MODEL_TOL
    keys = [k for k in ref if k.startswith("step/cache/")]
    assert sorted(keys) == sorted(k for k in r0 if k.startswith("step/cache/"))
    for key in keys:
        assert norm_err(ref[key], r0[key]) <= MODEL_TOL, key


def test_the_ssd_kernel_gets_contiguous_inputs_at_batch_1(monkeypatch):
    """The hybrid's prefill at batch 1 (long_500k's batch) through the
    kernel route hands ``ssd_scan`` a contiguous ``xdt`` and ``dA`` and B /
    C with unit stride on their last dim, as its wrapper requires on the
    card: at batch 1 the per-head (B*H, S, P) reshape of a permuted tensor
    is a view with other strides, which the wrapper refuses."""
    from dataclasses import replace

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build
    from repro_torch.models.variant import BASELINE
    seen, orig = [], ssd_ops.ssd

    def spy(xdt, dA, Bm, Cm, chunk):
        seen.append((xdt.is_contiguous(), dA.is_contiguous(), Bm.stride(-1),
                     Cm.stride(-1)))
        return orig(xdt, dA, Bm, Cm, chunk=chunk)
    monkeypatch.setattr(ssd_ops, "ssd", spy)
    cfg = reduced(get_arch(ARCH))
    model = build(cfg)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model.prefill(params, torch.zeros((1, 32), dtype=torch.int64), None,
                      replace(BASELINE, use_pallas=True))
    assert len(seen) == cfg.n_layers
    assert all(s == (True, True, 1, 1) for s in seen), seen
