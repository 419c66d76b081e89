"""The port's expert-parallel MoE layer (``repro_torch.models.moe.moe_layer``
on a mesh; ``registry.held_axes`` / ``shard_params`` /
``init_params_held``; ``DecoderLM`` serving with a mesh ctx) against the
reference's ``moe_layer`` on a forced 4-device mesh, on the CPU.

Reduced deepseek-v2-236b (4 experts, top 2, one shared expert) and reduced
arctic-480b (4 experts, top 2, the dense residual) on the meshes (1, 1, 4)
(one expert a rank) and (1, 2, 2) (two experts a rank, D over ``data``,
the batch's halves on the two data shards, each rank handed its half),
over 4 gloo processes, one thread each; the reference runs the same
cases in one subprocess on 4 forced host devices.  A case with capacity
factor 0.5 drops tokens, and one combines over ``model`` in bfloat16
(``psum_dtype``).

Inputs.  The layer input is a multiple of 1/8 in [-1, 1] and the router a
multiple of 1/16 in [-1/4, 1/4]: every router logit is then an exact
float32 sum (multiples of 2^-7 below 32) that both sides round once to
bf16, so the two sides route alike, ties to the lower expert index, and
the comparison is of dispatch, capacity and combine, not of a near-tie.
The experts' weights are the reference's ``init_params``.

Tolerances.  ``y`` against the reference: ``MODEL_TOL`` of
``tests/test_torch_models.py`` (2e-2 of the largest value: bf16 expert
products and float32 sums in another order; the bf16 combine as much
again); ``aux`` within 1e-6 relative (float32 means of the same choices).
The mesh against the port's one-device path on each data shard: the same
2e-2 (the shared experts' and the residual's bf16 partial products
rounded on each ``model`` rank before the float32 sum).  Measured: ``y``
against the reference <= 2.2e-6 in float32, 4.5e-3 with the bf16
combine; ``aux`` 1.2e-7; the mesh against one device per shard <= 4.8e-3,
the whole model's logits <= 8.2e-3.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.models.common as j_common
import repro.models.moe as j_moe
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro_torch.bench import distributed as dist
from repro_torch.core.device import CPU_DEVICES_ENV

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCHS = ("deepseek-v2-236b", "arctic-480b")
B, S = 4, 8
#: (mesh, arch, capacity factor, psum dtype)
CASES = [((1, 1, 4), "deepseek-v2-236b", None, "float32"),
         ((1, 1, 4), "arctic-480b", None, "float32"),
         ((1, 2, 2), "deepseek-v2-236b", None, "float32"),
         ((1, 2, 2), "arctic-480b", None, "float32"),
         ((1, 2, 2), "deepseek-v2-236b", 0.5, "float32"),
         ((1, 1, 4), "arctic-480b", 0.5, "bfloat16")]
CASE_IDS = [f"{'x'.join(map(str, m))}-{a.split('-')[0]}-cf{cf}-{ps}"
            for m, a, cf, ps in CASES]
#: the whole-model serving cases (mesh, arch)
MODEL_CASES = [((1, 2, 2), "deepseek-v2-236b"), ((1, 1, 4), "arctic-480b")]
MODEL_TOL = 2e-2
AUX_TOL = 1e-6
ENV_ALL = (dist.ENV_COORDINATOR + dist.ENV_NUM_PROCESSES
           + dist.ENV_PROCESS_ID)

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_arch, reduced
from repro.distributed.sharding import ShardCtx
from repro.launch.mesh import make_mesh
from repro.models.moe import moe_layer

out = sys.argv[1]
inp = np.load(f"{out}/inputs.npz")
cases = %r
res = {}
meshes = {}
for i, (shape, arch, cf, psum) in enumerate(cases):
    cfg = reduced(get_arch(arch))
    mesh = meshes.setdefault(shape, make_mesh(shape, ("pod", "data", "model")))
    ctx = ShardCtx(mesh)
    p = {k[len(arch) + 1:]: jnp.asarray(inp[k]) for k in inp.files
         if k.startswith(arch + "/")}
    x = jnp.asarray(inp["x"])
    fn = lambda p, x: moe_layer(ctx, cfg, p, x, capacity_factor=cf,
                                psum_dtype=psum)
    with jax.set_mesh(mesh):
        y, aux = jax.jit(fn).lower(p, x).compile(compiler_options={
            "xla_allow_excess_precision": False})(p, x)
    res[f"{i}/y"] = np.asarray(y, np.float32)
    res[f"{i}/aux"] = np.asarray(aux, np.float32)
    xf = x.reshape(-1, x.shape[-1]).astype(jnp.bfloat16)
    logits = (xf @ p["router"].astype(jnp.bfloat16)).astype(jnp.float32)
    res[f"{i}/topi"] = np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                                cfg.moe.top_k)[1])
np.savez(f"{out}/ref.npz", **res)
print("REF_OK")
""" % (CASES,)

PORT = r"""
import json, sys
import numpy as np
import torch
from repro_torch.bench import distributed as dist
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import pad_cache
from repro_torch.models import moe, registry
from repro_torch.models.common import init_params, tree_leaves_with_paths
from repro_torch.models.variant import BASELINE

out = sys.argv[1]
cases, model_cases, B, S = %r, %r, %d, %d
dist.ensure_initialized("cpu")
rank = dist.process_index()
inp = np.load(f"{out}/inputs.npz")
meshes = {}
res, report = {}, {"cases": [], "models": []}
routes = []
orig_route = moe.route


def recording_route(cfg, p, xf):
    out = orig_route(cfg, p, xf)
    routes.append(out[2].clone())
    return out


moe.route = recording_route


def ctx_for(shape):
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("pod", "data", "model"),
                                  device="cpu")
    return ShardCtx(meshes[shape])


with torch.no_grad():
    x = torch.from_numpy(inp["x"])
    for i, (shape, arch, cf, psum) in enumerate(cases):
        cfg = reduced(get_arch(arch))
        ctx = ctx_for(tuple(shape))
        specs = moe.moe_specs(cfg)
        p = {k[len(arch) + 1:]: torch.from_numpy(inp[k]) for k in inp.files
             if k.startswith(arch + "/")}
        held = {k: ctx.shard(v, ctx.spec(v.shape, specs[k].axes
                                         if k in moe.HELD else
                                         (None,) * v.ndim))
                for k, v in p.items()}
        routes.clear()
        # the layer takes this rank's block of the batch over the data axes
        bspec = ctx.spec(x.shape, ("batch", None, None))
        y, aux = moe.moe_layer(ctx, cfg, held, ctx.shard(x, bspec),
                               capacity_factor=cf, psum_dtype=psum)
        y = ctx.gather(y, bspec)
        topi = routes[0]
        # the one-device path on each data shard alone, and on the whole
        dp = ctx.axis_size("pod", "data")
        halves = [moe.moe_layer(None, cfg, p, xs, capacity_factor=cf)[0]
                  for xs in x.chunk(dp)]
        whole = moe.moe_layer(None, cfg, p, x, capacity_factor=cf)[0]
        res[f"{i}/y"] = y.float().numpy()
        res[f"{i}/aux"] = aux.float().numpy()
        res[f"{i}/shards"] = torch.cat(halves).float().numpy()
        res[f"{i}/whole"] = whole.float().numpy()
        res[f"{i}/topi"] = topi.numpy()
        report["cases"].append({
            "blocks": {k: list(v.shape) for k, v in held.items()},
            "coords": ctx.mesh.coords, "routed_tokens": topi.shape[0]})
    for shape, arch in model_cases:
        cfg = reduced(get_arch(arch))
        ctx = ctx_for(tuple(shape))
        model = registry.build(cfg)
        params = init_params(model.param_specs(),
                             torch.Generator().manual_seed(0))
        held = registry.shard_params(cfg, params, ctx)
        drawn = registry.init_params_held(cfg, ctx, 0, "cpu")
        tokens = torch.from_numpy(inp["tokens"]).long()
        bspec = ctx.spec(tokens.shape, ("batch", None))
        lg, cache = model.prefill(held, ctx.shard(tokens, bspec), ctx,
                                  BASELINE)
        dp = ctx.axis_size("pod", "data")
        ref = [model.prefill(params, t, None, BASELINE) for t in
               tokens.chunk(dp)]
        ref_lg = torch.cat([r[0] for r in ref])
        nxt = torch.argmax(ref_lg[:, :cfg.vocab_size], -1)[:, None]
        dlg, _ = model.decode_step(held, pad_cache(cfg, cache, B // dp, S,
                                                   1),
                                   ctx.shard(nxt, bspec), S, ctx, BASELINE)
        lg, dlg = ctx.gather(lg, bspec), ctx.gather(dlg, bspec)
        ref_d = [model.decode_step(params, pad_cache(cfg, rc, B // dp, S, 1),
                                   t, S, None, BASELINE)[0]
                 for (_, rc), t in zip(ref, nxt.chunk(dp))]
        key = f"model/{'x'.join(map(str, shape))}/{arch}"
        res[f"{key}/prefill"] = lg.float().numpy()
        res[f"{key}/prefill_ref"] = ref_lg.float().numpy()
        res[f"{key}/decode"] = dlg.float().numpy()
        res[f"{key}/decode_ref"] = torch.cat(ref_d).float().numpy()
        held_shapes = {p: list(t.shape) for p, t in
                       tree_leaves_with_paths(held)}
        drawn_shapes = {p: list(t.shape) for p, t in
                        tree_leaves_with_paths(drawn)}
        report["models"].append({
            "key": key, "held_equal_drawn": held_shapes == drawn_shapes,
            "w_gate": held_shapes["blocks/moe/w_gate"],
            "router": held_shapes["blocks/moe/router"]})
np.savez(f"{out}/rank{rank}.npz", **res)
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(report, f)
""" % (CASES, MODEL_CASES, B, S)


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    for k in ("XLA_FLAGS", CPU_DEVICES_ENV) + ENV_ALL:
        env.pop(k, None)
    return env


def _inputs(path: Path) -> None:
    rng = np.random.default_rng(0)
    arrays = {}
    for i, arch in enumerate(ARCHS):
        jcfg = j_reduced(j_get_arch(arch))
        p = jax.tree.map(np.asarray, j_common.init_params(
            j_moe.moe_specs(jcfg), jax.random.key(i)))
        p["router"] = (rng.integers(-4, 5, p["router"].shape) / 16).astype(
            np.float32)
        for k, v in p.items():
            arrays[f"{arch}/{k}"] = v
    D = j_reduced(j_get_arch(ARCHS[0])).d_model
    arrays["x"] = (rng.integers(-8, 9, (B, S, D)) / 8).astype(np.float32)
    arrays["tokens"] = rng.integers(0, 512, (B, S)).astype(np.int64)
    np.savez(path, **arrays)


class _Sink(list):
    def write(self, s):
        self.append(s)

    def flush(self):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep")
    _inputs(out / "inputs.npz")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(out)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=_env())
    try:
        sink = _Sink()
        rc = dist.launch_local([sys.executable, "-c", PORT, str(out)],
                               processes=4, env=_env(), timeout=300,
                               stream_to=sink, device="cpu")
        assert rc == 0, "".join(sink)[-4000:]
        stdout, stderr = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
    return dict(ref=dict(np.load(out / "ref.npz")),
                port=[dict(np.load(out / f"rank{r}.npz")) for r in range(4)],
                rep=[json.loads((out / f"rank{r}.json").read_text())
                     for r in range(4)])


def norm_err(ref, got) -> float:
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def drops(topi: np.ndarray, E: int, K: int, shards: int, cf: float) -> int:
    """Choices past their expert's capacity, per data shard of the flattened
    (token, choice) order, as the reference's ``moe_layer`` counts slots."""
    n = 0
    for part in np.split(topi.reshape(shards, -1, K), shards):
        flat = part.reshape(-1)
        T = flat.size // K
        C = max(1, int(np.ceil(T * K / E * cf)))
        n += int(sum(max(0, int((flat == e).sum()) - C) for e in range(E)))
    return n


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_routing_matches_the_reference(runs, case):
    """Every rank routes the tokens of its data shard (routing is
    replicated over ``model``) to the reference's experts."""
    shape = CASES[case][0]
    dp = shape[0] * shape[1]
    want = runs["ref"][f"{case}/topi"].reshape(dp, B * S // dp, -1)
    for r, rep in zip(runs["port"], runs["rep"]):
        coords = rep["cases"][case]["coords"]
        d = coords["pod"] * shape[1] + coords["data"]
        assert np.array_equal(r[f"{case}/topi"], want[d])


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_moe_layer_matches_the_reference(runs, case):
    """``y`` and ``aux`` against the reference's ``moe_layer`` on the same
    mesh; every rank holds the same whole ``y``."""
    ref = runs["ref"]
    for r in runs["port"]:
        assert norm_err(ref[f"{case}/y"], r[f"{case}/y"]) <= MODEL_TOL
        assert abs(float(r[f"{case}/aux"]) - float(ref[f"{case}/aux"])) <= \
            AUX_TOL * abs(float(ref[f"{case}/aux"]))
        assert np.array_equal(r[f"{case}/y"], runs["port"][0][f"{case}/y"])


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_blocks_are_held_as_the_mesh_says(runs, case):
    shape, arch, _, _ = CASES[case]
    ep, fs = shape[2], shape[0] * shape[1]
    blocks = runs["rep"][0]["cases"][case]["blocks"]
    assert blocks["w_gate"] == [4 // ep, 128 // fs, 64]
    assert blocks["w_down"] == [4 // ep, 64, 128 // fs]
    assert blocks["router"] == [128, 4]
    name = "shared_gate" if arch.startswith("deepseek") else "res_gate"
    F = 64 if arch.startswith("deepseek") else 256
    assert blocks[name] == [128 // fs, F // ep]


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_capacity_is_per_data_shard(runs, case):
    """The mesh equals the port's one-device path run on each data shard
    alone; where capacity drops tokens per shard that the whole batch
    would keep, the one-device run of the whole batch differs."""
    shape, arch, cf, _ = CASES[case]
    r0 = runs["port"][0]
    assert norm_err(r0[f"{case}/shards"], r0[f"{case}/y"]) <= MODEL_TOL
    from repro_torch.configs import get_arch, reduced
    m = reduced(get_arch(arch)).moe
    cf = cf if cf is not None else m.capacity_factor
    topi = runs["ref"][f"{case}/topi"]
    shards = shape[0] * shape[1]
    per_shard = drops(topi, m.n_experts, m.top_k, shards, cf)
    if cf == 0.5:
        assert per_shard > 0
    if per_shard != drops(topi, m.n_experts, m.top_k, 1, cf):
        assert norm_err(r0[f"{case}/whole"], r0[f"{case}/y"]) > MODEL_TOL


@pytest.mark.parametrize("mc", range(len(MODEL_CASES)),
                         ids=[f"{'x'.join(map(str, m))}-{a}"
                              for m, a in MODEL_CASES])
def test_serving_on_the_mesh_matches_one_device(runs, mc):
    """``DecoderLM.prefill`` and a ``decode_step`` with the mesh ctx on the
    held parameters (``shard_params``) against the one-device path on
    each data shard: logits within MODEL_TOL; ``init_params_held`` draws
    blocks of the held shapes."""
    shape, arch = MODEL_CASES[mc]
    key = f"model/{'x'.join(map(str, shape))}/{arch}"
    for r in runs["port"]:
        for what in ("prefill", "decode"):
            assert norm_err(r[f"{key}/{what}_ref"], r[f"{key}/{what}"]) \
                <= MODEL_TOL, what
    rep = next(m for m in runs["rep"][0]["models"] if m["key"] == key)
    assert rep["held_equal_drawn"]
    assert rep["w_gate"] == [2, 4 // shape[2], 128 // shape[1], 64]
    assert rep["router"] == [2, 128 // shape[1], 4]
