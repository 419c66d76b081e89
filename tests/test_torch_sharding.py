"""The port's sharding rules (``repro_torch.distributed.sharding``,
``models.variant.apply_rules``, the registry's logical axes and held
layout) against the reference's, on the CPU.

The rules are held on ``jax.sharding.AbstractMesh``es, which need no
devices, against the port's ``AbstractMesh``: (1, 1, 1), (1, 4, 2) over
(pod, data, model), the production (16, 16) over (data, model) and (2, 16,
16).  ``spec``, ``resolve_dim`` and the ``fallbacks`` log must be equal,
for every logical name and sizes drawn from 1 to 4096.  Blocks and
collectives run in one launch of 4 gloo processes (one thread each): the
``shard`` -> ``gather`` round trip on (1, 2, 2), (1, 4, 1) and (2, 2, 1),
and the refusals (a world that does not match the mesh, a CUDA tensor at
a gloo collective).  Nothing here is compared with a tolerance: the rules
are exact and the round trip moves bits.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                     # optional dep; see pyproject [test]
    from _hypothesis_stub import given, settings, st

import repro.models.common as j_common
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.distributed.sharding import ShardCtx as JShardCtx
from repro.models.registry import build as j_build
from repro.models.registry import cache_abstract as j_cache_abstract
from repro.models.registry import input_abstract as j_input_abstract
from repro.models.variant import VARIANTS as J_VARIANTS
from repro.models.variant import apply_rules as j_apply_rules
from repro_torch.bench import distributed as dist
from repro_torch.configs import SHAPES, get_arch, list_archs, reduced
from repro_torch.core.device import CPU_DEVICES_ENV
from repro_torch.distributed import sharding as sh
from repro_torch.models import moe, registry
from repro_torch.models.common import spec_map, tree_leaves_with_paths
from repro_torch.models.variant import VARIANTS, apply_rules
from repro_torch.serve import flash_decode as fd

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
MESHES = [((1, 1, 1), ("pod", "data", "model")),
          ((1, 4, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["1x1x1", "1x4x2", "16x16", "2x16x16"]
NAMES = sorted(sh.DEFAULT_RULES) + ["unknown"]
ENV_ALL = (dist.ENV_COORDINATOR + dist.ENV_NUM_PROCESSES
           + dist.ENV_PROCESS_ID)


def ctx_pair(mesh):
    shape, axes = mesh
    return (JShardCtx(JAbstractMesh(shape, axes)),
            sh.ShardCtx(sh.AbstractMesh(shape, axes)))


def j_spec(ctx, shape, axes) -> tuple:
    return tuple(ctx.spec(shape, axes))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def test_rules_and_axis_sets_match_the_reference():
    from repro.distributed import sharding as j_sh
    assert sh.DEFAULT_RULES == j_sh.DEFAULT_RULES
    assert (sh.FSDP_AXES, sh.DP_AXES) == (j_sh.FSDP_AXES, j_sh.DP_AXES)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_mesh_helpers_match_the_reference(mesh):
    j, t = ctx_pair(mesh)
    assert (t.dp_axes, t.fsdp_axes, t.tp_axis) == \
        (j.dp_axes, j.fsdp_axes, j.tp_axis)
    for names in ((), ("data",), ("pod", "data"), ("model",), ("nope",),
                  mesh[1]):
        assert t.axis_size(*names) == j.axis_size(*names)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@settings(max_examples=60, deadline=None)
@given(st.integers(1, 4096), st.sampled_from(NAMES))
def test_resolve_dim_matches_the_reference(mesh, size, logical):
    j, t = ctx_pair(mesh)
    assert t.resolve_dim(logical, size) == j.resolve_dim(logical, size)
    assert t.fallbacks == j.fallbacks


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 4096),
                          st.sampled_from(NAMES + [None])),
                min_size=1, max_size=5))
def test_spec_matches_the_reference(mesh, dims):
    """A tensor of up to 5 dims: one mesh axis shards one dim, the
    trailing ``None`` trimmed, the fallbacks logged in the same order."""
    j, t = ctx_pair(mesh)
    shape = tuple(d[0] for d in dims)
    axes = tuple(None if d[1] == "unknown" else d[1] for d in dims)
    assert t.spec(shape, axes) == j_spec(j, shape, axes)
    assert t.fallbacks == j.fallbacks


@pytest.mark.parametrize("name", sorted(J_VARIANTS))
def test_apply_rules_matches_the_reference(name):
    assert sorted(VARIANTS) == sorted(J_VARIANTS)
    for mesh in MESHES:
        j, t = ctx_pair(mesh)
        j_apply_rules(j, J_VARIANTS[name])
        assert apply_rules(t, VARIANTS[name]) is t
        assert t.rules == j.rules
        for logical in ("act_seq", "kv_seq"):
            assert t.spec((1, 524288), ("batch", logical)) == \
                j_spec(j, (1, 524288), ("batch", logical))


# ---------------------------------------------------------------------------
# every param and cache leaf carries the reference's axes, and resolves
# ---------------------------------------------------------------------------

def _axes_by_path(tree):
    return dict(tree_leaves_with_paths(tree))


@pytest.mark.parametrize("arch", sorted(j_list_archs()))
def test_param_specs_cover_all_leaves(arch):
    """The port of the reference's ``test_param_specs_cover_all_leaves``
    (``tests/test_sharding.py``) at full width (specs only): every leaf's axes have its rank, equal the
    reference's, and resolve to the reference's spec on the multi-pod
    mesh."""
    assert sorted(list_archs()) == sorted(j_list_archs())
    specs = registry.build(get_arch(arch)).param_specs()
    j_specs = j_build(j_get_arch(arch)).param_specs()
    got = _axes_by_path(spec_map(lambda s: (s.shape, s.axes), specs))
    want = _axes_by_path(j_common.spec_map(lambda s: (s.shape, s.axes),
                                           j_specs))
    assert got == want
    j, t = ctx_pair(MESHES[3])
    for path, (shape, axes) in got.items():
        assert len(shape) == len(axes), (path, shape, axes)
        assert t.spec(shape, axes) == j_spec(j, shape, axes), path


@pytest.mark.parametrize("arch", sorted(j_list_archs()))
def test_cache_axes_match_the_reference(arch):
    """``cache_abstract``: every cache leaf's shape, dtype and logical axes
    (stacked dims without an axis) equal the reference's, at long_500k's
    batch 1 x 524,288 (meta tensors: nothing allocated), and resolve to the
    reference's spec on every mesh."""
    B, S = 1, 524288
    tabs, tax = registry.cache_abstract(get_arch(arch), B, S)
    jabs, jax_ = j_cache_abstract(j_get_arch(arch), B, S)
    got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for p, t in tree_leaves_with_paths(tabs)}
    want = {p: (tuple(a.shape), str(a.dtype))
            for p, a in tree_leaves_with_paths(jabs)}
    assert got == want
    assert all(t.device.type == "meta" for _, t in tree_leaves_with_paths(
        tabs))
    axes = _axes_by_path(tax)
    assert axes == _axes_by_path(jax_)
    for mesh in MESHES:
        j, t = ctx_pair(mesh)
        for path, (shape, _) in got.items():
            assert len(shape) == len(axes[path])
            assert t.spec(shape, axes[path]) == \
                j_spec(j, shape, axes[path]), (mesh, path)


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-medium"])
def test_input_abstract_matches_the_reference(arch, shape):
    batch, axes = registry.input_abstract(get_arch(arch), SHAPES[shape])
    jbatch, jaxes = j_input_abstract(j_get_arch(arch), J_SHAPES[shape])
    assert axes == jaxes
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in jbatch.items()}
    assert all(v.device.type == "meta" for v in batch.values())


def test_layout_reports_the_bytes_a_rank_holds():
    """long_500k's KV cache on zamba2-2.7b over 4 data positions: the
    rules put seq over data, 24.16 GB of k (9 sites) become 6.04 GB a
    rank; the SSM caches stay whole."""
    t = sh.ShardCtx(sh.AbstractMesh((1, 4, 1), ("pod", "data", "model")))
    tabs, tax = registry.cache_abstract(get_arch("zamba2-2.7b"), 1, 524288)
    rep = t.layout(tabs, tax)
    assert rep["k"]["spec"] == (None, None, "data")
    assert rep["k"]["bytes"] == 9 * 524288 * 32 * 80 * 2
    assert rep["k"]["bytes_a_rank"] * 4 == rep["k"]["bytes"]
    assert rep["ssm/state"]["bytes_a_rank"] == rep["ssm/state"]["bytes"]


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v2-236b"])
def test_held_axes_give_the_moe_layers_in_specs(arch):
    """``held_axes`` resolves, on every mesh, to the reference
    ``moe_layer``'s ``shard_map`` in_specs for each held leaf (E over
    model, D over the fsdp axes, ffn over model) where they divide, and
    every other leaf, the router too, to the block its own logical axes
    give (the reference's ``NamedSharding`` of it)."""
    cfg = get_arch(arch)
    specs = dict(tree_leaves_with_paths(registry.build(cfg).param_specs()))
    held = dict(tree_leaves_with_paths(registry.held_axes(cfg)))
    for mesh in MESHES:
        _, t = ctx_pair(mesh)
        fs = t.fsdp_axes if len(t.fsdp_axes) > 1 else t.fsdp_axes[0]
        fs = fs if t.axis_size(*t.fsdp_axes) > 1 else None
        tp = "model" if t.axis_size("model") > 1 else None
        want = {"w_gate": (None, tp, fs), "w_up": (None, tp, fs),
                "w_down": (None, tp, None, fs),
                "shared_gate": (None, fs, tp), "shared_up": (None, fs, tp),
                "shared_down": (None, tp, fs), "res_gate": (None, fs, tp),
                "res_up": (None, fs, tp), "res_down": (None, tp, fs)}
        for path, spec in specs.items():
            got = t.spec(spec.shape, held[path])
            name = path.split("/")[-1]
            if "moe" in path and name in moe.HELD:
                w = list(want[name])
                while w and w[-1] is None:
                    w.pop()
                assert got == tuple(w), (mesh, path, got)
            else:
                assert got == t.spec(spec.shape, spec.axes), (mesh, path, got)


def test_constrain_is_the_identity():
    t = sh.make_smoke_ctx()
    x = torch.ones(2, 3)
    assert t.constrain(x, "batch", None) is x
    with pytest.raises(ValueError):
        t.constrain(x, "batch")


# ---------------------------------------------------------------------------
# no mesh without its ranks
# ---------------------------------------------------------------------------

def test_the_sharded_path_refuses_fewer_ranks_than_the_mesh():
    """A mesh that names 4 positions with no process behind it: shard,
    gather, the expert-parallel layer and the sequence-sharded decode all
    raise, naming the ranks the mesh needs."""
    cfg = reduced(get_arch("zamba2-2.7b"))
    t = sh.ShardCtx(sh.AbstractMesh((1, 4, 1), ("pod", "data", "model")))
    x = torch.zeros(1, 8, 4, 2)
    for call in (lambda: t.shard(x, (None, "data")),
                 lambda: t.gather(x, (None, "data")),
                 lambda: t.all_reduce(x, ("data",))):
        with pytest.raises(RuntimeError, match="needs 4 ranks"):
            call()
    p = {k: torch.zeros(s.shape) for k, s in
         registry.build(cfg).param_specs()["shared"]["attn"].items()}
    kv = torch.zeros(1, 16, 4, 32, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        fd.seq_sharded_gqa_decode(t, cfg, p, torch.zeros(1, 1, cfg.d_model),
                                  kv, kv.clone(), 3)
    mcfg = reduced(get_arch("arctic-480b"))
    pm = {k: torch.zeros(s.shape) for k, s in moe.moe_specs(mcfg).items()}
    t = sh.ShardCtx(sh.AbstractMesh((1, 1, 4), ("pod", "data", "model")))
    pm = {k: (v[:1] if k.startswith("w_") else v) for k, v in pm.items()}
    pm = {k: (v[:, :v.shape[1] // 4] if k in ("res_gate", "res_up") else
              v[:v.shape[0] // 4] if k == "res_down" else v)
          for k, v in pm.items()}
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        moe.moe_layer(t, mcfg, pm, torch.zeros(2, 4, mcfg.d_model))
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        from repro_torch.train.step import make_train_step
        make_train_step(mcfg, t)


# ---------------------------------------------------------------------------
# blocks and collectives over 4 gloo ranks
# ---------------------------------------------------------------------------

WORKER = r"""
import json, sys, types
import numpy as np
import torch
from repro_torch.bench import distributed as dist
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.launch.mesh import make_mesh

out = sys.argv[1]
dist.ensure_initialized("cpu")
rank = dist.process_index()
full = torch.from_numpy(np.load(f"{out}/full.npy"))
report = {"round_trips": []}
for shape in ((1, 2, 2), (1, 4, 1), (2, 2, 1)):
    ctx = ShardCtx(make_mesh(shape, ("pod", "data", "model"), device="cpu"))
    for spec in ((None, "data", "model"), (("pod", "data"), None, "model"),
                 ("model", ("pod", "data")), ()):
        block = ctx.shard(full, spec)
        back = ctx.gather(block, spec)
        report["round_trips"].append({
            "shape": shape, "spec": repr(spec),
            "block": list(block.shape), "coords": ctx.mesh.coords,
            "equal": bool(torch.equal(back, full)),
            "block_sum": float(block.double().sum())})
        bf = ctx.gather(ctx.shard(full.to(torch.bfloat16), spec), spec)
        report["round_trips"][-1]["bf16_equal"] = bool(
            torch.equal(bf, full.to(torch.bfloat16)))
try:
    make_mesh((1, 2, 1), ("pod", "data", "model"), device="cpu")
    report["world_mismatch"] = "no error"
except ValueError as e:
    report["world_mismatch"] = str(e)
ctx = ShardCtx(make_mesh((1, 4, 1), ("pod", "data", "model"), device="cpu"))
fake = types.SimpleNamespace(device=torch.device("cuda", 0))
try:
    ctx.all_reduce(fake, ("data",))
    report["cuda_on_gloo"] = "no error"
except RuntimeError as e:
    report["cuda_on_gloo"] = str(e)
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(report, f)
"""


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding")
    full = np.random.default_rng(0).standard_normal((4, 8, 12)).astype(
        np.float32)
    np.save(out / "full.npy", full)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for k in ("XLA_FLAGS", CPU_DEVICES_ENV) + ENV_ALL:
        env.pop(k, None)
    lines: list[str] = []

    class Sink:
        def write(self, s):
            lines.append(s)

        def flush(self):
            pass
    rc = dist.launch_local([sys.executable, "-c", WORKER, str(out)],
                           processes=4, env=env, timeout=240,
                           stream_to=Sink(), device="cpu")
    assert rc == 0, "".join(lines)[-4000:]
    return full, [json.loads((out / f"rank{r}.json").read_text())
                  for r in range(4)]


def test_shard_then_gather_round_trips(gloo_run):
    """Every rank's block has the spec's shape and lies where its
    coordinates say (the blocks' sums add up to the whole's); the gather
    gives back the whole, in float32 and bfloat16, bit for bit."""
    full, ranks = gloo_run
    n = len(ranks[0]["round_trips"])
    for i in range(n):
        cases = [r["round_trips"][i] for r in ranks]
        assert all(c["equal"] and c["bf16_equal"] for c in cases), cases
        spec = cases[0]["spec"]
        if spec != "()":
            blocks = {c["block_sum"] for c in cases}
            # 4 ranks, each block held by 4 / (ways) ranks: the distinct
            # blocks sum to the whole
            ways = int(np.prod(full.shape) // np.prod(cases[0]["block"]))
            assert len(blocks) == ways, (spec, cases)
            assert abs(sum(blocks) - float(full.astype(np.float64).sum())) \
                < 1e-9, spec


def test_a_world_that_does_not_match_the_mesh_raises(gloo_run):
    for r in gloo_run[1]:
        assert "needs 2 processes; the world has 4" in r["world_mismatch"]


def test_a_cuda_tensor_at_a_gloo_collective_raises(gloo_run):
    for r in gloo_run[1]:
        assert "CUDA tensor reached a gloo collective" in r["cuda_on_gloo"]
