"""Tensor and sequence parallelism over ``model`` (``repro_torch.
distributed.sharding``'s ``rank_heads``, ``rank_block``, ``TP`` and
``tp_plan``; the models' column and row splits, the vocabulary-parallel
head) on the CPU.

The rank's share is held on ``jax.sharding.AbstractMesh``es, which need
no devices: for every registered arch at a ``model`` axis of 2, 4 and 16,
every rank's query heads, KV heads (and the KV head each of its query
heads reads), ffn, SSD heads, inner and vocabulary blocks equal what the
reference's ``ShardCtx.resolve_dim`` / ``spec`` give, and the fallbacks
logged are the reference's (phi3's 10 KV heads over 4, its 40 heads over
16).

The rest runs in one launch of 2 gloo processes, one thread each, on the
mesh (1, 1, 2), against the port's own one-device path on the same inputs
(reduced configs, weights and batches from seeded generators):

- a rank's matmul FLOPs (``torch.utils.flop_counter.FlopCounterMode``) of
  granite-3-2b's loss, forward and backward, at most 0.6 of one device's
  (replicated compute over ``model`` gave 1.0);
- the collective census of a train step (``ShardCtx.all_gather`` /
  ``all_reduce`` / ``reduce_scatter`` recorded): every all-gather over
  ``model`` is of a residual-stream block, never of a parameter, and the
  forward issues one reduction over ``model`` per attention and per MLP,
  and one for the embedding;
- the gradients with sequence parallelism and without (``nosp``, through
  ``apply_rules``) within 2e-3 relative RMS, granite and zamba2;
- serving: prefill and 4 decode steps teacher-forced with the one-device
  tokens, for granite, zamba2, mamba2, whisper and granite with 6 query
  and 3 KV heads (the KV heads fall back to whole: a rank's query heads
  start inside a group, phi3's case at 4): each decode attention within
  2e-2 of the one-device one (the reference's bound on a sharded decode
  attention), the logits within 0.15 relative RMS (``chip_smoke.py`` phase
  3d's), the first attention layer's cache, gathered over ``model``, bit
  for bit (nothing reaches it through a reduction), the first Mamba
  layer's caches gathered over ``model`` (the SSD heads' ``state``, the
  inner dims' ``conv_x``; ``conv_B`` / ``conv_C`` whole) bit for bit but
  the float32 ``state``, within 1e-5 relative RMS, and each decode step
  writing row ``pos`` only.

Measured: FLOPs a rank 0.52 of one device (0.50 and, under remat, the
checkpoint's recompute of each layer's last row split, a custom autograd
Function it cannot stop before); the gradients with and
without sequence parallelism within 1.9e-7 (float32 sums of the norms'
gradients in another order; the bf16 roundings are the same: a
reduce-scatter of two values and the mean all-reduce of the whole
stream's gradient add the same pairs); logits bit for bit for granite,
mamba2 and whisper, within 3.3e-3 for zamba2 and the 6/3-head granite,
decode attention within 3.9e-3 (one bf16 step of the output), the SSM
state within 4.5e-7.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.distributed.sharding import ShardCtx as JShardCtx
from repro_torch.bench import distributed as dist
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.device import CPU_DEVICES_ENV
from repro_torch.distributed import sharding as sh
from repro_torch.models.common import vocab_padded
from repro_torch.models.ssm import ssm_dims

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ENV_ALL = (dist.ENV_COORDINATOR + dist.ENV_NUM_PROCESSES
           + dist.ENV_PROCESS_ID)
FLOPS_RATIO = 0.6
SP_TOL = 2e-3
ATTN_TOL, LOGITS_RMS_TOL = 2e-2, 0.15
#: the SSM state (float32) against one device's: its sums over the rank's
#: heads run in another order (measured 3.1e-8 mamba2, 4.5e-7 zamba2)
STATE_RMS_TOL = 1e-5
SERVE = ["granite-3-2b", "zamba2-2.7b", "mamba2-2.7b", "whisper-medium",
         "granite-kv3"]


# ---------------------------------------------------------------------------
# the rank's share, against the reference's resolution
# ---------------------------------------------------------------------------

def _j_block(j, size: int, logical: str, leaf_shape, leaf_axes, dim: int,
             rank: int):
    """(start, length) of ``rank``'s block of dim ``dim`` of a leaf under
    the reference's ``spec``."""
    entry = (tuple(j.spec(leaf_shape, leaf_axes)) + (None,) * 4)[dim]
    if entry is None:
        return 0, size
    n = j.axis_size(*((entry,) if isinstance(entry, str) else entry))
    return rank * (size // n), size // n


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("arch", list_archs())
def test_rank_share_matches_the_reference(arch, m):
    cfg = get_arch(arch)
    names, shape = ("pod", "data", "model"), (1, 1, m)
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, \
        cfg.d_model
    for rank in range(m):
        t = sh.ShardCtx(sh.AbstractMesh(shape, names))
        j = JShardCtx(JAbstractMesh(shape, names))
        if cfg.family != "ssm":
            heads = sh.rank_heads(t, H, KV, rank)
            # _constrain_qkv: act_heads first, kv_heads only where it
            # resolves
            jq = j.resolve_dim("act_heads", H)
            q = (rank * H // m, H // m) if jq else (0, H)
            assert (heads.q0, heads.nq) == q, (rank, heads)
            kv = (0, KV)
            if jq:
                kv = _j_block(j, KV, "kv_heads", (d, KV, hd),
                              ("embed", "kv_heads", "head_dim"), 1, rank)
            assert (heads.kv0, heads.nkv) == kv, (rank, heads)
            g = H // KV
            for i in range(heads.nq):
                local = (heads.kv_of_q[i] if heads.kv_of_q is not None
                         else i // (heads.nq // heads.nkv))
                assert heads.kv0 + local == (heads.q0 + i) // g
            assert heads.split == bool(jq)
        blocks = {"vocab": (vocab_padded(cfg), (vocab_padded(cfg), d),
                            ("vocab", "embed"), 0)}
        if cfg.d_ff:
            blocks["ffn"] = (cfg.d_ff, (d, cfg.d_ff), ("embed", "ffn"), 1)
        if cfg.ssm is not None:
            d_in, Hs = ssm_dims(cfg)
            blocks["inner"] = (d_in, (d, d_in), ("embed", "inner"), 1)
            blocks["heads"] = (Hs, (d, Hs), ("embed", "heads"), 1)
        for logical, (size, lshape, laxes, dim) in blocks.items():
            assert sh.rank_block(t, logical, size, rank) == _j_block(
                j, size, logical, lshape, laxes, dim, rank), logical
        assert set(t.fallbacks) == set(j.fallbacks), (t.fallbacks,
                                                      j.fallbacks)


def test_phi3_falls_back_as_the_reference_does():
    """phi3-medium's 40 query / 10 KV heads: over 4, a rank's 10 query
    heads and every KV head, rank 1's reading KV heads 2-4; over 16 the
    query heads do not divide, and the rank computes every head of its
    block of a sequence that ``act_seq`` splits (the reference's
    ``_constrain_qkv`` fallback), every head of the whole without one."""
    cfg = get_arch("phi3-medium-14b")
    t = sh.ShardCtx(sh.AbstractMesh((1, 1, 4), ("pod", "data", "model")))
    h = sh.rank_heads(t, cfg.n_heads, cfg.n_kv_heads, 1)
    assert (h.q0, h.nq, h.kv0, h.nkv) == (10, 10, 0, 10)
    assert h.kv_of_q == (2, 2, 3, 3, 3, 3, 4, 4, 4, 4)
    assert t.fallbacks == ["kv_heads(10) !% ('model',)(4)"]
    t = sh.ShardCtx(sh.AbstractMesh((1, 1, 16), ("pod", "data", "model")))
    h = sh.rank_heads(t, cfg.n_heads, cfg.n_kv_heads, 5, seq_len=4096)
    assert (h.q0, h.nq, h.kv0, h.nkv, h.split) == (0, 40, 0, 10, False)
    assert h.seq and (h.q0_seq, h.nq_seq) == (5 * 256, 256)
    assert not sh.rank_heads(t, cfg.n_heads, cfg.n_kv_heads, 5).seq
    assert t.fallbacks == ["act_heads(40) !% ('model',)(16)"]


def test_no_model_axis_is_one_device():
    """``tp_plan`` without a ``model`` axis of more than one position is
    ``NO_TP``, whose every method is the identity."""
    for ctx in (None, sh.make_smoke_ctx(),
                sh.ShardCtx(sh.AbstractMesh((1, 4, 1),
                                            ("pod", "data", "model")))):
        assert sh.tp_plan(ctx, 64) is sh.NO_TP
    import torch
    x = torch.ones(2, 4, 3)
    tp = sh.NO_TP
    assert tp.gather_seq(x) is x and tp.reduce(x) is x and tp.sum(x) is x
    assert tp.heads(6, 3).kv_of_q is None and not tp.heads(6, 3).split


# ---------------------------------------------------------------------------
# two gloo ranks on (1, 1, 2)
# ---------------------------------------------------------------------------

WORKER = r"""
import json, sys
from dataclasses import replace
import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.bench import distributed as dist
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import pad_cache
from repro_torch.models import attention as attn
from repro_torch.models import registry
from repro_torch.models.common import (init_params, tree_leaves,
                                       tree_leaves_with_paths)
from repro_torch.models.variant import BASELINE, VARIANTS, apply_rules
from repro_torch.optim import adamw
from repro_torch.train import step as step_mod

out, serve_archs = sys.argv[1], %r
#: an SSM cache leaf -> its dim over ``model`` (heads, inner), if split
SSM_CACHE = {"state": 1, "conv_x": 2, "conv_B": None, "conv_C": None}
dist.ensure_initialized("cpu")
rank = dist.process_index()
mesh = make_mesh((1, 1, 2), ("pod", "data", "model"), device="cpu")
res, rep = {}, {}


def config(arch):
    if arch == "granite-kv3":
        return replace(reduced(get_arch("granite-3-2b")), n_heads=6,
                       n_kv_heads=3)
    return reduced(get_arch(arch))


def setup(arch, B, S):
    cfg = config(arch)
    model = registry.build(cfg)
    params = init_params(model.param_specs(),
                         torch.Generator().manual_seed(0))
    batch = registry.make_batch(cfg, (B, S), torch.Generator().manual_seed(1))
    return cfg, model, params, batch


def clone(t):
    return ({k: clone(v) for k, v in t.items()} if isinstance(t, dict)
            else t.clone())


calls = []
for meth in ("all_gather", "reduce_scatter", "all_reduce", "mean_equal"):
    def wrap(self, t, *a, _orig=getattr(sh.ShardCtx, meth), _name=meth,
             **k):
        axes = a[0] if a else k.get("axis", k.get("axes"))
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        calls.append((_name, axes, tuple(t.shape), torch.is_grad_enabled()))
        return _orig(self, t, *a, **k)
    setattr(sh.ShardCtx, meth, wrap)

# 1) FLOPs of the loss, forward and backward
cfg, model, params, batch = setup("granite-3-2b", 8, 64)
ctx = sh.ShardCtx(mesh)
held = registry.shard_params(cfg, clone(params), ctx)
for name, p, c in (("mesh", held, ctx), ("one", params, None)):
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        loss, _ = model.loss(p, batch, c, BASELINE)
        torch.autograd.grad(loss, leaves)
    rep[f"flops/{name}"] = fc.get_total_flops()

# 2) the census: a train step, then the forward alone, with and without SP
seen = {}
orig_apply = adamw.apply


def apply(c, p, s, grads, *a):
    seen["g"] = grads
    return orig_apply(c, p, s, grads, *a)


step_mod.adamw.apply = apply
specs = dict(tree_leaves_with_paths(model.param_specs()))
rep["blocks"] = [list(t.shape) for _, t in tree_leaves_with_paths(held)]
for vname in ("baseline", "nosp"):
    c = apply_rules(sh.ShardCtx(mesh), VARIANTS[vname])
    h = registry.shard_params(cfg, clone(params), c)
    calls.clear()
    step_mod.make_train_step(cfg, c, adamw.AdamWConfig(lr=1e-3))(
        h, adamw.init_state(h), batch)
    rep[f"step_calls/{vname}"] = [list(map(list, x[1:3])) + [x[0], x[3]]
                                  for x in calls]
    calls.clear()
    with torch.no_grad():
        model.loss(registry.shard_params(cfg, clone(params), c), batch, c,
                   BASELINE)
    rep[f"fwd_calls/{vname}"] = [[x[0], list(x[1]), list(x[2])]
                                 for x in calls]

# 3) gradients with SP and without
for arch in ("granite-3-2b", "zamba2-2.7b"):
    cfg, model, params, batch = setup(arch, 8, 64)
    specs = dict(tree_leaves_with_paths(model.param_specs()))
    for vname in ("baseline", "nosp"):
        c = apply_rules(sh.ShardCtx(mesh), VARIANTS[vname])
        h = registry.shard_params(cfg, clone(params), c)
        step_mod.make_train_step(cfg, c, adamw.AdamWConfig(lr=1e-3))(
            h, adamw.init_state(h), batch)
        for path, g in tree_leaves_with_paths(seen["g"]):
            s = specs[path]
            res[f"sp/{arch}/{vname}/{path}"] = c.gather(
                g, c.held_spec(g, s.shape, s.axes)).float().numpy()
step_mod.adamw.apply = orig_apply

# 4) serving: prefill and 4 decode steps, teacher-forced
B, S, G = 2, 32, 4
for arch in serve_archs:
    cfg, model, params, batch = setup(arch, B, S)
    ctx = sh.ShardCtx(mesh)
    held = registry.shard_params(cfg, params, ctx)
    recorded = {"one": [], "mesh": []}
    orig_decode = attn.gqa_decode
    for side, p, c in (("one", params, None), ("mesh", held, ctx)):
        def rec(*a, _side=side, **k):
            o = orig_decode(*a, **k)
            recorded[_side].append(o[0].float().numpy())
            return o
        attn.gqa_decode = rec
        with torch.no_grad():
            inp = batch if cfg.family == "encdec" else batch["tokens"]
            lg, cache = model.prefill(p, inp, c, BASELINE)
            cache = pad_cache(cfg, cache, B, S, G)
            res[f"serve/{arch}/{side}/logits0"] = lg.float().numpy()
            toks = (np.asarray(res[f"serve/{arch}/one/tokens"])
                    if side == "mesh" else None)
            out_toks = []
            nxt = torch.argmax(lg[:, :cfg.vocab_size], -1)[:, None]
            for i in range(G - 1):
                if toks is not None:
                    nxt = torch.from_numpy(toks[:, i:i + 1]).long()
                out_toks.append(nxt.numpy())
                before = {k: v.clone() for k, v in
                          tree_leaves_with_paths(cache)}
                lg, cache = model.decode_step(p, cache, nxt, S + i, c,
                                              BASELINE)
                res[f"serve/{arch}/{side}/logits{i + 1}"] = \
                    lg.float().numpy()
                rows = set()
                for k, v in tree_leaves_with_paths(cache):
                    if v.ndim >= 3 and v.shape[2] == S + G and \
                            k.split("/")[-1] in ("k", "v"):
                        ch = (v != before[k]).flatten(3).any(-1)
                        rows |= set(torch.nonzero(ch)[:, 2].tolist())
                rep[f"serve/{arch}/{side}/rows{i}"] = sorted(rows)
                nxt = torch.argmax(lg[:, 0, :cfg.vocab_size], -1)[:, None]
            if side == "one":
                res[f"serve/{arch}/one/tokens"] = np.concatenate(out_toks, 1)
            for k, v in tree_leaves_with_paths(cache):
                if k.split("/")[-1] in ("k", "v"):
                    first_layer = v[0]
                    if side == "mesh":
                        hd = sh.rank_heads(ctx, cfg.n_heads, cfg.n_kv_heads)
                        if hd.nkv < cfg.n_kv_heads:
                            first_layer = ctx.all_gather(
                                first_layer.contiguous(), "model", 2)
                    res[f"serve/{arch}/{side}/cache/{k}"] = \
                        first_layer.float().numpy()
                elif k.split("/")[-1] in SSM_CACHE:
                    # the first Mamba layer's (a hybrid's: its first
                    # site's), the rank's heads / inner dims gathered
                    first_layer = v[0][0] if k.startswith("ssm/") else v[0]
                    key = f"serve/{arch}/{side}/ssm_cache/{k}"
                    if side == "mesh":
                        d = SSM_CACHE[k.split("/")[-1]]
                        if d is not None and first_layer.shape[d] != res[key.replace(
                                "/mesh/", "/one/")].shape[d]:
                            first_layer = ctx.all_gather(
                                first_layer.contiguous(), "model", d)
                    res[key] = first_layer.float().numpy()
    attn.gqa_decode = orig_decode
    for side in ("one", "mesh"):
        res[f"serve/{arch}/attn_{side}"] = np.array(recorded[side],
                                                    np.float32)

if rank == 0:
    np.savez(f"{out}/res.npz", **res)
with open(f"{out}/rep{rank}.json", "w") as f:
    json.dump(rep, f)
"""


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    for k in ("XLA_FLAGS", CPU_DEVICES_ENV) + ENV_ALL:
        env.pop(k, None)
    return env


class _Sink(list):
    def write(self, s):
        self.append(s)

    def flush(self):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    sink = _Sink()
    rc = dist.launch_local([sys.executable, "-c", WORKER % (SERVE,),
                            str(out)], processes=2, env=_env(), timeout=600,
                           stream_to=sink, device="cpu")
    assert rc == 0, "".join(sink)[-4000:]
    return {"res": dict(np.load(out / "res.npz")),
            "rep": [json.loads((out / f"rep{r}.json").read_text())
                    for r in range(2)]}


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_a_rank_does_half_the_matmul_flops(runs):
    """granite-3-2b reduced, loss forward and backward (remat full): a
    rank's matmul FLOPs at most 0.6 of one device's on the whole batch."""
    for rep in runs["rep"]:
        ratio = rep["flops/mesh"] / rep["flops/one"]
        assert ratio <= FLOPS_RATIO, ratio


@pytest.mark.parametrize("vname", ["baseline", "nosp"])
def test_no_split_leaf_is_gathered_over_model(runs, vname):
    """In a train step every all-gather over ``model`` is of a residual-
    stream block (B, S / 2, D), along the sequence, and none of a
    parameter; without sequence parallelism there is none."""
    rep = runs["rep"][0]
    blocks = {tuple(b) for b in rep["blocks"]}
    gathers = [c for c in rep[f"step_calls/{vname}"]
               if c[2] == "all_gather" and c[0] == ["model"]]
    assert all(tuple(c[1]) not in blocks for c in gathers)
    if vname == "nosp":
        assert gathers == []
    else:
        assert gathers and all(c[1] == [8, 32, 128] for c in gathers)


@pytest.mark.parametrize("vname", ["baseline", "nosp"])
def test_one_reduction_per_attention_and_mlp(runs, vname):
    """The forward (granite reduced, 2 layers) issues 2 L + 1 reductions
    over ``model`` of the residual stream: one per attention, one per MLP
    and the embedding's; reduce-scatters to the rank's sequence block with
    sequence parallelism, all-reduces of the whole stream without."""
    calls = runs["rep"][0][f"fwd_calls/{vname}"]
    red = [c for c in calls if c[0] in ("all_reduce", "reduce_scatter")
           and c[1] == ["model"] and c[2][-1] == 128]
    want = "reduce_scatter" if vname == "baseline" else "all_reduce"
    assert [c[0] for c in red] == [want] * 5, red
    assert all(c[2] == [8, 64, 128] for c in red)


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b"])
def test_sequence_parallel_does_not_move_the_gradients(runs, arch):
    res = runs["res"]
    pre = f"sp/{arch}/baseline/"
    paths = [k[len(pre):] for k in res if k.startswith(pre)]
    assert paths
    for p in paths:
        got, want = res[f"sp/{arch}/nosp/{p}"], res[pre + p]
        assert rel_rms(got, want) <= SP_TOL, p


@pytest.mark.parametrize("arch", SERVE)
def test_serving_through_the_splits_matches_one_device(runs, arch):
    res, rep = runs["res"], runs["rep"]
    pre = f"serve/{arch}"
    for i in range(4):
        assert rel_rms(res[f"{pre}/mesh/logits{i}"],
                       res[f"{pre}/one/logits{i}"]) <= LOGITS_RMS_TOL, i
    one, mesh = res[f"{pre}/attn_one"], res[f"{pre}/attn_mesh"]
    assert one.shape == mesh.shape
    if one.size:
        assert float(np.abs(one - mesh).max()) < ATTN_TOL
    caches = [k[len(pre) + 11:] for k in res
              if k.startswith(f"{pre}/one/cache/")]
    assert bool(caches) == (arch != "mamba2-2.7b")
    for k in caches:
        assert np.array_equal(res[f"{pre}/mesh/cache/{k}"],
                              res[f"{pre}/one/cache/{k}"]), k
    ssm = [k[len(pre) + 15:] for k in res
           if k.startswith(f"{pre}/one/ssm_cache/")]
    assert bool(ssm) == (arch in ("zamba2-2.7b", "mamba2-2.7b"))
    for k in ssm:
        got, want = res[f"{pre}/mesh/ssm_cache/{k}"], \
            res[f"{pre}/one/ssm_cache/{k}"]
        if k.endswith("state"):
            assert rel_rms(got, want) <= STATE_RMS_TOL, k
        else:
            assert np.array_equal(got, want), k
    for r in rep:
        for i in range(3):
            want = [32 + i] if caches else []
            assert r[f"{pre}/mesh/rows{i}"] == r[f"{pre}/one/rows{i}"] \
                == want, i
