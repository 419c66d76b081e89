"""The ``act_seq`` fallback of the attention (``sharding.Heads.seq``) on the
CPU: where the query heads do not divide the ``model`` axis and the
sequence does, each rank computes every head for its block of the queries
against the keys up to its block's end, as the reference's
``_constrain_qkv`` shards the attention's sequence instead of its heads.

Held here, on reduced granite-3-2b with 6 query and 2 KV heads (neither
divides 4) on the mesh (1, 1, 4):

- ``plain_flash`` and ``chunked_attention`` with a query offset against
  the reference's ``_kv_scan_attention`` with the offset positions
  (float32 within 1e-5; the offset 0 bit for bit the launch without one),
  and ``ops.flops`` with an offset: the sum over the blocks of a sequence
  is the whole causal attention's;
- the rank's share (``rank_heads`` with the sequence) against the
  reference's resolution: ``act_heads`` falls back, ``act_seq`` resolves;
- prefill in one gloo launch of 4 processes, plain and kernel routes
  (the kernel's plain version on the CPU), against the port's one device
  (logits within ``test_torch_tp.py``'s 0.15 relative RMS, the first
  layer's cache bit for bit) and against the reference's SPMD prefill on 4
  forced host devices (the same bounds); with ``nosp`` (no sequence
  parallelism) the attention stays whole on every rank, as the
  reference's constraint resolves to replicated there;
- the attention's FLOPs (``FlopCounterMode`` over ``gqa_attention``): the
  projections summed over the ranks equal one device's, the causal
  products are at most one device's (the replicated attention of before
  did 4x), the last rank's at most (2n - 1) / n**2 of one device's; with
  ``nosp`` every rank does one device's;
- training: the loss and every gradient leaf through
  ``tests/_train_mesh.py``'s ``hold_case`` (2e-2) against the reference's
  SPMD step.

Measured on the CPU: the mesh's prefill logits 0.0 relative RMS from one
device on the plain route, 1.7e-3 on the kernel route (float32 sums over
the keys of the block in another order), 5.8e-3 / 7.9e-3 from the
reference's SPMD prefill, the cache within 9.5e-7 of the reference's; the
ranks' causal products 0.0625, 0.125, 0.1875 and 0.25 of one device's
(0.625 together: at S = 64 one device's masked block is the whole
square), the attention's output rows bit for bit one device's.
"""
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

import repro.models.common as j_common
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.distributed.sharding import ShardCtx as JShardCtx
from repro.kernels.flash_attention import ref as j_ref
from repro.models import attention as j_attn
from repro.models.registry import build as j_build
from repro_torch.bench import distributed as dist
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn

import _train_mesh as tm

ARCH = "granite-3-2b+h6kv2"
OVERRIDE = tm.OVERRIDES["h6kv2"]
MESH = (1, 1, 4)
B, S = 2, 64
LOGITS_RMS_TOL = 0.15
ATTN_TOL = 1e-5


def _cfg():
    return replace(reduced(get_arch("granite-3-2b")), **OVERRIDE)


# ---------------------------------------------------------------------------
# the offset attention, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q0,Sq,Sk", [(0, 32, 32), (16, 16, 32),
                                      (48, 16, 64), (40, 24, 64),
                                      (16, 24, 64)])
def test_offset_attention_matches_the_reference(q0, Sq, Sk):
    """A block of queries at positions q0 .. q0 + Sq - 1 against keys 0 ..
    Sk - 1 under the causal mask: ``plain_flash`` / ``flash_attention``
    (its plain version here) against those rows of the reference's oracle
    (``kernels/flash_attention/ref.reference``) over the whole sequence up
    to the block's end, and ``chunked_attention`` with ``q_offset`` (bf16
    products, as the reference's) against the reference's
    ``_kv_scan_attention`` with those positions."""
    rng = np.random.default_rng(q0 + Sq + Sk)
    H, KV, D = 6, 2, 32
    end = q0 + Sq
    qf = rng.standard_normal((2, max(end, Sk), H, D)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, D)).astype(np.float32)
    q = qf[:, q0:end]
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in (q, k, v))
    if end == Sk:       # the rank's case: the keys cut at the block's end
        oracle = np.asarray(j_ref.reference(qf[:, :Sk], k, v))[:, q0:]
        for name, o in (("plain_flash", fa.plain_flash(tq, tk, tv,
                                                       q_offset=q0)),
                        ("flash_attention", fa.flash_attention(
                            tq, tk, tv, q_offset=q0))):
            err = float(np.abs(o.numpy() - oracle).max())
            assert err <= ATTN_TOL, (name, err)
    want = np.asarray(j_attn._kv_scan_attention(
        q, k, v, causal=True, kv_block=16,
        q_positions=jax.numpy.arange(Sq) + q0))
    got = {
        "chunked": attn.chunked_attention(tq, tk, tv, causal=True,
                                          kv_block=16, q_offset=q0),
        "chunked_q_block": attn.chunked_attention(
            tq, tk, tv, causal=True, kv_block=16, q_block=8, q_offset=q0),
        "chunked_positions": attn.chunked_attention(
            tq, tk, tv, causal=True, kv_block=16,
            q_positions=torch.arange(Sq) + q0),
    }
    for name, o in got.items():
        err = float(np.abs(o.numpy() - want).max())
        assert err <= ATTN_TOL, (name, err)
    if q0 == 0:
        assert torch.equal(fa.plain_flash(tq, tk, tv, q_offset=0),
                           fa.plain_flash(tq, tk, tv))


def test_offset_needs_a_causal_mask():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, q, q, causal=False, q_offset=8)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, q, q, q_offset=-1)


@pytest.mark.parametrize("n", [1, 4, 16])
def test_offset_flops_sum_to_the_whole(n):
    """``ops.flops`` with the offset: the blocks of a sequence of 4096 split
    n ways sum to the whole causal attention's useful FLOPs; rank r does
    (2r + 1) / n**2 of it."""
    H, D, Sq = 40, 128, 4096 // n
    whole = fa_ops.flops(torch.empty(1, 4096, H, D, device="meta"),
                         torch.empty(1, 4096, 10, D, device="meta"), True)
    parts = [fa_ops.flops(torch.empty(1, Sq, H, D, device="meta"),
                          torch.empty(1, Sq * (r + 1), 10, D, device="meta"),
                          True, q_offset=r * Sq) for r in range(n)]
    assert sum(parts) == whole
    for r, f in enumerate(parts):
        assert f == pytest.approx(whole * (2 * r + 1) / n ** 2, rel=1e-12)


@pytest.mark.parametrize("variant", ["masked", "folded"])
@pytest.mark.parametrize("q0", [0, 32, 96])
def test_a_query_block_against_keys_cut_at_its_end(variant, q0):
    """A rank's 32 query rows at ``q_offset`` q0 against the keys cut at
    the block's end, as ``Heads.seq`` attends them, in KV blocks of 16:
    the same bits as those rows of the whole sequence's attention
    (``masked`` visits every key block up to the end; ``folded`` only
    those up to each query block's, its query blocks 16 rows)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 128, 4, 32, generator=g)
    k = torch.randn(1, 128, 2, 32, generator=g)
    v = torch.randn(1, 128, 2, 32, generator=g)
    whole = attn.chunked_attention(q, k, v, causal=True, kv_block=16,
                                   q_block=16)
    qb, kb, vb = q[:, q0:q0 + 32], k[:, :q0 + 32], v[:, :q0 + 32]
    if variant == "folded":
        block = attn.folded_causal_attention(qb, kb, vb, q_block=16,
                                             kv_block=16, q_offset=q0)
    else:
        block = attn.chunked_attention(qb, kb, vb, causal=True, kv_block=16,
                                       q_offset=q0)
    assert torch.equal(block, whole[:, q0:q0 + 32])


@pytest.mark.parametrize("m,rank", [(4, 0), (4, 3), (16, 5)])
def test_sequence_mode_resolves_as_the_reference(m, rank):
    """The 6-head config over 4 and phi3's 40 heads over 16: ``act_heads``
    falls back, ``act_seq`` resolves for the sequence (the reference's
    ``_constrain_qkv`` then shards q, k and v over ``act_seq``), and the
    rank takes every head of its block of the sequence; without a
    sequence (decode, or ``nosp``) every head of the whole."""
    cfg = _cfg() if m == 4 else get_arch("phi3-medium-14b")
    seq = 4096 if m == 16 else S
    names = ("pod", "data", "model")
    t = sh.ShardCtx(sh.AbstractMesh((1, 1, m), names))
    j = JShardCtx(JAbstractMesh((1, 1, m), names))
    assert j.resolve_dim("act_heads", cfg.n_heads) is None
    assert j.resolve_dim("act_seq", seq) == ("model",)
    h = sh.rank_heads(t, cfg.n_heads, cfg.n_kv_heads, rank, seq_len=seq)
    assert (h.q0, h.nq, h.kv0, h.nkv, h.split) == \
        (0, cfg.n_heads, 0, cfg.n_kv_heads, False)
    assert h.seq and (h.q0_seq, h.nq_seq) == (rank * seq // m, seq // m)
    whole = sh.rank_heads(t, cfg.n_heads, cfg.n_kv_heads, rank)
    assert not whole.seq and whole.nq == cfg.n_heads
    assert set(t.fallbacks) == set(j.fallbacks)


# ---------------------------------------------------------------------------
# four gloo ranks on (1, 1, 4) against one device and the reference
# ---------------------------------------------------------------------------

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from dataclasses import replace
from repro.configs import get_arch, reduced
from repro.distributed.sharding import ShardCtx
from repro.launch.mesh import make_mesh
from repro.models.common import abstract_params, logical_axes
from repro.models.registry import build
from repro.models.variant import BASELINE
from repro.train.step import make_prefill_step

out = sys.argv[1]
inp = np.load(f"{out}/inputs.npz")
cfg = replace(reduced(get_arch("granite-3-2b")), **%r)
model = build(cfg)
specs = model.param_specs()


def unflat(like, prefix=""):
    if isinstance(like, dict):
        return {k: unflat(v, f"{prefix}{k}/") for k, v in like.items()}
    return jnp.asarray(inp["p/" + prefix[:-1]])


mesh = make_mesh((1, 1, 4), ("pod", "data", "model"))
ctx = ShardCtx(mesh)
params = jax.device_put(unflat(specs), ctx.tree_shardings(
    abstract_params(specs), logical_axes(specs)))
batch = {"tokens": jnp.asarray(inp["tokens"])}
res = {}
with jax.set_mesh(mesh):
    logits, cache = jax.jit(make_prefill_step(cfg, ctx, BASELINE)).lower(
        params, batch).compile(compiler_options={
            "xla_allow_excess_precision": False})(params, batch)
res["logits"] = np.asarray(logits, np.float32)
for k in ("k", "v"):
    res[f"cache/{k}"] = np.asarray(cache[k][0], np.float32)
np.savez(f"{out}/ref.npz", **res)
print("REF_OK")
"""

WORKER = r"""
import json, sys
from dataclasses import replace
import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.bench import distributed as dist
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_reference
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as attn
from repro_torch.models import registry
from repro_torch.models.common import tree_index
from repro_torch.models.variant import BASELINE, VARIANTS, apply_rules

out = sys.argv[1]
dist.ensure_initialized("cpu")
rank = dist.process_index()
mesh = make_mesh((1, 1, 4), ("pod", "data", "model"), device="cpu")
inp = np.load(f"{out}/inputs.npz")
cfg = replace(reduced(get_arch("granite-3-2b")), **%r)
model = registry.build(cfg)
specs = model.param_specs()


def unflat(like, prefix=""):
    if isinstance(like, dict):
        return {k: unflat(v, f"{prefix}{k}/") for k, v in like.items()}
    return inp["p/" + prefix[:-1]]


params = params_from_reference(unflat(specs))
tokens = torch.from_numpy(inp["tokens"]).long()
res, rep = {}, {}
for vname in ("baseline", "nosp"):
    for route in ("plain", "kernel"):
        v = replace(VARIANTS[vname], use_pallas=route == "kernel")
        tag = f"{vname}/{route}"
        with torch.no_grad():
            if rank == 0 and vname == "baseline":
                lg, cache = model.prefill(params, tokens, None, v)
                res[f"one/{route}/logits"] = lg.float().numpy()
                for k in ("k", "v"):
                    res[f"one/{route}/cache/{k}"] = cache[k][0].float().numpy()
            ctx = apply_rules(sh.ShardCtx(mesh), v)
            held = registry.shard_params(cfg, params, ctx)
            lg, cache = model.prefill(held, tokens, ctx, v)
        res[f"{tag}/logits"] = lg.float().numpy()
        for k in ("k", "v"):
            res[f"{tag}/cache/{k}"] = cache[k][0].float().numpy()
        rep[f"{tag}/fallbacks"] = sorted(set(ctx.fallbacks))

# the first layer's attention forward, FLOPs by op: the rank's and one
# device's on the whole sequence
# (the heads do not divide 4: the layer's leaves are whole over model)
layer = tree_index(params["blocks"], 0)["attn"]
x = torch.randn(tokens.shape[0], tokens.shape[1], cfg.d_model,
                generator=torch.Generator().manual_seed(7)).to(torch.bfloat16)
for vname in ("baseline", "nosp"):
    ctx = apply_rules(sh.ShardCtx(mesh), VARIANTS[vname])
    tp = sh.tp_plan(ctx, x.shape[1])
    xs = tp.scatter_seq(x).contiguous()   # a reduce-scatter's block
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        o = attn.gqa_attention(cfg, layer, xs, tp=tp)
    rep[f"{vname}/flops"] = {str(k): int(n) for k, n in
                             fc.get_flop_counts()["Global"].items()}
    rep[f"{vname}/heads_seq"] = tp.heads(cfg.n_heads, cfg.n_kv_heads,
                                         split_seq=True).seq
    rep[f"{vname}/out_shape"] = list(o.shape)
    res[f"{vname}/attn_out"] = ctx.all_gather(o.contiguous(), "model",
                                              1).float().numpy() \
        if tp.seq else o.float().numpy()
with torch.no_grad(), FlopCounterMode(display=False) as fc:
    o = attn.gqa_attention(cfg, layer, x)
rep["one/flops"] = {str(k): int(n) for k, n in
                    fc.get_flop_counts()["Global"].items()}
res["one/attn_out"] = o.float().numpy()
if rank == 0:
    np.savez(f"{out}/port.npz", **res)
with open(f"{out}/rep{rank}.json", "w") as f:
    json.dump(rep, f)
"""


def _inputs(path: Path) -> None:
    jcfg = replace(j_reduced(j_get_arch("granite-3-2b")), **OVERRIDE)
    p = j_common.init_params(j_build(jcfg).param_specs(), jax.random.key(0))
    arrays = {}
    for keys, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        arrays["p/" + "/".join(k.key for k in keys)] = np.asarray(
            leaf, np.float32)
    rng = np.random.default_rng(1)
    arrays["tokens"] = rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("act_seq")
    _inputs(out / "inputs.npz")
    r = subprocess.run([sys.executable, "-c", REF % (OVERRIDE,), str(out)],
                       capture_output=True, text=True, env=tm.env(),
                       timeout=600)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-3000:]
    sink = tm._Sink()
    rc = dist.launch_local([sys.executable, "-c", WORKER % (OVERRIDE,),
                            str(out)], processes=4, env=tm.env(),
                           timeout=600, stream_to=sink, device="cpu")
    assert rc == 0, sink.text()[-4000:]
    return {"ref": dict(np.load(out / "ref.npz")),
            "port": dict(np.load(out / "port.npz")),
            "rep": [json.loads((out / f"rep{i}.json").read_text())
                    for i in range(4)]}


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("vname", ["baseline", "nosp"])
def test_prefill_matches_one_device_and_the_reference(runs, vname, route):
    """The mesh's logits within 0.15 relative RMS of the port's one device
    and of the reference's SPMD prefill (plain route), the first layer's
    cache bit for bit against one device's (the whole sequence's every KV
    head: ``kv_heads`` falls back to whole) and within one bf16 step of
    the reference's."""
    port, ref = runs["port"], runs["ref"]
    pre = f"{vname}/{route}"
    assert tm.rel_rms(port[f"{pre}/logits"],
                      port[f"one/{route}/logits"]) <= LOGITS_RMS_TOL
    assert tm.rel_rms(port[f"{pre}/logits"], ref["logits"]) <= \
        LOGITS_RMS_TOL
    for k in ("k", "v"):
        got = port[f"{pre}/cache/{k}"]
        assert np.array_equal(got, port[f"one/{route}/cache/{k}"]), k
        assert np.allclose(got, ref[f"cache/{k}"], rtol=2 ** -7, atol=1e-6), k


def test_the_fallback_is_recorded_as_the_reference_records_it(runs):
    for r in runs["rep"]:
        for route in ("plain", "kernel"):
            assert "act_heads(6) !% ('model',)(4)" in \
                r[f"baseline/{route}/fallbacks"]


def test_attention_flops_split_over_the_sequence(runs):
    """With sequence parallelism every rank computes every head of its
    quarter of the queries: the projections (``mm``) sum to one device's,
    the causal products (``bmm``) to at most one device's, the last
    rank's to at most (2n - 1) / n**2 of it; its output block is the
    one-device attention's rows.  Without (``nosp``) each rank computes
    one device's attention whole, as before."""
    reps, n = runs["rep"], 4
    one = reps[0]["one/flops"]
    mm = sum(r["baseline/flops"]["aten.mm"] for r in reps)
    bmm = [r["baseline/flops"]["aten.bmm"] for r in reps]
    assert all(r["baseline/heads_seq"] for r in reps)
    assert mm == one["aten.mm"]
    assert sum(bmm) <= one["aten.bmm"]
    assert bmm[-1] <= (2 * n - 1) / n ** 2 * one["aten.bmm"]
    assert bmm == sorted(bmm)
    for r in reps:
        assert not r["nosp/heads_seq"]
        assert r["nosp/flops"] == one
        assert r["baseline/out_shape"] == [B, S // n, _cfg().d_model]
    port = runs["port"]
    for vname in ("baseline", "nosp"):
        assert tm.rel_rms(port[f"{vname}/attn_out"],
                          port["one/attn_out"]) <= 1e-2, vname


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    return tm.run_cases(tmp_path_factory.mktemp("act_seq_train"),
                        [(ARCH, MESH)])


def test_training_holds_to_the_reference(train_runs):
    """The loss and every gradient leaf of a train step on (1, 1, 4), the
    attention split over the sequence, against the reference's SPMD step
    (``hold_case``: 2e-2)."""
    tm.hold_case(train_runs, ARCH, MESH)
