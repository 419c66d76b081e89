"""Sequence-sharded decode attention: flash-decode with a log-sum-exp
combine (counterpart of ``repro.serve.flash_decode``).

For ``long_500k`` (batch 1, a 524k-token KV cache) the batch cannot shard,
so the KV cache shards over the ``data`` axis on its *sequence* dim, and its
KV heads over ``model`` where they divide (``cache_spec``).  Each rank holds
its block of the cache, computes partial attention over it and a local
max, numerator and denominator; the numerically stable combine is an
all-reduce MAX of the maxima, then one all-reduce SUM of the rescaled
(numerator, denominator) pairs over the ``data`` group.  Over ``model``
the decode is tensor parallel: the rank projects its query and KV heads
from its ``wq`` / ``wk`` / ``wv`` blocks (``sharding.rank_heads``; the
hybrid gathers the shared block's leaves over the fsdp axes only, and a
whole leaf is cut to the rank's block here), and its ``wo`` block gives a
partial output that one all-reduce over ``model`` sums.  At batch 1 the
activations are whole on every rank (the batch does not divide over the
data axes).

The one new (k, v) entry is written, in place, only into the block that
owns position ``pos``; on every other rank the cache does not change
(the reference masks a dynamic-update-slice and returns new arrays).  The
arithmetic is the reference's: bf16 scores and values with float32 sums,
masked scores at -1e30, the probabilities rounded to bf16 for the value
product.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import tp_plan
from repro_torch.models.attention import (gqa_project_qkv, out_proj,
                                          rope_freqs)
from repro_torch.models.common import cast_compute
from repro_torch.models.ssm import keep_model, ssm_dims

SEQ_AXIS = "data"


def _split(ctx, cfg) -> tuple[int, int]:
    """(sequence shards over ``data``, head shards over ``model``)."""
    names = ctx.mesh.axis_names
    n_seq = ctx.mesh.shape[SEQ_AXIS] if SEQ_AXIS in names else 1
    tp = ctx.tp_axis
    tp_n = ctx.mesh.shape[tp] if tp else 1
    tp_ok = cfg.n_kv_heads % tp_n == 0 and cfg.n_heads % tp_n == 0
    return n_seq, tp_n if tp_ok else 1


def cache_spec(ctx, cfg) -> tuple:
    """The layout a (B, S, KV, hd) cache is held in: seq over ``data``,
    KV heads over ``model`` when the heads divide (the reference's
    ``kv_spec``)."""
    n_seq, tp_n = _split(ctx, cfg)
    spec = (None, SEQ_AXIS if n_seq > 1 else None,
            ctx.tp_axis if tp_n > 1 else None)
    return spec[:max((i + 1 for i, e in enumerate(spec) if e), default=0)]


def shard_ssm(ctx, cfg, ssm: dict) -> dict:
    """A hybrid's SSM caches (sites, group, B, ...), whole, cut to this
    rank's SSD heads (``state``) and inner dims (``conv_x``) where
    ``model`` splits them (``conv_B`` / ``conv_C`` stay whole); copies."""
    tp = tp_plan(ctx, 1)
    out = {k: v.clone() for k, v in ssm.items()}
    if tp.n > 1 and keep_model(cfg, tp):
        d_in, H = ssm_dims(cfg)
        h0, nh = tp.block("heads", H)
        i0, ni = tp.block("inner", d_in)
        out["state"] = ssm["state"].narrow(3, h0, nh).clone()
        out["conv_x"] = ssm["conv_x"].narrow(4, i0, ni).clone()
    return out


def shard_cache(ctx, cfg, cache: dict) -> dict:
    """A hybrid cache, whole on every rank, cut to this rank's blocks: the
    per-site k/v to ``cache_spec``'s, the SSM caches by ``shard_ssm``."""
    spec = (None,) + cache_spec(ctx, cfg)
    return dict(cache, k=ctx.shard(cache["k"], spec),
                v=ctx.shard(cache["v"], spec),
                ssm=shard_ssm(ctx, cfg, cache["ssm"]))


def _rank_params(heads, p: dict) -> dict:
    """``p``'s wq / wk / wv / wo as the rank's blocks of heads: a whole
    leaf cut to them, a block as it is."""
    out = dict(p)
    for name, dim, lo, n, whole in (
            ("wq", 1, heads.q0, heads.nq, heads.n_heads),
            ("wk", 1, heads.kv0, heads.nkv, heads.n_kv),
            ("wv", 1, heads.kv0, heads.nkv, heads.n_kv),
            ("wo", 0, heads.q0, heads.nq, heads.n_heads)):
        if n < whole and p[name].shape[dim] == whole:
            out[name] = p[name].narrow(dim, lo, n)
    return out


def seq_sharded_gqa_decode(ctx, cfg, p, x, cache_k, cache_v, pos: int):
    """x: (B, 1, D), whole; p: the attention's leaves, whole or the rank's
    ``model`` blocks; cache_(k|v): this rank's (B, S/n_seq, KV/tp, hd)
    block under ``cache_spec``; pos: int.

    Returns (out (B, 1, D), cache_k, cache_v), the cache blocks updated in
    place."""
    n_seq, _ = _split(ctx, cfg)
    tp = tp_plan(ctx, 1)
    heads = tp.heads(cfg.n_heads, cfg.n_kv_heads)
    B, S_local, KV_local, hd = cache_k.shape
    if KV_local != heads.nkv:
        raise ValueError(f"cache block of {KV_local} KV heads; this mesh "
                         f"holds {heads.nkv} a rank")

    inv_freq = rope_freqs(hd, cfg.rope_pct, cfg.rope_theta, device=x.device)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    p = _rank_params(heads, p)
    q, k_new, v_new = gqa_project_qkv(cfg, p, x, positions, inv_freq)

    start = (ctx.coord((SEQ_AXIS,)) if n_seq > 1 else 0) * S_local
    rel = pos - start
    if 0 <= rel < S_local:          # only the owner of pos writes
        cache_k[:, rel] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, rel] = v_new[:, 0].to(cache_v.dtype)

    ck, cv = heads.for_attention(cache_k, cache_v)
    KVa = ck.shape[2]
    G = heads.nq // KVa
    qh = cast_compute(q).to(torch.float32).reshape(B, KVa, G, hd)
    s = torch.einsum("bkgd,bjkd->bkgj", qh,
                     cast_compute(ck).to(torch.float32))
    s = s / torch.sqrt(torch.tensor(hd, dtype=torch.float32,
                                    device=x.device))
    valid = torch.arange(S_local, device=x.device) + start <= pos
    s = torch.where(valid[None, None, None, :], s,
                    torch.full((), -1e30, device=x.device))
    m = torch.amax(s, dim=-1)                                  # local max
    e = torch.exp(s - m[..., None])
    num = torch.einsum("bkgj,bjkd->bkgd",
                       e.to(torch.bfloat16).to(torch.float32),
                       cast_compute(cv).to(torch.float32))
    den = torch.sum(e, dim=-1)                                 # (B, KV, G)
    if n_seq > 1:
        gmax = ctx.all_reduce(m.clone(), (SEQ_AXIS,), "max")
        scale = torch.exp(m - gmax)
        pair = torch.cat([num * scale[..., None], (den * scale)[..., None]],
                         dim=-1)
        pair = ctx.all_reduce(pair, (SEQ_AXIS,))
        num, den = pair[..., :hd], pair[..., hd]
    o = (num / torch.clamp_min(den, 1e-30)[..., None]).to(q.dtype)
    return (out_proj(o.reshape(B, 1, heads.nq, hd), p["wo"], tp,
                     heads.split, x.dtype), cache_k, cache_v)
