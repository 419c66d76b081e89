"""Attention: GQA with (partial) RoPE, chunked online-softmax attention, the
folded causal variant, the training attention and the decode step
(counterpart of ``repro.models.attention``).

``chunked_attention`` is the port of the reference's default path (its XLA
form, blocked over queries and keys with an online softmax); training runs
it (``gqa_attention``), with each KV block's body a checkpoint under
autograd, so that the backward pass recomputes the block's scores and
probabilities instead of keeping them (the reference's ``@jax.checkpoint``
body: the flash-attention backward).  The prefill's kernel route
(``Variant.use_pallas``) goes to ``repro_torch.kernels.flash_attention``
instead.  Layouts are the reference's: q ``(B, S, H, Dh)``, k/v ``(B, S,
KV, Dh)``.  On a mesh the layer functions take a ``sharding.TP`` plan
and the layer's parameters as the rank's ``model`` blocks
(``gather_tree(..., keep=("model",))``): ``wq`` / ``wk`` / ``wv`` column
blocks give the rank's heads (``sharding.rank_heads``), the attention runs
on them, and ``wo``'s row block gives a partial sum that ``TP.reduce``
sums over ``model``, the reference's ``_constrain_qkv`` /
``_constrain_attn_out``.  Where ``act_heads`` does not resolve and the
residual stream is split over ``act_seq`` (``Heads.seq``), the reference's
constraint shards the attention's sequence instead: the rank projects q,
k and v of its own block of the sequence (positions offset by the
block's start), all-gathers k and v over ``model``, attends its query
rows to the keys up to its block's end under the causal mask
(``q_offset``) and projects the output of its block, with no reduction
(``gqa_attention``, ``gqa_prefill``); the ``masked`` variant visits every
key block up to that end, the ``folded`` one only those up to each query
block's.  ``ctx`` is not read here; the
sequence-sharded decode is ``serve.flash_decode``.  ``unroll`` (its
scans' unrolling) is accepted and ignored.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import NO_TP, TP_AXIS
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import ParamSpec, cast_compute, rms_norm

# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rope_pct: float, theta: float, device=None):
    rot = int(head_dim * rope_pct) // 2 * 2
    if rot == 0:
        return None
    exponent = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponent)  # (rot/2,)


def apply_rope(x, positions, inv_freq):
    """x: (B, S, H, Dh); positions: (B, S) or (S,). Rotates the first rot dims
    (interleaved pairs ``x[..., ::2]``, ``x[..., 1::2]``)."""
    if inv_freq is None:
        return x
    rot = inv_freq.shape[0] * 2
    xf = x.to(torch.float32)
    x_rot, x_pass = xf[..., :rot], xf[..., rot:]
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * inv_freq[None, None, :]  # (B,S,r/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    x_rot = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([x_rot, x_pass], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (the reference's default path)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool, kv_block: int = 1024,
                      q_block: int = 1024, q_positions=None, kv_positions=None,
                      ctx=None, unroll: bool = False, q_offset: int = 0):
    """q: (B, Sq, H, Dh); k/v: (B, Sk, KV, Dh|Dv).  GQA by head grouping (no
    materialised repeat).  Returns (B, Sq, H, Dv).  Online softmax, blocked
    over queries and keys: temporaries are O(q_block * kv_block) per head.
    ``q_offset``: with the default positions, the queries are positions
    ``q_offset .. q_offset + Sq - 1`` of the keys' sequence (a rank's
    block of it)."""
    B, Sq, H, Dh = q.shape
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device) + q_offset
    if Sq > q_block and Sq % q_block == 0:
        outs = [_kv_scan_attention(q[:, i:i + q_block], k, v, causal=causal,
                                   kv_block=kv_block,
                                   q_positions=q_positions[i:i + q_block],
                                   kv_positions=kv_positions)
                for i in range(0, Sq, q_block)]
        return torch.cat(outs, dim=1)
    return _kv_scan_attention(q, k, v, causal=causal, kv_block=kv_block,
                              q_positions=q_positions, kv_positions=kv_positions)


def _kv_block(causal, scale, qc, k_b, v_b, kpos_b, kval_b, q_positions,
              m, l, acc):
    """One KV block of the online softmax: (m, l, acc) after the block."""
    k_b = cast_compute(k_b).to(torch.float32)
    v_b = cast_compute(v_b)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qc, k_b) * scale  # (B,KV,G,Sq,kb)
    mask = kval_b[None, None, None, None, :]
    if causal:
        mask = mask & (q_positions[None, None, None, :, None]
                       >= kpos_b[None, None, None, None, :])
    # -1e30, not -inf: a fully-masked block would make m == -inf and
    # exp(-inf - -inf) == nan in the online-softmax update.
    s = torch.where(mask, s, torch.tensor(-1e30, device=s.device))
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    # the probabilities are rounded to the value dtype (bf16), as the
    # reference's einsum takes them
    pv = torch.einsum("bkgqj,bjkd->bkgqd", p.to(v_b.dtype).to(torch.float32),
                      v_b.to(torch.float32))
    return m_new, l_new, acc * corr[..., None] + pv


def _kv_scan_attention(q, k, v, *, causal: bool, kv_block: int,
                       q_positions, kv_positions=None):
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    Dv = v.shape[-1]
    G = H // KV  # query heads per kv head
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32, device=dev))
    kv_block = min(kv_block, Sk)

    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Sk, device=dev)

    # pad KV to a block multiple; padded slots masked out via kv_valid
    pad = (-Sk) % kv_block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad))
    kv_valid = torch.arange(Sk + pad, device=dev) < Sk
    Sk = Sk + pad

    # bf16 operands, products and sums in f32 (preferred_element_type=f32)
    qc = cast_compute(q).to(torch.float32).reshape(B, Sq, KV, G, Dh)
    m = torch.full((B, KV, G, Sq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, Dv), dtype=torch.float32, device=dev)
    # under autograd each block is a checkpoint: the backward pass
    # recomputes its (q, kb) scores and probabilities from the block's
    # inputs instead of keeping them (O(Sq * Sk) f32 otherwise)
    remat = torch.is_grad_enabled()
    for j0 in range(0, Sk, kv_block):
        blk = (qc, k[:, j0:j0 + kv_block], v[:, j0:j0 + kv_block],
               kv_positions[j0:j0 + kv_block], kv_valid[j0:j0 + kv_block],
               q_positions, m, l, acc)
        if remat:
            m, l, acc = checkpoint(_kv_block, causal, scale, *blk,
                                   use_reentrant=False)
        else:
            m, l, acc = _kv_block(causal, scale, *blk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]            # (B,KV,G,Sq,Dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
    return out.to(q.dtype)


def folded_causal_attention(q, k, v, *, q_block: int = 1024,
                            kv_block: int = 1024, ctx=None,
                            unroll: bool = False, q_offset: int = 0):
    """Causal attention that does ~half the block work of
    ``chunked_attention``: query block i visits KV blocks [0, i] only, a
    static prefix, so nq(nq + 1)/2 block pairs against nq^2.  ``q_offset``
    (a multiple of ``kv_block``): the queries are positions ``q_offset ..
    q_offset + Sq - 1`` of the keys' sequence, and query block i visits
    the KV blocks up to ``q_offset / kv_block + i``."""
    B, S, H, Dh = q.shape
    if S % q_block or q_offset % kv_block or q_block != kv_block:
        raise ValueError(f"folded attention needs S ({S}) and q_offset "
                         f"({q_offset}) multiples of q_block == kv_block "
                         f"({q_block}, {kv_block})")
    nq = S // q_block
    if nq <= 1:
        return chunked_attention(q, k, v, causal=True, kv_block=kv_block,
                                 q_offset=q_offset)
    dev = q.device
    outs = []
    for i in range(nq):
        q0 = q_offset + i * q_block
        kv_len = q0 + q_block
        outs.append(_kv_scan_attention(
            q[:, i * q_block:(i + 1) * q_block], k[:, :kv_len], v[:, :kv_len],
            causal=True, kv_block=kv_block,
            q_positions=torch.arange(q_block, device=dev) + q0,
            kv_positions=torch.arange(kv_len, device=dev)))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# GQA attention layer (params + train/prefill/decode application)
# ---------------------------------------------------------------------------

def gqa_specs(cfg, d: int) -> dict:
    hd = cfg.resolved_head_dim
    out = {
        "wq": ParamSpec((d, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.n_heads, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        out["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    return out


def _proj_heads(xc, w):
    """einsum("bsd,dhk->bshk") as one bf16 matrix product."""
    d, h, k = w.shape
    return (xc @ cast_compute(w).reshape(d, h * k)).reshape(*xc.shape[:-1], h, k)


def out_proj(o, wo, tp=NO_TP, split: bool = False, dtype=torch.bfloat16):
    """einsum("bshk,hkd->bsd", bf16(o), bf16(wo)) as one matrix product, in
    ``dtype``; where ``tp`` ``split``s the heads (``o`` and ``wo`` the
    rank's) a row split summed over ``model`` (``TP.row``)."""
    h, k, d = wo.shape
    return tp.row(cast_compute(o).reshape(*o.shape[:-2], h * k),
                  cast_compute(wo).reshape(h * k, d), split, dtype)


def gqa_project_qkv(cfg, p: dict, x, positions, inv_freq):
    xc = cast_compute(x)
    q = _proj_heads(xc, p["wq"])
    k = _proj_heads(xc, p["wk"])
    v = _proj_heads(xc, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    return q, k, v


def _seq_block_qkv(cfg, p: dict, x, positions, inv_freq, tp, heads):
    """``Heads.seq``: q of the rank's block ``x`` of the sequence at its
    positions, and k / v of the whole sequence up to the block's end (each
    rank's block projected, all-gathered over ``model``, cut there), with
    the whole sequence's k / v (for a cache)."""
    q0, n = heads.q0_seq, heads.nq_seq
    q, k, v = gqa_project_qkv(cfg, p, x, positions[..., q0:q0 + n], inv_freq)
    k = tp.ctx.all_gather(k, TP_AXIS, 1)
    v = tp.ctx.all_gather(v, TP_AXIS, 1)
    return q, k[:, :q0 + n], v[:, :q0 + n], k, v


def gqa_attention(cfg, p: dict, x, *, causal: bool = True, positions=None,
                  kv_block: int = 1024, variant: str = "masked", ctx=None,
                  unroll: bool = False, tp=NO_TP):
    """The training attention, x (B, S, D) -> (B, S, D): the plain route
    (``chunked_attention``, or ``folded_causal_attention`` for
    ``variant="folded"`` where the query rows are a multiple of
    ``kv_block`` above it),
    never the flash kernel, which is forward only.  Under ``tp`` x is the
    residual stream's block and the result is too; the attention runs on
    the rank's heads, or (``Heads.seq``) on every head of the rank's
    query rows."""
    heads = tp.heads(cfg.n_heads, cfg.n_kv_heads, split_seq=causal)
    xs = x if heads.seq else tp.gather_seq(x)
    S = tp.seq_len if heads.seq else xs.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    inv_freq = rope_freqs(cfg.resolved_head_dim, cfg.rope_pct, cfg.rope_theta,
                          device=x.device)
    if heads.seq:
        q, k, v, _, _ = _seq_block_qkv(cfg, p, xs, positions, inv_freq, tp,
                                       heads)
        q_offset, out_tp = heads.q0_seq, NO_TP
    else:
        q, k, v = gqa_project_qkv(cfg, p, xs, positions, inv_freq)
        k, v = heads.for_attention(k, v)
        q_offset, out_tp = 0, tp
    Sq = q.shape[1]
    if causal and variant == "folded" and Sq > kv_block \
            and Sq % kv_block == 0 and q_offset % kv_block == 0:
        o = folded_causal_attention(q, k, v, q_block=kv_block,
                                    kv_block=kv_block, q_offset=q_offset)
    else:
        o = chunked_attention(q, k, v, causal=causal,
                              kv_block=min(kv_block, S), q_offset=q_offset)
    return out_proj(o, p["wo"], out_tp, heads.split, x.dtype)


def gqa_prefill(cfg, p: dict, h, positions, inv_freq, *, tp=NO_TP,
                use_pallas: bool = False, kv_block: int = 1024, dtype=None):
    """The prefill's causal attention of a layer: ``h`` (B, S | S/n, D) the
    normed residual stream (the rank's block under sequence parallelism)
    -> (output on the residual stream's layout, {"k", "v"}: the cache entry
    of the KV heads the rank projects, bf16).  The attention runs on the
    flash kernel where ``use_pallas`` (the reference's meaning), else on
    ``chunked_attention``; on the rank's heads, or (``Heads.seq``) every
    head of the rank's query rows against the keys up to its block's end
    (the kernel's ``q_offset``), the cache then the whole sequence's.
    The output is in ``dtype`` (``h``'s where None)."""
    dtype = dtype or h.dtype
    heads = tp.heads(cfg.n_heads, cfg.n_kv_heads, split_seq=True)
    if heads.seq:
        q, k, v, k_all, v_all = _seq_block_qkv(cfg, p, h, positions,
                                               inv_freq, tp, heads)
        q_offset, S = heads.q0_seq, tp.seq_len
    else:
        h = tp.gather_seq(h)
        q, k, v = gqa_project_qkv(cfg, p, h, positions, inv_freq)
        k_all, v_all = k, v
        k, v = heads.for_attention(k, v)
        q_offset, S = 0, h.shape[1]
    if use_pallas:
        from repro_torch.models.encdec import flash_block
        o = fa_ops.flash(q, k, v, causal=True,
                         q_block=flash_block(q.shape[1]),
                         kv_block=flash_block(k.shape[1]), q_offset=q_offset)
    else:
        o = chunked_attention(q, k, v, causal=True, kv_block=min(kv_block, S),
                              q_offset=q_offset)
    entry = {"k": k_all.to(torch.bfloat16), "v": v_all.to(torch.bfloat16)}
    if heads.seq:
        return out_proj(o, p["wo"], NO_TP, False, dtype), entry
    return out_proj(o, p["wo"], tp, heads.split, dtype), entry


def gqa_decode(cfg, p: dict, x, cache_k, cache_v, pos: int, tp=NO_TP):
    """x: (B, 1, D); cache_(k|v): (B, Smax, KV, Dh); pos: int.

    Returns (out (B,1,D), cache_k, cache_v).  The new key and value are
    written into the cache tensors in place at ``pos`` (the reference returns
    updated copies; in place saves a copy of the cache per token).  Under
    ``tp`` the cache holds the KV heads the rank projects (``Heads``) and
    the output is summed over ``model``."""
    B, _, D = x.shape
    hd = cfg.resolved_head_dim
    heads = tp.heads(cfg.n_heads, cfg.n_kv_heads)
    inv_freq = rope_freqs(hd, cfg.rope_pct, cfg.rope_theta, device=x.device)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = gqa_project_qkv(cfg, p, x, positions, inv_freq)
    cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)
    ck, cv = heads.for_attention(cache_k, cache_v)
    Smax = cache_k.shape[1]
    KV = ck.shape[2]
    G = heads.nq // KV
    s = torch.einsum("bkgd,bjkd->bkgj",
                     cast_compute(q).to(torch.float32).reshape(B, KV, G, hd),
                     cast_compute(ck).to(torch.float32))
    s = s / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=x.device))
    mask = torch.arange(Smax, device=x.device)[None, None, None, :] <= pos
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd",
                     w.to(torch.bfloat16).to(torch.float32),
                     cast_compute(cv).to(torch.float32))
    o = o.reshape(B, 1, heads.nq, -1).to(x.dtype)
    return out_proj(o, p["wo"], tp, heads.split, x.dtype), cache_k, cache_v
