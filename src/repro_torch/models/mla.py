"""Multi-head Latent Attention, DeepSeek-V2 (counterpart of
``repro.models.mla``).

Training and prefill use the expanded form: the latent ``c`` is projected
up to per-head keys (128 nope dims, joined by the 64 shared rope dims) and
values (128 dims), and the attention runs over q/k of 192 and v of 128
dims (``Dv != D``): through ``chunked_attention`` (or, in training under
the ``folded`` variant, ``folded_causal_attention``) on the plain route,
through ``flash_attn.cu``'s (192, 128) instance under
``Variant.use_pallas`` in the prefill.  Decode uses weight absorption
against the compressed cache ``(c, k_rope)``, plain PyTorch as the
reference computes it.

On a mesh (a ``sharding.TP`` plan) ``wq``, ``w_uk``, ``w_uv`` and ``wo``
arrive as the rank's blocks of heads and the layer runs on those heads,
its output a partial sum that ``TP.reduce`` sums over ``model``;
``w_dkv`` and ``kv_norm`` are whole (``kv_lora`` is replicated by the
rules), and so is the compressed cache.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention import (_proj_heads, apply_rope,
                                          chunked_attention,
                                          folded_causal_attention, out_proj,
                                          rope_freqs)
from repro_torch.distributed.sharding import NO_TP
from repro_torch.models.common import ParamSpec, cast_compute, rms_norm


def mla_specs(cfg) -> dict:
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qdim = m.nope_head_dim + m.rope_head_dim
    return {
        "wq": ParamSpec((d, H, qdim), ("embed", "heads", "head_dim")),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.rope_head_dim), ("embed", "kv_lora")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("kv_lora",), "ones"),
        "w_uk": ParamSpec((m.kv_lora_rank, H, m.nope_head_dim),
                          ("kv_lora", "heads", "head_dim")),
        "w_uv": ParamSpec((m.kv_lora_rank, H, m.v_head_dim),
                          ("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def mla_rope_freqs(cfg, device=None):
    return rope_freqs(cfg.mla.rope_head_dim, 1.0, cfg.rope_theta,
                      device=device)


def _project_latent(cfg, p, x, positions, inv_freq):
    """Returns (q_nope, q_rope, c (normalised), k_rope) for a token block."""
    m = cfg.mla
    xc = cast_compute(x)
    q = _proj_heads(xc, p["wq"])
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, inv_freq)
    ckv = xc @ cast_compute(p["w_dkv"])
    c, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, inv_freq)[:, :, 0, :]
    return q_nope, q_rope, c, k_rope


def mla_expand(cfg, p, x, positions, inv_freq):
    """The expanded form's operands for a prompt: q and k (B, S, H, nope +
    rope), v (B, S, H, v_head_dim), all contiguous bf16, and the cache
    entries c (B, S, kv_lora) and k_rope (B, S, rope); H the heads of
    ``p``'s blocks."""
    B, S, _ = x.shape
    R = cfg.mla.rope_head_dim
    q_nope, q_rope, c, k_rope = _project_latent(cfg, p, x, positions,
                                                inv_freq)
    H = q_nope.shape[2]
    k_nope = _proj_heads(c, p["w_uk"])
    v = _proj_heads(c, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, R)], dim=-1)
    return q, k, v, c, k_rope


def mla_attention(cfg, p: dict, x, *, positions=None, kv_block: int = 1024,
                  variant: str = "masked", ctx=None, unroll: bool = False,
                  tp=NO_TP):
    """Expanded-form causal MLA for training, on the plain route.  x: (B,
    S, D) -> (B, S, D), the residual stream's block under ``tp``."""
    xs = tp.gather_seq(x)
    B, S, _ = xs.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v, _, _ = mla_expand(cfg, p, xs, positions,
                               mla_rope_freqs(cfg, x.device))
    if variant == "folded" and S > kv_block and S % kv_block == 0:
        o = folded_causal_attention(q, k, v, q_block=kv_block,
                                    kv_block=kv_block)
    else:
        o = chunked_attention(q, k, v, causal=True, kv_block=min(kv_block, S))
    return out_proj(o, p["wo"], tp, q.shape[2] < cfg.n_heads, x.dtype)


def mla_decode(cfg, p: dict, x, cache_c, cache_kr, pos: int, tp=NO_TP):
    """Absorbed-form decode against the compressed cache.

    x: (B, 1, D); cache_c: (B, Smax, R); cache_kr: (B, Smax, rope_dim).
    scores = q_nope @ W_uk . c_j  (W_uk absorbed into q)  +  q_rope . k_rope_j
    out    = (attn @ c) @ W_uv @ W_o  (W_uv absorbed into the output path)
    The new c and k_rope are written into the cache tensors in place at
    ``pos`` (the reference returns updated copies).  Each product takes
    bf16 operands and sums in float32, rounded where the reference's
    einsum rounds (its bf16 outputs).  Under ``tp``: the rank's heads, the
    output summed over ``model``."""
    m = cfg.mla
    B = x.shape[0]
    f32, bf16 = torch.float32, torch.bfloat16
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _project_latent(
        cfg, p, x, positions, mla_rope_freqs(cfg, x.device))
    cache_c[:, pos:pos + 1] = c_new.to(cache_c.dtype)
    cache_kr[:, pos:pos + 1] = kr_new.to(cache_kr.dtype)
    cc = cast_compute(cache_c).to(f32)
    # absorb W_uk: q_lat (B, H, R)
    q_lat = torch.einsum("bshk,rhk->bhr", q_nope.to(f32),
                         cast_compute(p["w_uk"]).to(f32)).to(bf16)
    s = torch.einsum("bhr,bjr->bhj", q_lat.to(f32), cc)
    s = s + torch.einsum("bshk,bjk->bhj", q_rope.to(f32),
                         cast_compute(cache_kr).to(f32))
    s = s / math.sqrt(float(m.nope_head_dim + m.rope_head_dim))
    Smax = cache_c.shape[1]
    mask = torch.arange(Smax, device=x.device)[None, None, :] <= pos
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhj,bjr->bhr", w.to(bf16).to(f32), cc)
    # absorb W_uv, then W_o
    o = torch.einsum("bhr,rhk->bhk", o_lat.to(bf16).to(f32),
                     cast_compute(p["w_uv"]).to(f32)).to(bf16)
    out = torch.einsum("bhk,hkd->bd", o.to(f32),
                       cast_compute(p["wo"]).to(f32))[:, None, :]
    split = o.shape[1] < cfg.n_heads
    # a split's float32 partial sums are rounded once, after the sum
    return tp.reduce(out if split else out.to(bf16), split, x.dtype), \
        cache_c, cache_kr
