"""Plain PyTorch pieces of the reference forward passes, in float32.

Every matrix product takes its operands through ``rnd`` first: ``exact``
(identity) for the reference itself, ``fp8`` for the control, which puts
the reference in the program's place one precision below the bfloat16
compute the configurations state. Norms, softmax and rotary stay
float32 in both. Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def exact(x):
    return x


def fp8(x):
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its absolute
    maximum at the format's largest value), returned in float32."""
    x = x.to(torch.float32)
    amax = x.abs().amax()
    if amax == 0:
        return x
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm(rnd, a, b):
    return rnd(a) @ rnd(b)


def rms_norm(x, scale, eps: float):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale.to(torch.float32)


def silu(x):
    return x * torch.sigmoid(x)


def swiglu(rnd, p: dict, x):
    g = mm(rnd, x, p["w_gate"].to(torch.float32))
    u = mm(rnd, x, p["w_up"].to(torch.float32))
    return mm(rnd, silu(g) * u, p["w_down"].to(torch.float32))


def rope(x, theta: float, pct: float):
    """Rotary embedding of the first ``pct`` of the head dims at positions
    0 .. S-1, as interleaved pairs (x[..., ::2], x[..., 1::2]).
    x: (B, S, H, D)."""
    D = x.shape[-1]
    rot = int(D * pct) // 2 * 2
    if rot == 0:
        return x
    S = x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float64,
                                       device=x.device) / rot)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(torch.float32)[None, :, None, :]
    sin = torch.sin(ang).to(torch.float32)[None, :, None, :]
    x1, x2 = x[..., :rot:2], x[..., 1:rot:2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.reshape(*x.shape[:-1], rot), x[..., rot:]], dim=-1)


def causal_attention(rnd, q, k, v, q_block: int = 512):
    """Softmax attention under the causal mask, float32, blocked over the
    queries so that one block's (H, q_block, S) scores are alive at a time.
    q: (B, S, H, D); k/v: (B, S, KV, D), H a multiple of KV.
    -> (B, S, H, D)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    kf = rnd(k).permute(0, 2, 1, 3)                       # (B, KV, S, D)
    vf = rnd(v).permute(0, 2, 1, 3)
    out = []
    for q0 in range(0, S, q_block):
        qb = q[:, q0:q0 + q_block]
        n = qb.shape[1]
        qb = rnd(qb).reshape(B, n, KV, G, D).permute(0, 2, 3, 1, 4)
        s = qb @ kf[:, :, None].transpose(-1, -2) / math.sqrt(D)
        keep = (torch.arange(q0, q0 + n, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
        w = torch.softmax(s, dim=-1)                      # (B, KV, G, n, S)
        o = rnd(w) @ vf[:, :, None]                        # (B, KV, G, n, D)
        out.append(o.permute(0, 3, 1, 2, 4).reshape(B, n, H, D))
    return torch.cat(out, dim=1)


def gqa_layer(rnd, cfg: dict, p: dict, h):
    """One attention layer of a normed residual stream h (B, S, d):
    (output (B, S, d), {"k", "v"} after the rotary, float32)."""
    B, S, d = h.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    D = cfg["head_dim"] or d // H

    def proj(w, heads):
        return mm(rnd, h, w.to(torch.float32).reshape(d, heads * D)
                  ).reshape(B, S, heads, D)
    q, k, v = proj(p["wq"], H), proj(p["wk"], KV), proj(p["wv"], KV)
    q = rope(q, cfg["rope_theta"], cfg["rope_pct"])
    k = rope(k, cfg["rope_theta"], cfg["rope_pct"])
    o = causal_attention(rnd, q, k, v)
    out = mm(rnd, o.reshape(B, S, H * D),
             p["wo"].to(torch.float32).reshape(H * D, d))
    return out, {"k": k, "v": v}


def embed(p: dict, tokens):
    return p["embedding"][tokens].to(torch.float32)


def last_logits(rnd, cfg: dict, p_embed: dict, h_last):
    """h_last (B, d) -> (B, vocab_size) float32 logits of the vocabulary's
    own columns (the padding rows of the table are not read)."""
    V = cfg["vocab_size"]
    if cfg["tied_embeddings"]:
        w = p_embed["embedding"][:V].to(torch.float32).T
    else:
        w = p_embed["lm_head"][:, :V].to(torch.float32)
    return mm(rnd, h_last, w) / cfg["logit_scale"]


def check_supported(cfg: dict) -> None:
    """Raise on a configuration option the references do not compute."""
    bad = {k: cfg.get(k) for k, ok in (("norm", "rms"), ("mlp", "swiglu"))
           if cfg.get(k, ok) != ok}
    if cfg.get("qk_norm"):
        bad["qk_norm"] = True
    if cfg.get("moe") or cfg.get("mla"):
        bad["experts or latent attention"] = True
    if bad:
        raise ValueError(f"the reference does not compute {bad}")
