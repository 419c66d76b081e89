"""Mixture-of-Experts layer on one device (counterpart of
``repro.models.moe``).

The reference shards experts over its ``model`` axis and combines with a
psum inside ``shard_map``; on one device that is ``E_local = E``, ``e0 =
0``, no gather and no psum, and the body is what is left, kept to the
letter: routing in float32 (softmax, top-k, the top-k weights
renormalised), a fixed capacity ``C = max(1, ceil(T*K/E*cf))`` per expert
with ``T = B*S`` (at decode ``T = B``, so tokens drop, as in the
reference), slots taken first-come over the flattened ``(T, K)`` choices
and dropped choices sent to a spare row, the experts' SwiGLU as batched
bfloat16 products, the combine in float32, the shared experts and the
dense-residual branch, and the Switch-style aux loss.  The expert products
are plain batched matrix products (the reference leaves them to XLA).
``ctx`` is accepted and ignored, as elsewhere in the port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, cast_compute


def moe_specs(cfg) -> dict:
    m, d = cfg.moe, cfg.d_model
    E, Fe = m.n_experts, m.d_ff_expert
    out = {
        "router": ParamSpec((d, E), ("embed", None), "normal", 0.02),
        "w_gate": ParamSpec((E, d, Fe), ("experts", "embed", None)),
        "w_up": ParamSpec((E, d, Fe), ("experts", "embed", None)),
        "w_down": ParamSpec((E, Fe, d), ("experts", None, "embed")),
    }
    if m.n_shared_experts:
        Fs = Fe * m.n_shared_experts
        out["shared_gate"] = ParamSpec((d, Fs), ("embed", "ffn"))
        out["shared_up"] = ParamSpec((d, Fs), ("embed", "ffn"))
        out["shared_down"] = ParamSpec((Fs, d), ("ffn", "embed"))
    if m.dense_residual:
        out["res_gate"] = ParamSpec((d, cfg.d_ff), ("embed", "ffn"))
        out["res_up"] = ParamSpec((d, cfg.d_ff), ("embed", "ffn"))
        out["res_down"] = ParamSpec((cfg.d_ff, d), ("ffn", "embed"))
    return out


def _ffn_partial(x, wg, wu, wd):
    """SwiGLU of the shared experts and the dense residual (bf16 products,
    the gate in float32, as the reference's ``_ffn_partial``)."""
    g = x @ wg
    u = x @ wu
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    return h @ wd


def capacity(cfg, tokens: int, capacity_factor=None) -> int:
    """Slots per expert for ``tokens`` routed tokens."""
    m = cfg.moe
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    return max(1, math.ceil(tokens * m.top_k / m.n_experts * cf))


def route(cfg, p: dict, xf):
    """Routing of the (T, D) bf16 tokens: (probs (T, E) f32, topv (T, K)
    renormalised, topi (T, K)).  The top K are taken by a stable sort, so
    that equal probabilities (frequent: the logits are bf16) go to the lower
    expert index first, as ``jax.lax.top_k`` breaks ties; ``torch.topk``
    promises no order among ties."""
    logits = (xf @ cast_compute(p["router"])).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.moe.top_k
    topv, topi = topv[:, :K], topi[:, :K]
    return probs, topv / torch.sum(topv, dim=-1, keepdim=True), topi


def moe_layer(ctx, cfg, p: dict, x, *, capacity_factor=None,
              psum_dtype: str = "float32"):
    """x: (B, S, D).  Returns (y (B, S, D) in x's dtype, aux loss f32)."""
    m = cfg.moe
    E, K, D = m.n_experts, m.top_k, cfg.d_model
    B, S, _ = x.shape
    T = B * S
    C = capacity(cfg, T, capacity_factor)
    dev = x.device
    xf = cast_compute(x.reshape(T, D))
    probs, topv, topi = route(cfg, p, xf)

    # capacity dispatch: each choice's 1-based place in its expert's queue,
    # in the order of the flattened (T, K) choices
    flat_e = topi.reshape(-1)                                     # (T*K,)
    onehot = flat_e[:, None] == torch.arange(E, device=dev)[None, :]
    pos = torch.cumsum(onehot.to(torch.int32), dim=0) * onehot
    keep = onehot & (pos <= C)
    slot_mat = torch.where(keep, flat_e[:, None] * C + pos - 1,
                           torch.zeros((), dtype=torch.long, device=dev))
    kept = torch.any(keep, dim=1)
    flat_slot = torch.where(kept, torch.sum(slot_mat, dim=1),
                            torch.full((), E * C, device=dev))
    slot_tk = flat_slot.reshape(T, K)
    kept_tk = kept.reshape(T, K)

    buf = torch.zeros((E * C + 1, D), dtype=xf.dtype, device=dev)
    for kk in range(K):   # K scatters of (T, D); the spare row E*C takes drops
        buf[slot_tk[:, kk]] = xf
    xe = buf[:E * C].reshape(E, C, D)

    # the experts' SwiGLU, batched over the experts (bf16 products)
    g = torch.bmm(xe, cast_compute(p["w_gate"]))
    u = torch.bmm(xe, cast_compute(p["w_up"]))
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(xe.dtype)
    ye = torch.bmm(h, cast_compute(p["w_down"])).reshape(E * C, D)
    ye = torch.cat([ye, torch.zeros((1, D), dtype=ye.dtype, device=dev)])

    # combine: K gathers of (T, D), float32
    out = torch.zeros((T, D), dtype=torch.float32, device=dev)
    for kk in range(K):
        w_k = (topv[:, kk] * kept_tk[:, kk]).to(torch.float32)
        out = out + ye[slot_tk[:, kk]].to(torch.float32) * w_k[:, None]

    if m.n_shared_experts:
        out = out + _ffn_partial(xf, cast_compute(p["shared_gate"]),
                                 cast_compute(p["shared_up"]),
                                 cast_compute(p["shared_down"])).to(torch.float32)
    if m.dense_residual:
        out = out + _ffn_partial(xf, cast_compute(p["res_gate"]),
                                 cast_compute(p["res_up"]),
                                 cast_compute(p["res_down"])).to(torch.float32)

    # load-balance aux (Switch-style)
    frac = torch.mean(F.one_hot(topi, E).to(torch.float32), dim=(0, 1)) * E
    aux = torch.sum(frac * torch.mean(probs, dim=0))
    return out.reshape(B, S, D).to(x.dtype), aux
