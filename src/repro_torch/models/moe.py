"""Mixture-of-Experts layer: expert parallelism over the ``model`` axis
(counterpart of ``repro.models.moe``).

As in the reference: experts shard over the ``model`` axis (EP), tokens
over the data axes.  Routing is computed redundantly on every EP peer
(float32 softmax, top-k, the top-k weights renormalised; ties to the lower
expert index), each peer processes only its ``E_local = E / ep`` experts
from ``e0 = coord("model") * E_local`` under a fixed capacity ``C = max(1,
ceil(T*K/E*cf))`` per expert, with ``T = B * S`` the tokens of the block
``x`` this rank holds, one data shard's (so a token can drop on a mesh
that a one-device run of the whole batch keeps, as in the reference; at
decode ``T = B``), slots
taken first-come over the flattened ``(T, K)`` choices and dropped choices
sent to a spare row.  One all-reduce over ``model`` in ``psum_dtype``
combines the routed output, the shared experts' and the dense residual's
(tensor-parallel partials on their ffn shard); the aux loss (Switch-style)
is averaged over the whole mesh.  The expert products are plain batched
matrix products (the reference leaves them to XLA).

Held layout on a mesh (``registry.held_axes``): the experts' weights are
blocks, E over ``model`` and D over the fsdp axes, the shared and residual
weights (fsdp, model) / (model, fsdp) blocks; the layer reads them through
the models' gather, over the fsdp axes with the ``model`` block kept
(``sharding.gather_tree(..., keep=("model",))``: ZeRO-3, in bfloat16 when
serving and in float32 under autograd, so that the gather's backward
reduce-scatters float32 gradients).  The router arrives whole (the model
gathers it with the rest of the layer, ``gathered_at_layer``).  The
layer's input and output are this rank's block of the batch over the data
axes (the batch as the pipeline or the caller splits it), the whole
sequence, replicated over ``model`` (under sequence parallelism the models
all-gather the sequence before the layer and keep their block of its
output).  ``ctx`` None, or a
mesh whose axes all have one position, is one device: ``E_local = E``, no
collective.  Under autograd every collective carries its gradient
(``ShardCtx.all_gather``, ``all_reduce``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import TP_AXIS, gather_tree
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


#: the parameters ``moe_layer`` takes as blocks on a mesh (the router whole)
HELD = ("w_gate", "w_up", "w_down", "shared_gate", "shared_up",
        "shared_down", "res_gate", "res_up", "res_down")


def gathered_at_layer(specs: dict) -> dict:
    """The layer's ``moe_specs`` with the ``HELD`` leaves taken out: what
    the model gathers whole before the layer (``sharding.gather_tree``)."""
    return {k: (None if k in HELD else v) for k, v in specs.items()}


def moe_layer(ctx, cfg, p: dict, x, *, capacity_factor=None,
              psum_dtype: str = "float32"):
    """x: (B, S, D), this rank's block of the batch over the data axes.
    Returns (y (B, S, D) in x's dtype, aux loss f32 averaged over the
    mesh)."""
    m = cfg.moe
    E, K, D = m.n_experts, m.top_k, cfg.d_model
    names = ctx.mesh.axis_names if ctx is not None else ()
    tp = "model" if "model" in names else None
    fsdp = ctx.fsdp_axes if ctx is not None else ()
    ep = ctx.axis_size(tp) if tp else 1
    fs_size = ctx.axis_size(*fsdp) if fsdp else 1
    if E % ep:
        raise ValueError(f"{E} experts over a model axis of {ep}")
    E_local = E // ep
    B, S, _ = x.shape
    T = B * S
    C = capacity(cfg, T, capacity_factor)
    dev = x.device
    Fe = m.d_ff_expert
    want = {"w_gate": (E_local, D // fs_size, Fe),
            "w_up": (E_local, D // fs_size, Fe),
            "w_down": (E_local, Fe, D // fs_size)}
    for prefix, Fs in (("shared", Fe * m.n_shared_experts),
                       ("res", cfg.d_ff if m.dense_residual else 0)):
        if Fs:
            want[f"{prefix}_gate"] = want[f"{prefix}_up"] = \
                (D // fs_size, Fs // ep)
            want[f"{prefix}_down"] = (Fs // ep, D // fs_size)
    for name, shape in want.items():
        if tuple(p[name].shape) != shape:
            raise ValueError(f"{name} is {tuple(p[name].shape)}; on this mesh "
                             f"the layer holds a block of {shape}")

    specs = moe_specs(cfg)

    def gather(name):
        """ZeRO-3: the fsdp blocks of leaf ``name`` gathered, its ``model``
        block kept, in bfloat16."""
        return cast_compute(gather_tree(ctx, {name: p[name]},
                                        {name: specs[name]},
                                        keep=(TP_AXIS,))[name])

    xf = cast_compute(x.reshape(T, D))
    probs, topv, topi = route(cfg, p, xf)

    # capacity dispatch to the local experts: each choice's 1-based place
    # in its expert's queue, in the order of the flattened (T, K) choices
    e0 = ctx.coord((tp,)) * E_local if ep > 1 else 0
    le = topi.reshape(-1) - e0                                    # (T*K,)
    local = (le >= 0) & (le < E_local)
    onehot = (le[:, None] == torch.arange(E_local, device=dev)[None, :]) \
        & local[:, None]
    pos = torch.cumsum(onehot.to(torch.int32), dim=0) * onehot
    keep = onehot & (pos <= C)
    slot_mat = torch.where(keep, le[:, None] * C + pos - 1,
                           torch.zeros((), dtype=torch.long, device=dev))
    kept = torch.any(keep, dim=1)
    flat_slot = torch.where(kept, torch.sum(slot_mat, dim=1),
                            torch.full((), E_local * C, device=dev))
    slot_tk = flat_slot.reshape(T, K)
    kept_tk = kept.reshape(T, K)

    buf = torch.zeros((E_local * C + 1, D), dtype=xf.dtype, device=dev)
    for kk in range(K):   # K scatters of (T, D); the spare row takes drops
        buf[slot_tk[:, kk]] = xf
    xe = buf[:E_local * C].reshape(E_local, C, D)

    # the local experts' SwiGLU, batched over the experts (bf16 products)
    g = torch.bmm(xe, gather("w_gate"))
    u = torch.bmm(xe, gather("w_up"))
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(xe.dtype)
    ye = torch.bmm(h, gather("w_down")).reshape(E_local * C, D)
    ye = torch.cat([ye, torch.zeros((1, D), dtype=ye.dtype, device=dev)])

    # combine: K gathers of (T, D), float32
    out = torch.zeros((T, D), dtype=torch.float32, device=dev)
    for kk in range(K):
        w_k = (topv[:, kk] * kept_tk[:, kk]).to(torch.float32)
        out = out + ye[slot_tk[:, kk]].to(torch.float32) * w_k[:, None]

    # shared experts / dense residual: TP partials on the ffn shard
    for prefix, on in (("shared", m.n_shared_experts),
                       ("res", m.dense_residual)):
        if on:
            out = out + _ffn_partial(
                xf, gather(f"{prefix}_gate"), gather(f"{prefix}_up"),
                gather(f"{prefix}_down")).to(torch.float32)

    if ep > 1:
        out = ctx.all_reduce(out.to(getattr(torch, psum_dtype)), (tp,))

    # load-balance aux (Switch-style), averaged over the whole mesh
    frac = torch.mean(F.one_hot(topi, E).to(torch.float32), dim=(0, 1)) * E
    aux = torch.sum(frac * torch.mean(probs, dim=0))
    if ctx is not None and ctx.axis_size(*names) > 1:
        aux = ctx.all_mean(aux.reshape(1))[0]
    return out.reshape(B, S, D).to(x.dtype), aux
