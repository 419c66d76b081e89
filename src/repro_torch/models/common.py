"""Shared model machinery: param specs, initialisers, norms, MLPs,
embeddings, the chunked cross-entropy (counterpart of
``repro.models.common``).

Every model declares its parameters once as a nested dict of ``ParamSpec`` —
shape, logical axes and initialiser — and ``init_params`` draws the tensors
from a ``torch.Generator``.  The layouts, the keys, the stacked leading dims
and the standard deviations are the reference's, so a parameter tree crosses
between the two packages leaf for leaf (``repro_torch.convert``).  Compute is
in bfloat16, norms and softmax in float32, as in the reference.

On a mesh the MLP, the embedding and the head take a ``sharding.TP``
plan: ``apply_mlp`` is Megatron's pair (``w_gate`` / ``w_up`` column
blocks, ``w_down`` a row block, one reduction over ``model``), and the
head is vocabulary parallel (``embed_lookup`` masks the tokens outside the
rank's vocabulary rows and sums over ``model``; ``lm_logits`` and
``chunked_softmax_xent`` compute the rank's vocabulary columns, the
softmax's max and sum over ``model``, the gold logit from the rank that
owns it).  ``NO_TP`` (the default) is one device, the computation as it
was.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (NO_TP, TP_AXIS, gather_tree,
                                              tp_plan)
from repro_torch.obs import metrics, trace


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec shape {self.shape} and axes "
                             f"{self.axes} differ in length")


def spec_map(fn, tree):
    """``fn`` over every leaf of a nested dict (a leaf is anything that is
    not a dict), keeping the structure."""
    if isinstance(tree, dict):
        return {k: spec_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in the reference's flattening order
    (``jax.tree.flatten`` walks dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(name "a/b/c", leaf) for every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_leaves_with_paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def tree_unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def tree_index(tree, *idx):
    """The slice ``[idx]`` of every leaf of a stacked nested dict (one
    layer's parameters or cache of an ``(L, ...)`` stack)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, *idx) for k, v in tree.items()}
    return tree[idx]


def tree_unbind(tree) -> list:
    """The layers of a stacked nested dict, one dict of views each (the
    reference's scan over the stack).  One ``unbind`` a leaf: its backward
    stacks the layers' gradients once, where indexing each layer would
    write each into a zeroed copy of the whole stack."""
    if isinstance(tree, dict):
        parts = {k: tree_unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


def tree_stack(trees: list):
    """Stack a list of equally shaped nested dicts leaf by leaf (the
    reference's scan outputs)."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _fan_in(shape: tuple[int, ...]) -> int:
    # convention: last dim is the output dim for 2D+; fan-in is the product of the
    # remaining non-layer dims.  For stacked (L, ..., out) weights the leading
    # layer dim is excluded by the caller via scale.
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return max(math.prod(shape[:-1]), 1)


def init_leaf(spec: ParamSpec, generator: torch.Generator, shape=None):
    """One leaf drawn from ``generator`` on its device: ``spec.shape``, or
    ``shape`` (a block of the leaf, as a mesh rank holds it) at the whole
    leaf's standard deviation."""
    device = generator.device
    shape = spec.shape if shape is None else tuple(shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(_fan_in(spec.shape))
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 0.02
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(spec.dtype)


def init_params(specs, generator: torch.Generator):
    """Materialise a parameter tree from specs, drawn from ``generator`` on
    its device (leaves in the reference's order; the numbers differ from the
    reference's ``jax.random``, the standard deviations do not)."""
    # draw in the reference's leaf order, so that a seed gives the same tree
    # whatever order the dicts were built in
    drawn = {id(s): init_leaf(s, generator) for s in tree_leaves(specs)}
    return spec_map(lambda s: drawn[id(s)], specs)


# ---------------------------------------------------------------------------
# Numerics helpers (compute in bf16, normalize/softmax in f32)
# ---------------------------------------------------------------------------

def cast_compute(x, dtype=torch.bfloat16):
    """``x`` in ``dtype``.  While spans are on (``obs.trace.on``), a cast
    that changes the dtype is a ``cast`` span and counts the bytes it reads
    in ``cast_bytes``; where the dtype is already right ``.to`` launches
    nothing, and nothing is recorded."""
    if not trace.on() or x.dtype == dtype:
        return x.to(dtype)
    with trace.span("cast", cat="model"):
        metrics.REGISTRY.inc("cast_bytes", x.numel() * x.element_size())
        return x.to(dtype)


def rms_norm(x, weight, eps: float):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return out.to(x.dtype)


def layer_norm(x, weight, bias, eps: float):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def norm_specs(cfg, d: int) -> dict:
    if cfg.norm == "layer":
        return {"scale": ParamSpec((d,), ("embed",), "ones"),
                "bias": ParamSpec((d,), ("embed",), "zeros")}
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def apply_norm(cfg, p: dict, x):
    if cfg.norm == "layer":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def mlp_specs(cfg, d: int, d_ff: int) -> dict:
    if cfg.mlp == "swiglu":
        return {
            "w_gate": ParamSpec((d, d_ff), ("embed", "ffn")),
            "w_up": ParamSpec((d, d_ff), ("embed", "ffn")),
            "w_down": ParamSpec((d_ff, d), ("ffn", "embed")),
        }
    return {
        "w_up": ParamSpec((d, d_ff), ("embed", "ffn")),
        "w_down": ParamSpec((d_ff, d), ("ffn", "embed")),
    }


def apply_mlp(cfg, p: dict, x, tp=NO_TP):
    """The MLP of ``x`` (this rank's sequence block under ``tp.seq``); ``p``
    holds the rank's ``ffn`` blocks where ``tp`` splits them."""
    xc = cast_compute(tp.gather_seq(x))
    if cfg.mlp == "swiglu":
        g = xc @ cast_compute(p["w_gate"])
        u = xc @ cast_compute(p["w_up"])
        h = F.silu(g.to(torch.float32)).to(xc.dtype) * u
    else:
        u = xc @ cast_compute(p["w_up"])
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(u.to(torch.float32), approximate="tanh").to(xc.dtype)
    return tp.row(h, cast_compute(p["w_down"]), tp.splits("ffn", cfg.d_ff),
                  x.dtype)


def stack_specs(specs, n: int, axis_name: str = "layers"):
    """Prepend a stacked layer dim to every spec in the tree."""
    def one(s: ParamSpec) -> ParamSpec:
        scale = s.scale if s.scale is not None else 1.0 / math.sqrt(_fan_in(s.shape))
        if s.init in ("zeros", "ones"):
            scale = None
        return ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init, scale, s.dtype)
    return spec_map(one, specs)


# ---------------------------------------------------------------------------
# Embedding + logits + chunked cross-entropy (never materialises (B, S, V))
# ---------------------------------------------------------------------------

def vocab_padded(cfg) -> int:
    """Vocab padded to a 256 multiple, as the reference pads it (its vocab
    axis shards over a 16-way model axis).  Padded logit columns are masked
    to -1e30 before any softmax/argmax."""
    return -(-cfg.vocab_size // 256) * 256


def embed_specs(cfg) -> dict:
    vp = vocab_padded(cfg)
    out = {"embedding": ParamSpec((vp, cfg.d_model), ("vocab", "embed"), "embed")}
    if not cfg.tied_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, vp), ("embed", "vocab"))
    return out


def embed_tokens(p: dict, tokens):
    return cast_compute(p["embedding"][tokens])


def embed_lookup(ctx, cfg, p: dict, tokens):
    """``embed_tokens`` on a mesh (``p`` holds this rank's block of the
    table, or the whole): the table gathered over the fsdp axes at use;
    where the vocabulary is split over ``model``, each rank looks up the
    tokens of its rows, zeros the others, and the sum over ``model``
    (``TP.reduce``: this rank's sequence block under sequence parallelism)
    is the lookup."""
    tp = tp_plan(ctx, tokens.shape[1])
    emb = gather_tree(ctx, {"embedding": p["embedding"]}, embed_specs(cfg),
                      keep=(TP_AXIS,))
    v0, nv = tp.block("vocab", vocab_padded(cfg))
    if nv == vocab_padded(cfg):
        return tp.scatter_seq(embed_tokens(emb, tokens))
    local = tokens - v0
    mine = (local >= 0) & (local < nv)
    x = embed_tokens(emb, torch.where(mine, local, 0)) * mine[..., None]
    return tp.reduce(x)


def head_params(ctx, cfg, p: dict) -> dict:
    """The leaf ``lm_logits`` reads (the embedding where tied, else
    ``lm_head``), gathered at use on a mesh over the fsdp axes: its
    ``model`` block is the rank's vocabulary."""
    name = "embedding" if cfg.tied_embeddings else "lm_head"
    return gather_tree(ctx, {name: p[name]}, embed_specs(cfg),
                       keep=(TP_AXIS,))


def _logits_block(cfg, p: dict, h, v0: int = 0):
    """(..., D) -> (..., nv) f32 logits of the vocabulary columns ``[v0, v0
    + nv)`` that ``p`` holds; padded columns masked."""
    hc = cast_compute(h)
    if cfg.tied_embeddings:
        w = cast_compute(p["embedding"]).T
    else:
        w = cast_compute(p["lm_head"])
    logits = (hc @ w).to(torch.float32)
    if cfg.logit_scale != 1.0:
        logits = logits / cfg.logit_scale
    nv = w.shape[-1]
    if v0 + nv > cfg.vocab_size:
        pad_mask = torch.arange(v0, v0 + nv,
                                device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_mask, -1e30)
    return logits


def lm_logits(cfg, p: dict, h, tp=NO_TP):
    """(..., D) -> (..., V_padded) f32 logits; padded columns masked.
    Where ``tp`` splits the vocabulary, each rank computes its columns and
    an all-gather over ``model`` joins them."""
    v0, nv = tp.block("vocab", vocab_padded(cfg))
    logits = _logits_block(cfg, p, h, v0)
    if nv < vocab_padded(cfg):
        logits = tp.ctx.all_gather(logits, TP_AXIS, logits.ndim - 1)
    return logits


def chunked_softmax_xent(cfg, p: dict, h, labels, chunk: int = 512,
                         unroll: bool = False, tp=NO_TP):
    """Mean token cross-entropy over sequence chunks of ``chunk`` (and the
    remainder), summed in float32 in the reference's order.

    h: (B, S, D), whole; labels: (B, S) int.  Each chunk's (B, c, V)
    float32 logits live only inside the chunk: under autograd the chunk is
    a checkpoint, so its logits are recomputed in the backward pass (the
    reference's ``@jax.checkpoint``).  Where ``tp`` splits the vocabulary
    each rank computes its columns' logits: the log-sum-exp takes the max
    over ``model`` (a constant to autograd) and the sum of the
    exponentials over ``model``, the gold logit comes from the rank whose
    columns hold the label, and every rank gets the same loss.
    ``unroll`` (the reference's scan unrolling) is accepted and ignored.
    """
    B, S, D = h.shape
    chunk = min(chunk, S)
    n = S // chunk
    v0, nv = tp.block("vocab", vocab_padded(cfg))
    split = nv < vocab_padded(cfg)

    def piece(h_c, y_c):
        logits = _logits_block(cfg, p, h_c, v0)              # (B, c, nv) f32
        if not split:
            lse = torch.logsumexp(logits, dim=-1)            # (B, c)
            gold = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
            return torch.sum(lse - gold)
        m = tp.ctx.all_reduce(torch.amax(logits, dim=-1).detach(),
                              (TP_AXIS,), "max")
        se = tp.sum(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
        lse = m + torch.log(se)
        local = y_c.long() - v0
        mine = (local >= 0) & (local < nv)
        gold = torch.gather(logits, -1,
                            torch.where(mine, local, 0)[..., None])[..., 0]
        gold = tp.sum(torch.where(mine, gold, 0.0))
        return torch.sum(lse - gold)

    def one(h_c, y_c):
        if torch.is_grad_enabled():
            return checkpoint(piece, h_c, y_c, use_reentrant=False)
        return piece(h_c, y_c)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        total = total + one(h[:, i * chunk:(i + 1) * chunk],
                            labels[:, i * chunk:(i + 1) * chunk])
    if S - n * chunk:
        total = total + one(h[:, n * chunk:], labels[:, n * chunk:])
    return total / (B * S)
