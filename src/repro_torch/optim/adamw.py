"""AdamW with decoupled weight decay (counterpart of ``repro.optim.adamw``).

The reference's arithmetic in float32, in its order: the gradient clipped
by its global norm, a linear warmup then a cosine decay to
``min_lr_ratio``, bias correction with a float32 step.  The moments are
stored in the dtype ``init_state`` gives them (float32, or bfloat16 for
the ``fit_single_pod`` variant) and computed in float32.  ``apply`` updates
the parameters and the moments in place, under ``torch.no_grad()``, one
leaf at a time (a large leaf in slices of whole rows of its leading
dimension, each at most SLICE_ELEMENTS: the update is elementwise, so the
slices give the same bits as the whole leaf, with temporaries the size of
one slice).  On a mesh each rank updates the blocks it holds (the moments
held as the parameters are); the one quantity over whole leaves, the
global norm, sums each leaf's squares over the axes it is split on
(``split``), so that every element counts once and every rank clips by the
same norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.common import spec_map, tree_leaves

#: the most elements a slice of a leaf's update takes (unless one row of the
#: leading dimension holds more)
SLICE_ELEMENTS = 1 << 25


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay: the learning rate at ``step`` (a
    tensor), float32."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32,
                                   device=t.device) * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params, adam_dtype="float32"):
    """Zero moments ``mu`` and ``nu`` shaped as the parameters, stored in
    ``adam_dtype``, and the step counter (int32, 0)."""
    dtype = getattr(torch, adam_dtype) if isinstance(adam_dtype, str) \
        else adam_dtype
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)  # noqa: E731
    first = tree_leaves(params)[0]
    return {"mu": spec_map(zeros, params), "nu": spec_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree, ctx=None, split=None):
    """The float32 L2 norm over every leaf, the leaves' sums of squares
    added in the reference's leaf order.  On a mesh (``ctx``) each leaf is
    a block: its sum of squares is summed over ``split[i]``, the mesh axes
    leaf i is split on (in ``tree_leaves`` order)."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    if ctx is not None:
        sq = ctx.all_reduce_each(sq, split)
    return torch.sqrt(sum(sq))


def _update(cfg, p, g, m, v, clip, lr, b1c, b2c):
    """One leaf (or slice) of the AdamW update, written into p, m, v."""
    g = g.to(torch.float32) * clip
    m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
    v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
    mhat = m32 / b1c
    vhat = v32 / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
        + cfg.weight_decay * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    m.copy_(m32.to(m.dtype))
    v.copy_(v32.to(v.dtype))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, state, grads, ctx=None, split=None):
    """One AdamW step.  Updates ``params`` and the moments in place and
    returns (params, the new state, {"grad_norm", "lr"}).  On a mesh the
    leaves are this rank's blocks, ``split`` the axes each is split on
    (``global_norm``)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, ctx, split)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        p = leaf[0]
        rows = max(1, SLICE_ELEMENTS // max(1, p[0].numel())) if p.ndim \
            else 1
        for p, g, m, v in zip(*(t.split(rows) if t.ndim else (t,)
                                 for t in leaf)):
            _update(cfg, p, g, m, v, clip, lr, b1c, b2c)
    new_state = dict(state, step=step)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
