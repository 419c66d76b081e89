"""Training / serving step factories (counterpart of ``repro.train.step``).

``make_train_step``: the model loss and its gradients through autograd,
then AdamW, with optional gradient accumulation (microbatches in turn,
their float32 gradients summed) and optional int8 error-feedback gradient
compression before the optimiser.  The step takes the plain route whatever
``Variant.use_pallas`` says, as the reference's does: its flash-attention
and SSD kernels are forward only ("training runs the XLA path",
``repro/kernels/flash_attention/flash_attention.py:9-10``), so training
launches neither hand-written kernel.

On a mesh (a ``ctx`` of more than one position, over as many ranks) the
step computes what the reference's SPMD step computes.  Each rank holds
its parameters and moments as the blocks ``ShardCtx.spec`` gives (or a
leaf whole), takes its block of the batch over the data axes, and the
models gather each layer's leaves whole at use.  The gradient rule:

    each rank backpropagates its loss (the mean over its batch block, plus
    the aux loss, already a mesh mean) scaled by 1 / N, N the ranks in the
    mesh, through collectives whose backwards are sum-conjugate (an
    all-gather's is a reduce-scatter, a sum all-reduce's a sum
    all-reduce); then every gradient block is all-reduced (sum, float32)
    over the mesh axes its leaf is not split on.

Checked on paper, with dp data shards of M model ranks each (N = dp M)
and the global loss L = (1/dp) sum_d xent_d + w aux, aux = (1/N) sum_r
aux_r:

- a leaf replicated over ``model`` (whole, or split over the fsdp axes and
  gathered): every model rank of shard d computed the same xent_d, so the
  sum over all N ranks of (1/N) d xent_d gives (M/N) sum_d d xent_d =
  (1/dp) sum_d d xent_d; a gathered leaf's reduce-scatter sums over the
  axes it is split on, the all-reduce over the rest;
- the experts (E over ``model``, D over fsdp): rank (d, m)'s partial
  output is summed over ``model`` (``moe.py``'s all-reduce), so the
  cotangent reaching it is the sum of the M equal cotangents, M / N d
  xent_d; the fsdp gather's reduce-scatter sums over d: (M/N) sum_d =
  (1/dp) sum_d, and no axis is left to reduce.  The router and the
  shared experts' ``model`` blocks follow by the same sum;
- the aux loss: each rank's cotangent w / N reaches every aux_r through
  the mean's all-reduce backward as w / N, and the sum over all ranks is
  w (1/N) sum_r d aux_r = w d aux.

The metrics (loss, xent, aux) are the mesh means, ``grad_norm`` sums each
leaf's squares over the axes it is split on (``adamw.global_norm``) and
``grad_compression`` scales each leaf by the max over the whole leaf: all
equal on every rank.  A ``ctx`` of one position is one device, bit for
bit: no collective, no scaling.

``make_prefill_step`` and ``make_decode_step`` hand ``ctx`` to the model:
on a mesh the parameters are gathered at use, a moe layer runs expert
parallel, and ``seq_shard_decode`` (the hybrid) decodes each site's
attention over this rank's block of the sequence-sharded KV cache
(``serve.flash_decode``).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import spec_map, tree_leaves, tree_unflatten
from repro_torch.models.registry import build
from repro_torch.models.variant import BASELINE, Variant
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_grads


def make_train_step(cfg, ctx=None, opt_cfg: adamw.AdamWConfig | None = None,
                    variant: Variant = BASELINE, accum_steps: int | None = None,
                    grad_compression: bool = False):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    params and the moments are updated in place (and returned);
    ``grad_compression`` keeps its error residual in
    ``opt_state["ef_error"]``.  metrics: the loss's ({"xent"[, "aux"]}),
    "loss", "grad_norm", "lr" (0-dim tensors).  On a mesh (``ctx``) the
    params, moments and residual are this rank's blocks and the batch its
    block (the module docstring); a mesh without its ranks raises."""
    n = ctx.n_ranks if ctx is not None else 1
    if n > 1:
        ctx.check_ranks()
    model = build(cfg)
    specs = tree_leaves(model.param_specs())
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    accum_steps = accum_steps if accum_steps is not None else variant.accum_steps

    def loss_fn(params, batch):
        if variant.cast_params:
            # bf16 weights at step entry (norms and scales stay f32); the
            # gradients still reach the f32 parameters through the cast
            params = spec_map(
                lambda p: p.to(torch.bfloat16)
                if (p.dtype == torch.float32 and p.ndim > 1) else p, params)
        return model.loss(params, batch, ctx, variant)

    def value_and_grad(params, leaves, batch):
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss / n if n > 1 else loss, leaves,
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if accum_steps > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in leaves]
            losses, metrics_all = [], []
            for i in range(accum_steps):
                mb = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                   + v.shape[1:])[i] for k, v in batch.items()}
                loss_i, m_i, g = value_and_grad(params, leaves, mb)
                gsum = [a + b for a, b in zip(gsum, g)]
                losses.append(loss_i)
                metrics_all.append(m_i)
            grads = [g / accum_steps for g in gsum]
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in metrics_all]))
                       for k in metrics_all[0]}
        else:
            loss, metrics, grads = value_and_grad(params, leaves, batch)
        split = None
        if n > 1:
            held = [ctx.held_spec(p, s.shape, s.axes)
                    for p, s in zip(leaves, specs)]
            grads = [ctx.all_reduce(g.to(torch.float32), ctx.other_axes(h))
                     for g, h in zip(grads, held)]
            split = [ctx.split_axes(h) for h in held]
            names = list(metrics)
            means = ctx.all_reduce(torch.stack(
                [loss] + [metrics[k] for k in names]).to(torch.float32),
                ctx.mesh.axis_names) / n
            loss, metrics = means[0], dict(zip(names, means[1:]))
        grads = tree_unflatten(params, list(grads))
        new_err = None
        if grad_compression:
            grads, new_err = compress_grads(grads, opt_state["ef_error"],
                                            ctx if n > 1 else None, split)
        params, new_opt, opt_metrics = adamw.apply(
            opt_cfg, params,
            {k: v for k, v in opt_state.items() if k != "ef_error"}, grads,
            ctx if n > 1 else None, split)
        if grad_compression:
            new_opt["ef_error"] = new_err
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, new_opt, metrics

    return train_step


def make_prefill_step(cfg, ctx=None, variant: Variant = BASELINE):
    """prefill_step(params, batch) -> (logits, cache), without autograd."""
    model = build(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.family == "encdec":
            return model.prefill(params, batch, ctx, variant)
        return model.prefill(params, batch["tokens"], ctx, variant)

    return prefill_step


def make_decode_step(cfg, ctx=None, variant: Variant = BASELINE,
                     seq_shard_decode: bool = False):
    """decode_step(params, cache, batch, pos) -> (logits, cache), without
    autograd.  ``seq_shard_decode`` (the hybrid only, as in the
    reference): the cache's k/v are this rank's blocks of a sequence-sharded
    cache."""
    model = build(cfg)
    kwargs = {}
    if cfg.family == "hybrid":
        kwargs["seq_shard_decode"] = seq_shard_decode

    @torch.no_grad()
    def decode_step(params, cache, batch, pos):
        return model.decode_step(params, cache, batch["tokens"], pos, ctx,
                                 variant, **kwargs)

    return decode_step
