"""Execution variants (counterpart of ``repro.models.variant``).

The port keeps the reference's ``Variant`` field for field, and its named
``VARIANTS``, so that a variant (``--variant``) crosses unchanged.  What
the port reads of it:

- serving: ``use_pallas`` (prefill's attention and SSD through the
  hand-written kernels, ``kernels/flash_attention`` and
  ``kernels/ssd_scan``, instead of their plain PyTorch forms) and
  ``kv_block``;
- training: ``attn_variant`` (``folded`` causal block skipping),
  ``kv_block``, ``remat`` (``remat_wrap``), ``xent_chunk``,
  ``moe_capacity_factor``, ``accum_steps``, ``cast_params`` and
  ``adam_dtype`` (the Trainer stores the Adam moments in it; the reference
  reads it only in its dry run).  Training takes the plain route whatever
  ``use_pallas`` says, as the reference's does (its kernels are forward
  only).

- the mesh: ``psum_dtype`` (the expert-parallel combine of
  ``moe_layer``), ``seq_parallel`` and ``cache_layout`` (the sharding
  rules, through ``apply_rules``).
- the dry run and the probe (``launch.dryrun``, ``launch.probe``):
  ``kv_cache_dtype``, the decode cache's dtype (``float8_e4m3fn`` for the
  fp8 variants; its bytes a element in ``roofline.model_bytes``), as the
  reference's dry run reads it.

``unroll`` unrolls the reference's ``lax.scan`` loops for XLA's cost
analysis; eager PyTorch has no scan to unroll, so it is accepted and
ignored.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial


@dataclass(frozen=True)
class Variant:
    name: str = "baseline"
    attn_variant: str = "masked"     # masked | folded (causal block skipping)
    kv_block: int = 1024             # online-softmax KV block
    remat: str = "full"              # full | dots | none
    xent_chunk: int = 512            # chunked cross-entropy sequence block
    moe_capacity_factor: float | None = None
    psum_dtype: str = "float32"      # MoE combine psum precision
    use_pallas: bool = False         # the hand-written flash-attention / SSD kernels
    accum_steps: int = 1             # gradient-accumulation microbatches
    adam_dtype: str = "float32"      # Adam moment storage
    unroll: bool = False             # unroll attention/xent scans (ignored)
    cast_params: bool = False        # cast f32 params->bf16 at step entry
    kv_cache_dtype: str = "bfloat16" # decode KV cache dtype
    seq_parallel: bool = True        # shard residual seq dim over model (SP)
    cache_layout: str = "seq"        # decode KV cache: shard "seq" or "heads"


BASELINE = Variant()

# The reference's named variants, field for field.
VARIANTS: dict[str, Variant] = {
    "baseline": BASELINE,
    "folded_attn": replace(BASELINE, name="folded_attn", attn_variant="folded"),
    "remat_dots": replace(BASELINE, name="remat_dots", remat="dots"),
    "kvblock_2048": replace(BASELINE, name="kvblock_2048", kv_block=2048),
    "kvblock_4096": replace(BASELINE, name="kvblock_4096", kv_block=4096),
    "xent_2048": replace(BASELINE, name="xent_2048", xent_chunk=2048),
    "cap_1.0": replace(BASELINE, name="cap_1.0", moe_capacity_factor=1.0),
    "folded_remat_dots": replace(BASELINE, name="folded_remat_dots",
                                 attn_variant="folded", remat="dots"),
    "fit_single_pod": replace(BASELINE, name="fit_single_pod",
                              adam_dtype="bfloat16", accum_steps=4),
    "accum4": replace(BASELINE, name="accum4", accum_steps=4),
    "cast_bf16": replace(BASELINE, name="cast_bf16", cast_params=True),
    "cast_folded": replace(BASELINE, name="cast_folded", cast_params=True,
                           attn_variant="folded"),
    "cast_dots": replace(BASELINE, name="cast_dots", cast_params=True,
                         remat="dots"),
    "cast_folded_dots": replace(BASELINE, name="cast_folded_dots",
                                cast_params=True, attn_variant="folded",
                                remat="dots"),
    "fp8_cache": replace(BASELINE, name="fp8_cache",
                         kv_cache_dtype="float8_e4m3fn"),
    "fp8_heads": replace(BASELINE, name="fp8_heads",
                         kv_cache_dtype="float8_e4m3fn",
                         cache_layout="heads"),
    "moe_opt": replace(BASELINE, name="moe_opt", cast_params=True,
                       psum_dtype="bfloat16", moe_capacity_factor=1.0),
    "moe_opt_accum": replace(BASELINE, name="moe_opt_accum", cast_params=True,
                             psum_dtype="bfloat16", moe_capacity_factor=1.0,
                             accum_steps=4, adam_dtype="bfloat16"),
    "nosp": replace(BASELINE, name="nosp", seq_parallel=False),
    "cast_dots_nosp": replace(BASELINE, name="cast_dots_nosp",
                              cast_params=True, remat="dots",
                              seq_parallel=False),
    "dots_nosp_accum": replace(BASELINE, name="dots_nosp_accum",
                               cast_params=True, remat="dots",
                               seq_parallel=False, accum_steps=4),
    "best_a": replace(BASELINE, name="best_a", cast_params=True, remat="dots",
                      seq_parallel=False, attn_variant="folded"),
    "nosp_accum4": replace(BASELINE, name="nosp_accum4", cast_params=True,
                           seq_parallel=False, accum_steps=4),
    "accum2_folded": replace(BASELINE, name="accum2_folded", cast_params=True,
                             attn_variant="folded", accum_steps=2),
    "moe_best": replace(BASELINE, name="moe_best", cast_params=True,
                        psum_dtype="bfloat16", moe_capacity_factor=1.0,
                        remat="dots", seq_parallel=False),
    "moe_dots_sp": replace(BASELINE, name="moe_dots_sp", cast_params=True,
                           psum_dtype="bfloat16", moe_capacity_factor=1.0,
                           remat="dots", accum_steps=2),
    "moe_dots_accum4": replace(BASELINE, name="moe_dots_accum4",
                               cast_params=True, psum_dtype="bfloat16",
                               moe_capacity_factor=1.0, remat="dots",
                               accum_steps=4, adam_dtype="bfloat16"),
}


def apply_rules(ctx, variant: Variant):
    """Adjust a ShardCtx's logical rules for variant-level sharding choices."""
    if not variant.seq_parallel:
        ctx.rules["act_seq"] = [None]
    if variant.cache_layout == "heads":
        # KV heads take the model axis; cache seq stays local per shard =>
        # no cross-shard softmax combine, no psum in the decode inner loop
        ctx.rules["kv_seq"] = [("data",), None]
    return ctx


def _save_projections(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of the
    matrix products without a batch dimension (``aten.mm`` / ``addmm``:
    every projection, a 3-d activation times a 2-d weight folds to one),
    recompute everything else (``aten.bmm``, the attention's and the
    experts' batched products, included)."""
    import torch
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, variant: Variant):
    """``fn`` under the variant's rematerialisation, when autograd records:
    ``none`` keeps every activation, ``full`` keeps only ``fn``'s inputs and
    recomputes its body in the backward pass, ``dots`` keeps the
    projections' outputs too (a selective checkpoint).  The three give the
    same gradients; only the memory held between the passes differs."""
    if variant.remat == "none":
        return fn
    if variant.remat not in ("full", "dots"):
        raise ValueError(f"remat {variant.remat!r}: one of full, dots, none")

    def wrapped(*args):
        import torch
        from torch.utils.checkpoint import (
            checkpoint, create_selective_checkpoint_contexts)
        if not torch.is_grad_enabled():
            return fn(*args)
        if variant.remat == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=partial(
                                  create_selective_checkpoint_contexts,
                                  _save_projections))
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped
