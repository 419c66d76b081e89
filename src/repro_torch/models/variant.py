"""Execution variants (counterpart of ``repro.models.variant``).

The port keeps the reference's ``Variant`` field for field.  What the port
reads of it today: ``use_pallas`` (prefill's attention and SSD through the
hand-written kernels, ``kernels/flash_attention`` and ``kernels/ssd_scan``,
instead of their plain PyTorch forms) and ``kv_block``.  The other fields
are sharding, remat and training knobs of the reference, carried so that a
variant crosses unchanged; ``apply_rules``/``remat_wrap`` are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass


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
    unroll: bool = False             # unroll attention/xent scans
    cast_params: bool = False        # cast f32 params->bf16 at step entry
    kv_cache_dtype: str = "bfloat16" # decode KV cache dtype
    seq_parallel: bool = True        # shard residual seq dim over model (SP)
    cache_layout: str = "seq"        # decode KV cache: shard "seq" or "heads"


BASELINE = Variant()
