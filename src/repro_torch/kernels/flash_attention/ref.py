"""Oracle for the flash-attention kernel: plain softmax attention in f32
(counterpart of ``repro.kernels.flash_attention.ref``; the same function as
``flash_attention.plain_flash``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import plain_flash


def reference(q, k, v, *, causal: bool = True):
    return plain_flash(q, k, v, causal=causal)
