"""The flash-attention entry point (counterpart of
``repro.kernels.flash_attention.ops``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_attention


def flash(q, k, v, causal: bool = True, q_block: int = 256,
          kv_block: int = 256):
    return flash_attention(q, k, v, causal=causal, q_block=q_block,
                           kv_block=kv_block)


def flops(q, k, causal: bool) -> float:
    """Useful attention flops (2*S_q*S_k*D*H*B*2 matmuls, halved if causal)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    f = 4.0 * B * H * Sq * Sk * D
    return f / 2 if causal else f
