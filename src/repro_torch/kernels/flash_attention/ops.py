"""The flash-attention entry point (counterpart of
``repro.kernels.flash_attention.ops``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_attention


def flash(q, k, v, causal: bool = True, q_block: int = 256,
          kv_block: int = 256, q_offset: int = 0):
    return flash_attention(q, k, v, causal=causal, q_block=q_block,
                           kv_block=kv_block, q_offset=q_offset)


def flops(q, k, causal: bool, q_offset: int = 0) -> float:
    """Useful attention flops (2*S_q*S_k*D*H*B*2 matmuls, halved if causal).
    With a causal ``q_offset`` the queries see a rectangle of ``q_offset``
    keys each and a triangle after it: 4*B*H*D*(S_q*q_offset + S_q**2/2)
    (0 gives the reference's half)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if causal and q_offset:
        return 4.0 * B * H * D * (Sq * q_offset + Sq * Sq / 2)
    f = 4.0 * B * H * Sq * Sk * D
    return f / 2 if causal else f
