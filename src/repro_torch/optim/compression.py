"""Int8 error-feedback gradient compression for the data-parallel
reduction (counterpart of ``repro.optim.compression``).

Gradients are quantized to int8 with a per-tensor scale (8x fewer wire
bytes on the gradient traffic); the quantization error is carried forward
and added to the next step's gradient (error feedback, Seide et al. /
Karimireddy et al.) so the scheme stays convergent.  On one device there is
no reduction: ``compress_grads`` models the quantize -> (wire) ->
dequantize round trip and the error feedback, as the reference does.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import spec_map


def quantize(g):
    """g -> (int8 q, f32 scale); symmetric per-tensor."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def init_error(params):
    """Zero float32 error residuals shaped as the parameters."""
    return spec_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _pair_map(fn, a, b):
    if isinstance(a, dict):
        outs = {k: _pair_map(fn, a[k], b[k]) for k in a}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    return fn(a, b)


@torch.no_grad()
def compress_grads(grads, error):
    """Returns (compressed-and-restored grads, new error)."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = quantize(g32)
        deq = dequantize(q, scale)
        return deq, g32 - deq
    return _pair_map(one, grads, error)
