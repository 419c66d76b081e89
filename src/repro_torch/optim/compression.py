"""Int8 error-feedback gradient compression for the data-parallel
reduction (counterpart of ``repro.optim.compression``).

Gradients are quantized to int8 with a per-tensor scale (8x fewer wire
bytes on the gradient traffic); the quantization error is carried forward
and added to the next step's gradient (error feedback, Seide et al. /
Karimireddy et al.) so the scheme stays convergent.  On one device there is
no reduction: ``compress_grads`` models the quantize -> (wire) ->
dequantize round trip and the error feedback, as the reference does.
``torch.round`` rounds half to even, as ``jnp.round`` does.  On a mesh
each rank compresses the blocks it holds of the reduced gradient, with the
scale of the whole leaf (the reference quantizes the global array): the
max over each block is maxed over the axes the leaf is split on.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import spec_map, tree_leaves, tree_unflatten


def quantize(g, amax=None):
    """g -> (int8 q, f32 scale); symmetric per-tensor (``amax``: the
    tensor's largest magnitude, where ``g`` is a block of it)."""
    amax = torch.max(torch.abs(g)) if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
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
def compress_grads(grads, error, ctx=None, split=None):
    """Returns (compressed-and-restored grads, new error).  On a mesh
    (``ctx``) the leaves are blocks and ``split[i]`` the mesh axes leaf i
    (in ``tree_leaves`` order) is split on."""
    g32 = _pair_map(lambda g, e: (g.to(torch.float32) + e, None), grads,
                    error)[0]
    amax = [torch.max(torch.abs(g)) for g in tree_leaves(g32)]
    if ctx is not None:
        amax = ctx.all_reduce_each(amax, split, "max")

    def one(g, m):
        q, scale = quantize(g, m)
        deq = dequantize(q, scale)
        return deq, g - deq
    return _pair_map(one, g32, tree_unflatten(g32, amax))
