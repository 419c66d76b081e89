"""Random weights made by the benchmark from the seed, on the device.

The program declares its parameter tree as specs (shape, initialiser,
standard deviation, dtype). The benchmark draws every normally distributed
leaf from ONE ``torch.randn`` call of a generator on the device seeded
from ``--seed``, cuts the leaves out of it as views, and scales each in
place; the constant leaves (norm scales, the SSM's ``A_log``, ``D``,
``dt_bias``) are filled. The same tensors go to the program and to the
reference.
"""
from __future__ import annotations

import math

import torch


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _std(spec) -> float:
    """The leaf's standard deviation: its own, else 0.02 for an embedding
    and 1/sqrt(fan-in) for a weight (fan-in: every dim but the last)."""
    if spec.scale is not None:
        return float(spec.scale)
    if spec.init == "embed":
        return 0.02
    fan_in = math.prod(spec.shape[:-1]) if len(spec.shape) > 1 else \
        spec.shape[0]
    return 1.0 / math.sqrt(max(fan_in, 1))


def make_params(specs, seed: int, device) -> dict:
    """The parameter tree of ``specs`` drawn from ``seed`` on ``device``."""
    leaves = list(_leaves(specs))
    drawn = [(p, s) for p, s in leaves if s.init not in ("zeros", "ones")]
    total = sum(math.prod(s.shape) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    out: dict = {}
    at = 0
    for path, spec in leaves:
        if spec.init in ("zeros", "ones"):
            t = torch.full(spec.shape, 0.0 if spec.init == "zeros" else 1.0,
                           dtype=spec.dtype, device=device)
        else:
            n = math.prod(spec.shape)
            t = flat[at:at + n].view(spec.shape).mul_(_std(spec))
            at += n
            if spec.dtype != torch.float32:
                t = t.to(spec.dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out
