"""Model registry (counterpart of ``repro.models.registry``).

``build(cfg)`` returns a model object exposing ``param_specs()``,
``prefill(params, tokens, ctx, variant)`` and ``decode_step(params, cache,
tokens, pos, ctx, variant)``.  The port builds the hybrid family
(``zamba2-2.7b``) and the dense and vlm families (``DecoderLM``); the
ssm, moe and encdec families raise until they are ported (ROADMAP Queue A
4-6).  ``make_batch`` and ``init_cache`` make concrete tensors on an
explicit device.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import DecoderLM

#: the families still to port, and where ROADMAP Queue A has them
NOT_PORTED = {"ssm": "Queue A 4", "moe": "Queue A 5", "encdec": "Queue A 6"}


def build(cfg: ArchConfig):
    if cfg.family in ("dense", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} model family is not ported yet "
            f"(ROADMAP {NOT_PORTED[cfg.family]}); the port builds the "
            f"dense, vlm and hybrid families")
    raise ValueError(cfg.family)


def make_batch(cfg: ArchConfig, shape, generator: torch.Generator) -> dict:
    """Concrete random batch ``{"tokens", "labels"}`` of ``shape`` = (B, S),
    drawn from ``generator`` on its device (labels = tokens shifted by one,
    as in the reference)."""
    B, S = shape
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=generator,
                           device=generator.device, dtype=torch.int64)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


def cache_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The reference's ``cache_abstract`` as concrete (shape, dtype) pairs:
    for the hybrid, SSM caches stacked (sites, group, ...) and KV caches
    (sites, ...); for the others, every entry stacked (n_layers, ...)."""
    model = build(cfg)
    shapes = model.cache_shapes(batch, seq_len)
    if cfg.family != "hybrid":
        return {k: ((cfg.n_layers,) + shp, dt)
                for k, (shp, dt) in shapes.items()}
    n_sites, group = model.n_sites, cfg.attn_every
    out: dict = {"ssm": {k: ((n_sites, group) + shp, dt)
                         for k, (shp, dt) in shapes["ssm"].items()}}
    for k in ("k", "v"):
        shp, dt = shapes[k]
        out[k] = ((n_sites,) + shp, dt)
    return out


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device) -> dict:
    """Concrete zero-filled cache on ``device``."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        shp, dt = tree
        return torch.zeros(shp, dtype=dt, device=device)
    return zeros(cache_shapes(cfg, batch, seq_len))
