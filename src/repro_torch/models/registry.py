"""Model registry (counterpart of ``repro.models.registry``).

``build(cfg)`` returns a model object exposing ``param_specs()``,
``cache_shapes(batch, seq_len)``, ``prefill(params, <tokens|batch>, ctx,
variant)`` and ``decode_step(params, cache, tokens, pos, ctx, variant)``,
for every family the reference registers: ``DecoderLM`` (dense, vlm, moe),
``SSMLM`` (ssm), ``HybridLM`` (hybrid) and ``EncDecLM`` (encdec, whose
prefill takes the batch with its ``frames``).  ``make_batch`` and
``init_cache`` make concrete tensors on an explicit device.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.transformer import DecoderLM


def build(cfg: ArchConfig):
    if cfg.family in ("dense", "vlm", "moe"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return SSMLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    raise ValueError(cfg.family)


def make_batch(cfg: ArchConfig, shape, generator: torch.Generator) -> dict:
    """Concrete random batch of ``shape`` = (B, S), drawn from ``generator``
    on its device: ``tokens``, ``labels`` (tokens shifted by one, as in the
    reference) and, for encdec, the frame embeddings ``frames`` (B,
    n_audio_ctx, d_model), bfloat16 normal x 0.02 as the reference draws
    them."""
    B, S = shape
    dev = generator.device
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=generator,
                           device=dev, dtype=torch.int64)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (B, cfg.n_audio_ctx, cfg.d_model), generator=generator,
            device=dev).to(torch.bfloat16) * 0.02
    return batch


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
