"""Analytic per-device HBM traffic model (counterpart of
``repro.roofline.model_bytes``, kept as the port's own copy: plain
arithmetic over the configs, equal to the reference's to the last bit).

A cost model that sums operand bytes of every op with no fusion counts the
flash attention's score blocks, which never leave on-chip memory, as HBM
round trips, and overstates the memory term by orders of magnitude.  The
roofline's memory term therefore uses this analytic model (weights +
optimizer state + residual/projection activations + caches + logit chunks,
all at their *sharded* per-device sizes).
"""
from __future__ import annotations

from repro_torch.configs import ArchConfig, ShapeConfig, param_count
from repro_torch.models.common import vocab_padded


def analytic_bytes(cfg: ArchConfig, shape: ShapeConfig, n_devices: int,
                   tp: int, dp: int, cache_bytes_per_elem: int = 2,
                   train_passes: int = 3) -> float:
    """Per-device HBM bytes for one step (train: fwd+bwd+recompute+opt)."""
    P_total, P_active = param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    Vp = vocab_padded(cfg)
    L = max(cfg.n_layers, 1)

    # per-device activation shard factor: batch over dp, seq over tp
    act_shard = max(dp, 1) * max(tp, 1)

    def act_bytes_per_layer():
        """bf16 tensors that cross HBM per layer (block inputs/outputs +
        projection results); attention/FFN inner temps stay on-chip."""
        hd = cfg.resolved_head_dim
        width = 2 * D                       # residual in + out
        if cfg.family in ("dense", "vlm", "moe", "encdec", "hybrid") and cfg.n_heads:
            width += (cfg.n_heads + 2 * cfg.n_kv_heads + cfg.n_heads) * hd  # qkv+o
        if cfg.family in ("ssm", "hybrid") and cfg.ssm:
            d_in = cfg.ssm.expand * D
            width += 3 * d_in               # z, x, y streams
        if cfg.moe:
            width += 2 * cfg.moe.top_k * D  # dispatch/combine gathers
        elif cfg.d_ff:
            width += 3 * cfg.d_ff           # gate/up/down intermediates
        return B * S * width * 2 / act_shard

    if shape.kind == "train":
        # weights: fwd + bwd (+ remat recompute) reads (bf16, tp-sharded) +
        # optimizer p/m/v rw (fully sharded)
        w = train_passes * P_total * 2 / max(tp, 1)
        opt = 28.0 * P_total / n_devices
        acts = train_passes * L * act_bytes_per_layer()
        logits = 3 * B * S * Vp * 4 / act_shard       # xent chunks f32 (r+w+bwd)
        return w + opt + acts + logits
    if shape.kind == "prefill":
        w = P_total * 2 / max(tp, 1)
        acts = L * act_bytes_per_layer()
        cache_w = _cache_bytes(cfg, B, S) / n_devices
        return w + acts + cache_w
    # decode: read all (active) params + read-modify-write cache + logits
    w = P_active * 2 / max(tp, 1)
    scale = cache_bytes_per_elem / 2.0                # fp8 halves KV bytes
    cache = 2 * scale * _cache_bytes(cfg, B, S) / n_devices
    logits = B * 1 * Vp * 4 / n_devices
    return w + cache + logits


def _cache_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    """Global cache bytes (bf16 KV / f32 SSM state)."""
    hd = cfg.resolved_head_dim
    if cfg.mla:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        return B * S * cfg.n_layers * per_tok * 2.0
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        H = d_in // s.head_dim
        return cfg.n_layers * B * (H * s.head_dim * s.d_state * 4.0
                                   + 3 * s.conv_width * d_in * 2.0)
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        H = d_in // s.head_dim
        ssm = cfg.n_layers * B * (H * s.head_dim * s.d_state * 4.0
                                  + 3 * s.conv_width * d_in * 2.0)
        n_sites = cfg.n_layers // cfg.attn_every
        kv = n_sites * B * S * 2 * cfg.n_kv_heads * hd * 2.0
        return ssm + kv
    if cfg.family == "encdec":
        self_kv = cfg.n_layers * B * S * 2 * cfg.n_kv_heads * hd * 2.0
        cross = cfg.n_layers * B * cfg.n_audio_ctx * 2 * cfg.n_kv_heads * hd * 2.0
        return self_kv + cross
    return cfg.n_layers * B * S * 2 * cfg.n_kv_heads * hd * 2.0
