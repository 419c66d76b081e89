"""Decoder-only LM for the dense and vlm (early-fusion) families
(counterpart of ``repro.models.transformer``: the serving half,
``prefill`` and ``decode_step``).

Block parameters are stacked ``(L, ...)`` as in the reference; where the
reference scans over the stack, the port loops over its layers.  The moe
and mla branches of the reference's ``DecoderLM`` are not ported: a config
with ``moe`` or ``mla`` raises (ROADMAP Queue A 5).  ``hidden_states`` and
``loss`` are training-side (Queue A 7).

``Variant.use_pallas`` keeps the reference's meaning: the prefill's causal
attention goes through the hand-written flash-attention kernel, one launch
a layer; without it, through ``chunked_attention``, the port of the
reference's default path.  Decode stays plain PyTorch, as the reference
computes it outside any Pallas kernel.  ``ctx`` (sharding) is accepted and
ignored.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_mlp, apply_norm, embed_specs,
                                       embed_tokens, lm_logits, mlp_specs,
                                       norm_specs, stack_specs, tree_index,
                                       tree_stack)
from repro_torch.models.variant import BASELINE, Variant


class DecoderLM:
    def __init__(self, cfg):
        if cfg.moe is not None or cfg.mla is not None:
            raise NotImplementedError(
                f"{cfg.name}: the moe and mla branches of DecoderLM are not "
                f"ported yet (ROADMAP Queue A 5)")
        self.cfg = cfg

    # -- parameters ----------------------------------------------------------
    def block_specs(self) -> dict:
        cfg = self.cfg
        return {
            "ln1": norm_specs(cfg, cfg.d_model),
            "attn": attn.gqa_specs(cfg, cfg.d_model),
            "ln2": norm_specs(cfg, cfg.d_model),
            "mlp": mlp_specs(cfg, cfg.d_model, cfg.d_ff),
        }

    def param_specs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "blocks": stack_specs(self.block_specs(), cfg.n_layers),
            "ln_f": norm_specs(cfg, cfg.d_model),
        }

    # -- serving -------------------------------------------------------------
    def cache_shapes(self, batch: int, seq_len: int) -> dict:
        """Per-layer cache entries, name -> (shape, dtype) (stacked over
        layers by the registry)."""
        cfg = self.cfg
        kv = ((batch, seq_len, cfg.n_kv_heads, cfg.resolved_head_dim),
              torch.bfloat16)
        return {"k": kv, "v": kv}

    def prefill(self, params, tokens, ctx=None, variant: Variant = BASELINE):
        """tokens (B, S) -> (logits of the last position (B, V_padded) f32,
        cache {"k"/"v": (L, B, S, KV, hd) bf16})."""
        cfg = self.cfg
        B, S = tokens.shape
        x = embed_tokens(params["embed"], tokens)
        positions = torch.arange(S, device=tokens.device)
        inv_freq = attn.rope_freqs(cfg.resolved_head_dim, cfg.rope_pct,
                                   cfg.rope_theta, device=tokens.device)
        caches = []
        for layer in range(cfg.n_layers):
            p = tree_index(params["blocks"], layer)
            h = apply_norm(cfg, p["ln1"], x)
            q, k, v = attn.gqa_project_qkv(cfg, p["attn"], h, positions,
                                           inv_freq)
            if variant.use_pallas:
                o = fa_ops.flash(q, k, v, causal=True)
            else:
                o = attn.chunked_attention(q, k, v, causal=True,
                                           kv_block=min(variant.kv_block, S))
            x = x + attn.out_proj(o, p["attn"]["wo"]).to(x.dtype)
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
            caches.append({"k": k.to(torch.bfloat16),
                           "v": v.to(torch.bfloat16)})
        x = apply_norm(cfg, params["ln_f"], x[:, -1:, :])
        return lm_logits(cfg, params["embed"], x)[:, 0], tree_stack(caches)

    def decode_step(self, params, cache, tokens, pos: int, ctx=None,
                    variant: Variant = BASELINE):
        """tokens (B, 1) at position ``pos`` -> (logits (B, 1, V_padded) f32,
        cache).  The cache's tensors are updated in place (the reference
        returns a new cache; in place saves a copy of it per token), and the
        same dict is returned."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens)
        for layer in range(cfg.n_layers):
            p = tree_index(params["blocks"], layer)
            h = apply_norm(cfg, p["ln1"], x)
            a, _, _ = attn.gqa_decode(cfg, p["attn"], h, cache["k"][layer],
                                      cache["v"][layer], pos)
            x = x + a
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        x = apply_norm(cfg, params["ln_f"], x)
        return lm_logits(cfg, params["embed"], x), cache
