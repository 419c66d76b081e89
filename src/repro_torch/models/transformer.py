"""Decoder-only LM for the dense, vlm (early-fusion) and moe families
(counterpart of ``repro.models.transformer``: ``hidden_states`` and
``loss`` for training, ``prefill`` and ``decode_step`` for serving).

Block parameters are stacked ``(L, ...)`` as in the reference; where the
reference scans over the stack, the port loops over its layers (in
training each layer under ``remat_wrap``).  The moe branch replaces a
layer's MLP with ``models.moe.moe_layer`` (arctic, deepseek), whose aux
loss training averages over the layers; the mla branch replaces its
attention with DeepSeek-V2's latent attention (``models.mla``), whose
cache is the compressed ``c`` and ``k_rope``.  Training runs the plain
attention (``gqa_attention``, ``mla_attention``) whatever
``Variant.use_pallas`` says, as the reference's does.

``Variant.use_pallas`` keeps the reference's meaning: the prefill's causal
attention goes through the hand-written flash-attention kernel, one launch
a layer (mla: q/k of 192 dims against v of 128, the kernel's (192, 128)
instance); without it, through ``chunked_attention``, the port of the
reference's default path.  Decode stays plain PyTorch, as the reference
computes it outside any Pallas kernel.

``ctx`` (sharding), in training and serving alike: the parameters are
held as ``registry.held_axes`` blocks, and each layer gathers its leaves
over the fsdp axes at use, keeping their ``model`` blocks
(``sharding.gather_tree(..., keep=("model",))``; in training inside the
layer's remat region, so the gathered copies die with the layer and are
gathered again for the recompute).  A layer then computes on the rank's
share (``sharding.tp_plan``): the attention on its heads, the MLP on its
ffn block, each ended by one reduction over ``model``; the head is
vocabulary parallel.  With sequence parallelism the residual stream
between layers is this rank's block of the sequence, all-gathered before
the attention, the MLP and ``moe_layer`` (which gathers its experts over
the fsdp axes itself and runs expert parallel; its output is all-reduced,
and the rank keeps its block), reduce-scattered after the row splits, and
gathered again before the final norm's logits.  The tokens are this
rank's block of the batch over the data axes; on a mesh the prefill's
cache is the rank's block (its KV heads).  Where the query heads do not
divide over ``model`` (phi3's 40 and arctic's 56 over 16), the attention
splits its queries' sequence instead (``sharding.Heads.seq``: every head
of the rank's block of positions, the flash kernel's ``q_offset`` in the
prefill), and the cache is the whole sequence's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.distributed.sharding import (NO_TP, TP_AXIS, gather_tree,
                                              tp_plan)
from repro_torch.models.common import (apply_mlp, apply_norm,
                                       chunked_softmax_xent, embed_lookup,
                                       embed_specs, head_params, lm_logits,
                                       mlp_specs, norm_specs, stack_specs,
                                       tree_index, tree_stack, tree_unbind)
from repro_torch.models.variant import BASELINE, Variant, remat_wrap
from repro_torch.obs import trace


class DecoderLM:
    def __init__(self, cfg):
        self.cfg = cfg
        self.is_moe = cfg.moe is not None
        self.is_mla = cfg.mla is not None
        # one layer's leaves as the model gathers them (the experts: no)
        self.layer_specs = self.block_specs()
        if self.is_moe:
            self.layer_specs["moe"] = moe_mod.gathered_at_layer(
                self.layer_specs["moe"])

    # -- parameters ----------------------------------------------------------
    def block_specs(self) -> dict:
        cfg = self.cfg
        block = {
            "ln1": norm_specs(cfg, cfg.d_model),
            "attn": (mla_mod.mla_specs(cfg) if self.is_mla
                     else attn.gqa_specs(cfg, cfg.d_model)),
            "ln2": norm_specs(cfg, cfg.d_model),
        }
        if self.is_moe:
            block["moe"] = moe_mod.moe_specs(cfg)
        else:
            block["mlp"] = mlp_specs(cfg, cfg.d_model, cfg.d_ff)
        return block

    def param_specs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "blocks": stack_specs(self.block_specs(), cfg.n_layers),
            "ln_f": norm_specs(cfg, cfg.d_model),
        }

    def _moe(self, p, h, variant: Variant, ctx=None, tp=NO_TP):
        """The layer's MoE of the residual block ``h``: (output block, aux
        loss); ``moe_layer`` takes the whole sequence."""
        y, aux = moe_mod.moe_layer(
            ctx, self.cfg, p["moe"], tp.gather_seq(h),
            capacity_factor=variant.moe_capacity_factor,
            psum_dtype=variant.psum_dtype)
        return tp.scatter_seq(y), aux

    def _ffn(self, p, h, variant: Variant, ctx=None, tp=NO_TP):
        """The layer's MLP, or its MoE (whose aux loss serving drops)."""
        if self.is_moe:
            return self._moe(p, h, variant, ctx, tp)[0]
        return apply_mlp(self.cfg, p["mlp"], h, tp)

    def _layer(self, ctx, p):
        return gather_tree(ctx, p, self.layer_specs, keep=(TP_AXIS,))

    # -- training ------------------------------------------------------------
    def _block(self, p, x, variant: Variant, positions, ctx=None, tp=NO_TP):
        """One layer for training: (x after the layer, its aux loss)."""
        cfg = self.cfg
        p = self._layer(ctx, p)
        h = apply_norm(cfg, p["ln1"], x)
        if self.is_mla:
            a = mla_mod.mla_attention(cfg, p["attn"], h, positions=positions,
                                      kv_block=variant.kv_block,
                                      variant=variant.attn_variant, tp=tp)
        else:
            a = attn.gqa_attention(cfg, p["attn"], h, causal=True,
                                   positions=positions,
                                   kv_block=variant.kv_block,
                                   variant=variant.attn_variant, tp=tp)
        x = x + a
        h = apply_norm(cfg, p["ln2"], x)
        if self.is_moe:
            y, aux = self._moe(p, h, variant, ctx, tp)
        else:
            y = apply_mlp(cfg, p["mlp"], h, tp)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + y, aux

    def hidden_states(self, params, tokens, ctx=None,
                      variant: Variant = BASELINE):
        """tokens (B, S) -> (final hidden states (B, S, D) bf16, whole, the
        aux loss averaged over the layers)."""
        cfg = self.cfg
        B, S = tokens.shape
        tp = tp_plan(ctx, S)
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        positions = torch.arange(S, device=tokens.device)
        block = remat_wrap(
            lambda p, x: self._block(p, x, variant, positions, ctx, tp),
            variant)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for p in tree_unbind(params["blocks"]):
            x, a = block(p, x)
            aux = aux + a
        x = apply_norm(cfg, self._ln_f(ctx, params), x)
        return tp.gather_seq(x), aux / cfg.n_layers

    def _ln_f(self, ctx, params):
        return gather_tree(ctx, params["ln_f"],
                           norm_specs(self.cfg, self.cfg.d_model))

    def loss(self, params, batch, ctx=None, variant: Variant = BASELINE):
        """(mean token cross-entropy, plus the weighted aux loss for moe;
        {"xent", "aux"})."""
        cfg = self.cfg
        h, aux = self.hidden_states(params, batch["tokens"], ctx, variant)
        xent = chunked_softmax_xent(cfg, head_params(ctx, cfg,
                                                     params["embed"]),
                                    h, batch["labels"],
                                    chunk=variant.xent_chunk,
                                    tp=tp_plan(ctx, h.shape[1]))
        loss = xent
        if self.is_moe:
            loss = loss + cfg.moe.aux_loss_weight * aux
        return loss, {"xent": xent, "aux": aux}

    # -- serving -------------------------------------------------------------
    def cache_shapes(self, batch: int, seq_len: int) -> dict:
        """Per-layer cache entries, name -> (shape, logical axes, dtype)
        (stacked over layers by the registry): k/v, or mla's compressed c
        and k_rope."""
        cfg = self.cfg
        if self.is_mla:
            m = cfg.mla
            return {"c": ((batch, seq_len, m.kv_lora_rank),
                          ("batch", "kv_seq", None), torch.bfloat16),
                    "k_rope": ((batch, seq_len, m.rope_head_dim),
                               ("batch", "kv_seq", None), torch.bfloat16)}
        kv = ((batch, seq_len, cfg.n_kv_heads, cfg.resolved_head_dim),
              ("batch", "kv_seq", "kv_heads", None), torch.bfloat16)
        return {"k": kv, "v": kv}

    def prefill(self, params, tokens, ctx=None, variant: Variant = BASELINE):
        """tokens (B, S) -> (logits of the last position (B, V_padded) f32,
        cache {"k"/"v": (L, B, S, KV, hd)} or, mla, {"c": (L, B, S,
        kv_lora), "k_rope": (L, B, S, rope)}, bf16; on a mesh the rank's
        KV heads).  Spans (``obs.trace``, on while tracing or a torch
        profiler records): ``prefill`` around the call, and a layer's
        ``prefill.attn`` and ``prefill.mlp``, each holding its norm, its
        sublayer and its residual add, so that every operation of a layer
        falls under exactly one of the two."""
        with trace.span("prefill", cat="model"):
            return self._prefill(params, tokens, ctx, variant)

    def _prefill(self, params, tokens, ctx, variant: Variant):
        cfg = self.cfg
        B, S = tokens.shape
        tp = tp_plan(ctx, S)
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        positions = torch.arange(S, device=tokens.device)
        inv_freq = (mla_mod.mla_rope_freqs(cfg, tokens.device) if self.is_mla
                    else attn.rope_freqs(cfg.resolved_head_dim, cfg.rope_pct,
                                         cfg.rope_theta,
                                         device=tokens.device))
        caches = []
        for layer in range(cfg.n_layers):
            p = self._layer(ctx, tree_index(params["blocks"], layer))
            with trace.span("prefill.attn", cat="model"):
                h = apply_norm(cfg, p["ln1"], x)
                if self.is_mla:
                    q, k, v, c, kr = mla_mod.mla_expand(cfg, p["attn"],
                                                        tp.gather_seq(h),
                                                        positions, inv_freq)
                    entry = {"c": c.to(torch.bfloat16),
                             "k_rope": kr.to(torch.bfloat16)}
                    if variant.use_pallas:
                        o = fa_ops.flash(q, k, v, causal=True)
                    else:
                        o = attn.chunked_attention(
                            q, k, v, causal=True,
                            kv_block=min(variant.kv_block, S))
                    a = attn.out_proj(o, p["attn"]["wo"], tp,
                                      q.shape[2] < cfg.n_heads, x.dtype)
                else:
                    a, entry = attn.gqa_prefill(
                        cfg, p["attn"], h, positions, inv_freq, tp=tp,
                        use_pallas=variant.use_pallas,
                        kv_block=variant.kv_block, dtype=x.dtype)
                x = x + a
            with trace.span("prefill.mlp", cat="model"):
                x = x + self._ffn(p, apply_norm(cfg, p["ln2"], x), variant,
                                  ctx, tp)
            caches.append(entry)
        x = apply_norm(cfg, self._ln_f(ctx, params),
                       tp.gather_seq(x)[:, -1:, :])
        return (lm_logits(cfg, head_params(ctx, cfg, params["embed"]), x,
                          tp)[:, 0], tree_stack(caches))

    def decode_step(self, params, cache, tokens, pos: int, ctx=None,
                    variant: Variant = BASELINE):
        """tokens (B, 1) at position ``pos`` -> (logits (B, 1, V_padded) f32,
        cache).  The cache's tensors are updated in place (the reference
        returns a new cache; in place saves a copy of it per token), and the
        same dict is returned."""
        cfg = self.cfg
        tp = tp_plan(ctx, 1)
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        for layer in range(cfg.n_layers):
            p = self._layer(ctx, tree_index(params["blocks"], layer))
            h = apply_norm(cfg, p["ln1"], x)
            if self.is_mla:
                a, _, _ = mla_mod.mla_decode(cfg, p["attn"], h,
                                             cache["c"][layer],
                                             cache["k_rope"][layer], pos, tp)
            else:
                a, _, _ = attn.gqa_decode(cfg, p["attn"], h,
                                          cache["k"][layer],
                                          cache["v"][layer], pos, tp)
            x = x + a
            x = x + self._ffn(p, apply_norm(cfg, p["ln2"], x), variant, ctx,
                              tp)
        x = apply_norm(cfg, self._ln_f(ctx, params), x)
        return lm_logits(cfg, head_params(ctx, cfg, params["embed"]), x,
                         tp), cache
