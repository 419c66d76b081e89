"""Whisper-style encoder-decoder (counterpart of ``repro.models.encdec``:
``encode``; ``hidden_states`` and ``loss`` for training; ``prefill`` and
``decode_step`` for serving).

The audio frontend (conv1d stack + log-mel) is a stub, as in the reference:
the batch carries precomputed frame embeddings ``frames`` (B, n_audio_ctx,
d_model).  Positions are sinusoidal, no RoPE.  Block parameters are stacked
``(L, ...)``; where the reference scans, the port loops.

``Variant.use_pallas`` keeps the reference's meaning: the encoder's
non-causal self-attention (``n_audio_ctx`` = 1500 frames), the prefill's
causal self-attention and its cross-attention (prompt queries against the
1500 encoder frames) go through the hand-written flash-attention kernel, a
launch each a layer; without it, through ``chunked_attention``.  1500 is
not a multiple of the flash wrapper's default block of 256, and the
reference's block rule (``Sq % q_block == 0``, ``Sk % kv_block == 0``)
allows a block that spans the whole sequence: the kernel route passes the
sequence length as the block wherever 256 does not divide it (the CUDA
kernel tiles by 64 whatever the blocks, and masks the ragged tail).
Training (``loss``) takes the plain route whatever ``use_pallas`` says,
every encoder and decoder layer under ``remat_wrap``.  Decode
stays plain PyTorch, its cross-attention against the cached ``xk``/``xv``
as the reference computes it.  ``ctx`` (sharding): the parameters are
held as ``registry.held_axes`` blocks, and each encoder and decoder layer,
the final norms, the embedding and the head are gathered over the fsdp
axes at use, keeping their ``model`` blocks (``sharding.gather_tree``, in
training inside each layer's remat region).  Each attention (the
encoder's, the decoder's self- and cross-attention) runs on the rank's
heads and each MLP on its ffn block, each ended by one reduction over
``model`` (``sharding.tp_plan``: the encoder's plan over the frames, the
decoder's over the tokens; with sequence parallelism the residual stream
is the rank's block of the sequence); the cross-attention's keys and
values come from the encoder's output, which every ``model`` rank holds
whole, through the rank's ``wk`` / ``wv`` blocks; the head is vocabulary
parallel, and the prefill's cache is the rank's KV heads.  The tokens and
frames are this rank's block of the batch.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn
from repro_torch.distributed.sharding import (NO_TP, TP_AXIS, gather_tree,
                                              tp_plan)
from repro_torch.models.common import (apply_mlp, apply_norm, cast_compute,
                                       chunked_softmax_xent, embed_lookup,
                                       embed_specs, head_params, lm_logits,
                                       mlp_specs, norm_specs, stack_specs,
                                       tree_index, tree_stack, tree_unbind)
from repro_torch.models.variant import BASELINE, Variant, remat_wrap

#: the flash wrapper's default block (``flash_attention`` q/kv blocks)
FLASH_BLOCK = 256


def sinusoid(S: int, D: int, offset: int = 0, device=None):
    """(S, D) float32 sinusoidal positions from ``offset``: sin on the even
    columns, cos on the odd ones."""
    pos = (torch.arange(S, device=device)[:, None] + offset).to(torch.float32)
    dim = torch.arange(0, D, 2, device=device)[None, :].to(torch.float32)
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / D)
    emb = torch.zeros((S, D), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(ang)
    emb[:, 1::2] = torch.cos(ang[:, : (D + 1) // 2])
    return emb


def flash_block(n: int) -> int:
    """The flash block for a sequence of ``n``: the wrapper's 256 where it
    divides n, else the whole sequence (the reference's rule allows it)."""
    return FLASH_BLOCK if n % FLASH_BLOCK == 0 else n


def attend(q, k, v, *, causal: bool, variant: Variant):
    """Attention on the route ``variant`` names: the flash kernel (blocks by
    ``flash_block``) or ``chunked_attention``."""
    if variant.use_pallas:
        return fa_ops.flash(q, k, v, causal=causal,
                            q_block=flash_block(q.shape[1]),
                            kv_block=flash_block(k.shape[1]))
    return attn.chunked_attention(q, k, v, causal=causal,
                                  kv_block=min(variant.kv_block, k.shape[1]))


def _attend_out(cfg, p, tp, q, k, v, *, causal: bool, variant: Variant,
                dtype):
    """The rank's heads of ``q`` against its KV heads ``k`` / ``v``, then
    ``wo``'s block and the reduction over ``model``."""
    heads = tp.heads(cfg.n_heads, cfg.n_kv_heads)
    k, v = heads.for_attention(k, v)
    o = attend(q, k, v, causal=causal, variant=variant)
    return attn.out_proj(o, p["wo"], tp, heads.split, dtype)


class EncDecLM:
    def __init__(self, cfg):
        self.cfg = cfg
        # one encoder / decoder layer's specs, and a final norm's
        self.enc_specs = {
            "ln1": norm_specs(cfg, cfg.d_model),
            "attn": attn.gqa_specs(cfg, cfg.d_model),
            "ln2": norm_specs(cfg, cfg.d_model),
            "mlp": mlp_specs(cfg, cfg.d_model, cfg.d_ff),
        }
        self.dec_specs = {
            "ln1": norm_specs(cfg, cfg.d_model),
            "self_attn": attn.gqa_specs(cfg, cfg.d_model),
            "ln_x": norm_specs(cfg, cfg.d_model),
            "cross_attn": attn.gqa_specs(cfg, cfg.d_model),
            "ln2": norm_specs(cfg, cfg.d_model),
            "mlp": mlp_specs(cfg, cfg.d_model, cfg.d_ff),
        }
        self.final_norm_specs = norm_specs(cfg, cfg.d_model)

    # -- parameters ----------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "enc_blocks": stack_specs(self.enc_specs, cfg.n_encoder_layers),
            "enc_ln_f": norm_specs(cfg, cfg.d_model),
            "dec_blocks": stack_specs(self.dec_specs, cfg.n_layers),
            "ln_f": norm_specs(cfg, cfg.d_model),
        }

    def _norm(self, ctx, p):
        return gather_tree(ctx, p, self.final_norm_specs)

    def _layer(self, ctx, p, specs):
        return gather_tree(ctx, p, specs, keep=(TP_AXIS,))

    # -- encoder -------------------------------------------------------------
    def encode(self, params, frames, ctx=None, variant: Variant = BASELINE):
        """frames: (B, A, D) precomputed frame embeddings (frontend stub)
        -> (B, A, D) bf16, whole."""
        cfg = self.cfg
        B, A, D = frames.shape
        tp = tp_plan(ctx, A)
        x = tp.scatter_seq(cast_compute(frames)
                           + sinusoid(A, D, device=frames.device)[None]
                           .to(torch.bfloat16))
        positions = torch.arange(A, device=frames.device)

        def body(p, x):
            p = self._layer(ctx, p, self.enc_specs)
            h = tp.gather_seq(apply_norm(cfg, p["ln1"], x))
            q, k, v = attn.gqa_project_qkv(cfg, p["attn"], h, positions, None)
            x = x + _attend_out(cfg, p["attn"], tp, q, k, v, causal=False,
                                variant=variant, dtype=x.dtype)
            return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x),
                                 tp)

        body = remat_wrap(body, variant)
        for p in tree_unbind(params["enc_blocks"]):
            x = body(p, x)
        return tp.gather_seq(apply_norm(cfg, self._norm(ctx,
                                                        params["enc_ln_f"]),
                                        x))

    # -- decoder (teacher-forced train) -----------------------------------------
    def _cross(self, p, h, enc_out, positions, tp, variant, dtype):
        """The cross-attention of the residual block ``h`` (already
        normalised) against the whole ``enc_out``: (its output, the
        rank's xk, xv)."""
        cfg = self.cfg
        q, _, _ = attn.gqa_project_qkv(cfg, p, tp.gather_seq(h), positions,
                                       None)
        enc = cast_compute(enc_out)
        xk = attn._proj_heads(enc, p["wk"])
        xv = attn._proj_heads(enc, p["wv"])
        return _attend_out(cfg, p, tp, q, xk, xv, causal=False,
                           variant=variant, dtype=dtype), xk, xv

    def _dec_block(self, p, x, enc_out, variant, positions, ctx=None,
                   tp=NO_TP):
        cfg = self.cfg
        p = self._layer(ctx, p, self.dec_specs)
        h = apply_norm(cfg, p["ln1"], x)
        x = x + attn.gqa_attention(cfg, p["self_attn"], h, causal=True,
                                   positions=positions,
                                   kv_block=variant.kv_block,
                                   variant=variant.attn_variant, tp=tp)
        # cross attention: q from the decoder, k/v from the encoder output
        x = x + self._cross(p["cross_attn"], apply_norm(cfg, p["ln_x"], x),
                            enc_out, positions, tp,
                            replace(variant, use_pallas=False), x.dtype)[0]
        return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x), tp)

    def _dec_embed(self, ctx, params, tokens, tp, offset: int = 0):
        """The decoder's input: the token embeddings and the sinusoid from
        ``offset``, the rank's sequence block under ``tp``."""
        S = tokens.shape[1]
        x = embed_lookup(ctx, self.cfg, params["embed"], tokens)
        pos = sinusoid(S, self.cfg.d_model, offset=offset,
                       device=tokens.device)[None].to(x.dtype)
        return x + tp.scatter_seq(pos)

    def hidden_states(self, params, tokens, enc_out, ctx=None,
                      variant: Variant = BASELINE):
        """tokens (B, S), the encoder's output (B, A, D) -> the decoder's
        final hidden states (B, S, D) bf16, whole."""
        cfg = self.cfg
        B, S = tokens.shape
        tp = tp_plan(ctx, S)
        x = self._dec_embed(ctx, params, tokens, tp)
        positions = torch.arange(S, device=tokens.device)
        body = remat_wrap(lambda p, x: self._dec_block(p, x, enc_out, variant,
                                                       positions, ctx, tp),
                          variant)
        for p in tree_unbind(params["dec_blocks"]):
            x = body(p, x)
        return tp.gather_seq(apply_norm(cfg, self._norm(ctx, params["ln_f"]),
                                        x))

    def loss(self, params, batch, ctx=None, variant: Variant = BASELINE):
        # training's encoder attention is the plain route: the flash kernel
        # is forward only
        variant = replace(variant, use_pallas=False)
        enc_out = self.encode(params, batch["frames"], ctx, variant)
        h = self.hidden_states(params, batch["tokens"], enc_out, ctx, variant)
        xent = chunked_softmax_xent(
            self.cfg, head_params(ctx, self.cfg, params["embed"]), h,
            batch["labels"], chunk=variant.xent_chunk,
            tp=tp_plan(ctx, h.shape[1]))
        return xent, {"xent": xent}

    # -- serving -------------------------------------------------------------
    def cache_shapes(self, batch: int, seq_len: int) -> dict:
        """Per-layer cache entries, name -> (shape, logical axes, dtype)
        (stacked over the decoder layers by the registry): the
        self-attention's k/v grow with the sequence, the cross-attention's
        xk/xv hold the A encoder frames."""
        cfg = self.cfg
        hd, kv, A = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_audio_ctx
        self_ax = ("batch", "kv_seq", "kv_heads", None)
        cross_ax = ("batch", None, "kv_heads", None)
        return {"k": ((batch, seq_len, kv, hd), self_ax, torch.bfloat16),
                "v": ((batch, seq_len, kv, hd), self_ax, torch.bfloat16),
                "xk": ((batch, A, kv, hd), cross_ax, torch.bfloat16),
                "xv": ((batch, A, kv, hd), cross_ax, torch.bfloat16)}

    def prefill(self, params, batch, ctx=None, variant: Variant = BASELINE):
        """Encode, then the teacher-forced decoder pass over the prompt.
        batch {"tokens" (B, S), "frames" (B, A, D)} -> (logits of the last
        position (B, V_padded) f32, cache {"k"/"v": (L, B, S, KV, hd),
        "xk"/"xv": (L, B, A, KV, hd)} bf16; on a mesh the rank's KV
        heads)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        enc_out = cast_compute(self.encode(params, batch["frames"], ctx,
                                           variant))
        B, S = tokens.shape
        tp = tp_plan(ctx, S)
        x = self._dec_embed(ctx, params, tokens, tp)
        positions = torch.arange(S, device=tokens.device)
        caches = []
        for layer in range(cfg.n_layers):
            p = self._layer(ctx, tree_index(params["dec_blocks"], layer),
                            self.dec_specs)
            h = tp.gather_seq(apply_norm(cfg, p["ln1"], x))
            q, k, v = attn.gqa_project_qkv(cfg, p["self_attn"], h, positions,
                                           None)
            x = x + _attend_out(cfg, p["self_attn"], tp, q, k, v,
                                causal=True, variant=variant, dtype=x.dtype)
            a, xk, xv = self._cross(p["cross_attn"],
                                    apply_norm(cfg, p["ln_x"], x), enc_out,
                                    positions, tp, variant, x.dtype)
            x = x + a
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x), tp)
            caches.append({"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16),
                           "xk": xk.to(torch.bfloat16),
                           "xv": xv.to(torch.bfloat16)})
        x = apply_norm(cfg, self._norm(ctx, params["ln_f"]),
                       tp.gather_seq(x)[:, -1:, :])
        return (lm_logits(cfg, head_params(ctx, cfg, params["embed"]), x,
                          tp)[:, 0], tree_stack(caches))

    def decode_step(self, params, cache, tokens, pos: int, ctx=None,
                    variant: Variant = BASELINE):
        """tokens (B, 1) at position ``pos`` -> (logits (B, 1, V_padded) f32,
        cache).  The self-attention's k/v are updated in place (the
        reference returns a new cache), xk/xv are read only; the same dict
        is returned."""
        cfg = self.cfg
        B = tokens.shape[0]
        dev = tokens.device
        tp = tp_plan(ctx, 1)
        x = self._dec_embed(ctx, params, tokens, tp, offset=pos)
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
        for layer in range(cfg.n_layers):
            p = self._layer(ctx, tree_index(params["dec_blocks"], layer),
                            self.dec_specs)
            h = apply_norm(cfg, p["ln1"], x)
            a, _, _ = attn.gqa_decode(cfg, p["self_attn"], h, cache["k"][layer],
                                      cache["v"][layer], pos, tp)
            x = x + a
            h = apply_norm(cfg, p["ln_x"], x)
            q, _, _ = attn.gqa_project_qkv(cfg, p["cross_attn"], h, positions,
                                           None)
            xk = cache["xk"][layer]
            x = x + _attend_out(cfg, p["cross_attn"], tp, q, xk,
                                cache["xv"][layer], causal=False,
                                variant=replace(variant, use_pallas=False,
                                                kv_block=1024),
                                dtype=x.dtype)
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x), tp)
        x = apply_norm(cfg, self._norm(ctx, params["ln_f"]), x)
        return lm_logits(cfg, head_params(ctx, cfg, params["embed"]), x,
                         tp), cache
