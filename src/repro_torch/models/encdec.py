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
the final norms, the embedding and the head are gathered whole at use
(``sharding.gather_tree``, in training inside each layer's remat region);
the tokens and frames are this rank's block of the batch.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn
from repro_torch.distributed.sharding import gather_tree
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

    # -- encoder -------------------------------------------------------------
    def encode(self, params, frames, ctx=None, variant: Variant = BASELINE):
        """frames: (B, A, D) precomputed frame embeddings (frontend stub)
        -> (B, A, D) bf16."""
        cfg = self.cfg
        B, A, D = frames.shape
        x = cast_compute(frames) + sinusoid(A, D, device=frames.device)[None] \
            .to(torch.bfloat16)
        positions = torch.arange(A, device=frames.device)

        def body(p, x):
            p = gather_tree(ctx, p, self.enc_specs)
            h = apply_norm(cfg, p["ln1"], x)
            q, k, v = attn.gqa_project_qkv(cfg, p["attn"], h, positions, None)
            o = attend(q, k, v, causal=False, variant=variant)
            x = x + attn.out_proj(o, p["attn"]["wo"]).to(x.dtype)
            return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))

        body = remat_wrap(body, variant)
        for p in tree_unbind(params["enc_blocks"]):
            x = body(p, x)
        return apply_norm(cfg, self._norm(ctx, params["enc_ln_f"]), x)

    # -- decoder (teacher-forced train) -----------------------------------------
    def _dec_block(self, p, x, enc_out, variant, positions, ctx=None):
        cfg = self.cfg
        p = gather_tree(ctx, p, self.dec_specs)
        h = apply_norm(cfg, p["ln1"], x)
        x = x + attn.gqa_attention(cfg, p["self_attn"], h, causal=True,
                                   positions=positions,
                                   kv_block=variant.kv_block,
                                   variant=variant.attn_variant)
        h = apply_norm(cfg, p["ln_x"], x)
        # cross attention: q from the decoder, k/v from the encoder output
        q, _, _ = attn.gqa_project_qkv(cfg, p["cross_attn"], h, positions,
                                       None)
        enc = cast_compute(enc_out)
        k = attn._proj_heads(enc, p["cross_attn"]["wk"])
        v = attn._proj_heads(enc, p["cross_attn"]["wv"])
        o = attn.chunked_attention(q, k, v, causal=False,
                                   kv_block=min(variant.kv_block, k.shape[1]))
        x = x + attn.out_proj(o, p["cross_attn"]["wo"]).to(x.dtype)
        return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))

    def hidden_states(self, params, tokens, enc_out, ctx=None,
                      variant: Variant = BASELINE):
        """tokens (B, S), the encoder's output (B, A, D) -> the decoder's
        final hidden states (B, S, D) bf16."""
        cfg = self.cfg
        B, S = tokens.shape
        dev = tokens.device
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        x = x + sinusoid(S, cfg.d_model, device=dev)[None].to(x.dtype)
        positions = torch.arange(S, device=dev)
        body = remat_wrap(lambda p, x: self._dec_block(p, x, enc_out, variant,
                                                       positions, ctx),
                          variant)
        for p in tree_unbind(params["dec_blocks"]):
            x = body(p, x)
        return apply_norm(cfg, self._norm(ctx, params["ln_f"]), x)

    def loss(self, params, batch, ctx=None, variant: Variant = BASELINE):
        # training's encoder attention is the plain route: the flash kernel
        # is forward only
        variant = replace(variant, use_pallas=False)
        enc_out = self.encode(params, batch["frames"], ctx, variant)
        h = self.hidden_states(params, batch["tokens"], enc_out, ctx, variant)
        xent = chunked_softmax_xent(
            self.cfg, head_params(ctx, self.cfg, params["embed"]), h,
            batch["labels"], chunk=variant.xent_chunk)
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
        "xk"/"xv": (L, B, A, KV, hd)} bf16)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        enc_out = cast_compute(self.encode(params, batch["frames"], ctx,
                                           variant))
        B, S = tokens.shape
        dev = tokens.device
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        x = x + sinusoid(S, cfg.d_model, device=dev)[None].to(x.dtype)
        positions = torch.arange(S, device=dev)
        caches = []
        for layer in range(cfg.n_layers):
            p = gather_tree(ctx, tree_index(params["dec_blocks"], layer),
                            self.dec_specs)
            h = apply_norm(cfg, p["ln1"], x)
            q, k, v = attn.gqa_project_qkv(cfg, p["self_attn"], h, positions,
                                           None)
            o = attend(q, k, v, causal=True, variant=variant)
            x = x + attn.out_proj(o, p["self_attn"]["wo"]).to(x.dtype)
            h = apply_norm(cfg, p["ln_x"], x)
            qx, _, _ = attn.gqa_project_qkv(cfg, p["cross_attn"], h,
                                            positions, None)
            xk = attn._proj_heads(enc_out, p["cross_attn"]["wk"])
            xv = attn._proj_heads(enc_out, p["cross_attn"]["wv"])
            o = attend(qx, xk, xv, causal=False, variant=variant)
            x = x + attn.out_proj(o, p["cross_attn"]["wo"]).to(x.dtype)
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
            caches.append({"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16),
                           "xk": xk.to(torch.bfloat16),
                           "xv": xv.to(torch.bfloat16)})
        x = apply_norm(cfg, self._norm(ctx, params["ln_f"]), x[:, -1:, :])
        return (lm_logits(cfg, head_params(ctx, cfg, params["embed"]),
                          x)[:, 0], tree_stack(caches))

    def decode_step(self, params, cache, tokens, pos: int, ctx=None,
                    variant: Variant = BASELINE):
        """tokens (B, 1) at position ``pos`` -> (logits (B, 1, V_padded) f32,
        cache).  The self-attention's k/v are updated in place (the
        reference returns a new cache), xk/xv are read only; the same dict
        is returned."""
        cfg = self.cfg
        B = tokens.shape[0]
        dev = tokens.device
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        x = x + sinusoid(1, cfg.d_model, offset=pos, device=dev)[None] \
            .to(x.dtype)
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
        for layer in range(cfg.n_layers):
            p = gather_tree(ctx, tree_index(params["dec_blocks"], layer),
                            self.dec_specs)
            h = apply_norm(cfg, p["ln1"], x)
            a, _, _ = attn.gqa_decode(cfg, p["self_attn"], h, cache["k"][layer],
                                      cache["v"][layer], pos)
            x = x + a
            h = apply_norm(cfg, p["ln_x"], x)
            q, _, _ = attn.gqa_project_qkv(cfg, p["cross_attn"], h, positions,
                                           None)
            xk = cache["xk"][layer]
            o = attn.chunked_attention(q, xk, cache["xv"][layer], causal=False,
                                       kv_block=min(1024, xk.shape[1]))
            x = x + attn.out_proj(o, p["cross_attn"]["wo"]).to(x.dtype)
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        x = apply_norm(cfg, self._norm(ctx, params["ln_f"]), x)
        return lm_logits(cfg, head_params(ctx, cfg, params["embed"]),
                         x), cache
