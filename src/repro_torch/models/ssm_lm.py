"""Pure Mamba2 LM, attention-free (counterpart of ``repro.models.ssm_lm``:
``hidden_states`` and ``loss`` for training, ``prefill`` and
``decode_step`` for serving).

Block parameters are stacked ``(L, ...)`` as in the reference; where the
reference scans over the stack, the port loops over its layers.  A layer of
the prefill is ``models.ssm.mamba_prefill``, the hybrid's Mamba layer:
under ``Variant.use_pallas`` its SSD goes through the hand-written SSD
kernel, one launch a layer; without it, through ``ssd_chunked``.  Decode
stays plain PyTorch (``ssm_decode``), as the reference computes it outside
any Pallas kernel.  Training runs each layer's ``ssm_block`` (always
``ssd_chunked``) under ``remat_wrap``.  ``ctx`` (sharding): the
parameters are held as ``registry.held_axes`` blocks and each layer, the
embedding, the final norm and the head are gathered over the fsdp axes
at use, keeping their ``model`` blocks (``sharding.gather_tree``, in
training inside the layer's remat region): each layer runs on the rank's
SSD heads and ends with one reduction over ``model``
(``sharding.tp_plan``; with sequence parallelism the residual stream is
the rank's block of the sequence), the head is vocabulary parallel, and
the prefill's cache is the rank's block.  The tokens are this rank's
block of the batch.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import gather_tree, tp_plan
from repro_torch.models.common import (apply_norm, chunked_softmax_xent,
                                       embed_lookup, embed_specs,
                                       head_params, lm_logits, norm_specs,
                                       stack_specs, tree_index, tree_stack,
                                       tree_unbind)
from repro_torch.models.ssm import (keep_model, mamba_prefill, ssm_block,
                                    ssm_cache_shapes, ssm_decode, ssm_specs)
from repro_torch.models.variant import BASELINE, Variant, remat_wrap


class SSMLM:
    def __init__(self, cfg):
        self.cfg = cfg
        self.layer_specs = {"ln": norm_specs(cfg, cfg.d_model),
                            "ssm": ssm_specs(cfg)}

    def param_specs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "blocks": stack_specs(self.layer_specs, cfg.n_layers),
            "ln_f": norm_specs(cfg, cfg.d_model),
        }

    def _layer(self, ctx, p, tp):
        return gather_tree(ctx, p, self.layer_specs,
                           keep=keep_model(self.cfg, tp))

    def _ln_f(self, ctx, params):
        return gather_tree(ctx, params["ln_f"],
                           norm_specs(self.cfg, self.cfg.d_model))

    # -- training ------------------------------------------------------------
    def hidden_states(self, params, tokens, ctx=None,
                      variant: Variant = BASELINE):
        """tokens (B, S) -> final hidden states (B, S, D) bf16."""
        cfg = self.cfg
        tp = tp_plan(ctx, tokens.shape[1])
        x = embed_lookup(ctx, cfg, params["embed"], tokens)

        def layer(p, x):
            p = self._layer(ctx, p, tp)
            return x + ssm_block(cfg, p["ssm"], apply_norm(cfg, p["ln"], x),
                                 tp)
        body = remat_wrap(layer, variant)
        for p in tree_unbind(params["blocks"]):
            x = body(p, x)
        return tp.gather_seq(apply_norm(cfg, self._ln_f(ctx, params), x))

    def loss(self, params, batch, ctx=None, variant: Variant = BASELINE):
        h = self.hidden_states(params, batch["tokens"], ctx, variant)
        xent = chunked_softmax_xent(
            self.cfg, head_params(ctx, self.cfg, params["embed"]), h,
            batch["labels"], chunk=variant.xent_chunk,
            tp=tp_plan(ctx, h.shape[1]))
        return xent, {"xent": xent}

    # -- serving -------------------------------------------------------------
    def cache_shapes(self, batch: int, seq_len: int) -> dict:
        """One Mamba layer's decode cache, name -> (shape, axes, dtype) (stacked
        over layers by the registry); no entry grows with the sequence."""
        return ssm_cache_shapes(self.cfg, batch)

    def prefill(self, params, tokens, ctx=None, variant: Variant = BASELINE):
        """tokens (B, S) -> (logits of the last position (B, V_padded) f32,
        cache {"state", "conv_x", "conv_B", "conv_C"}: (L, B, ...))."""
        cfg = self.cfg
        tp = tp_plan(ctx, tokens.shape[1])
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        caches = []
        for layer in range(cfg.n_layers):
            x, entry = mamba_prefill(
                cfg, self._layer(ctx, tree_index(params["blocks"], layer),
                                 tp), x, variant, tp)
            caches.append(entry)
        x = apply_norm(cfg, self._ln_f(ctx, params),
                       tp.gather_seq(x)[:, -1:, :])
        return (lm_logits(cfg, head_params(ctx, cfg, params["embed"]), x,
                          tp)[:, 0], tree_stack(caches))

    def decode_step(self, params, cache, tokens, pos: int, ctx=None,
                    variant: Variant = BASELINE):
        """tokens (B, 1) -> (logits (B, 1, V_padded) f32, cache).  The
        cache's tensors are updated in place (the reference returns a new
        cache), and the same dict is returned; ``pos`` is not read (the
        recurrence has no position)."""
        cfg = self.cfg
        tp = tp_plan(ctx, 1)
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        for layer in range(cfg.n_layers):
            p = self._layer(ctx, tree_index(params["blocks"], layer), tp)
            y, new = ssm_decode(cfg, p["ssm"], apply_norm(cfg, p["ln"], x),
                                tree_index(cache, layer), tp)
            for name, t in new.items():
                cache[name][layer] = t
            x = x + y
        x = apply_norm(cfg, self._ln_f(ctx, params), x)
        return lm_logits(cfg, head_params(ctx, cfg, params["embed"]), x,
                         tp), cache
