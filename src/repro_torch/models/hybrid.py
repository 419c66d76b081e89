"""Zamba2-style hybrid: Mamba2 backbone + one *shared* transformer block
(counterpart of ``repro.models.hybrid``: ``hidden_states`` and ``loss`` for
training, ``prefill`` and ``decode_step`` for serving).

The shared block (GQA attention + FFN, one parameter set) is applied before
every ``attn_every``-th group of Mamba layers with a per-site input norm.
Parameters are stacked ``(sites, group, ...)`` as in the reference; where the
reference scans over the stacks, the port loops.  Zamba2's per-site LoRA
deltas are omitted, as in the reference.  In training each site (the
shared block and its group of Mamba layers) runs under ``remat_wrap``, and
so does each Mamba layer inside it: the nested remat of the reference,
without which the site's recompute would keep every layer's SSD score
matrices of the group at once.  Training takes the plain routes
(``gqa_attention``, ``ssm_block``) whatever ``Variant.use_pallas`` says.

``Variant.use_pallas`` keeps the reference's meaning: the prefill's site
attention goes through the hand-written flash-attention kernel and every
Mamba layer's SSD through the hand-written SSD kernel; without it, through
the ports of the reference's default paths (``chunked_attention``,
``ssd_chunked``).  Decode stays plain PyTorch, as the reference computes it
outside any Pallas kernel.

``ctx`` (sharding), in training and serving: the parameters are held as
``registry.held_axes`` blocks, and each Mamba layer, each site's norm and
the shared block at each site are gathered over the fsdp axes at use,
keeping their ``model`` blocks (``sharding.gather_tree(...,
keep=("model",))``; in training inside the remat regions, so the shared
block's gradient sums over its sites), the embedding, the final norm and
the head theirs at the lookup and the logits.  A layer computes on the
rank's share (``sharding.tp_plan``): the shared attention on its heads,
the MLP on its ffn block, a Mamba layer on its SSD heads, each ended by
one reduction over ``model``; the head is vocabulary parallel, and with
sequence parallelism the residual stream between layers is the rank's
block of the sequence.  The tokens are this rank's block of the batch over
the data axes; on a mesh the prefill's cache is the rank's block (KV
heads, SSD heads, inner).  In ``decode_step(..., seq_shard_decode=True)``
each site's attention is ``serve.flash_decode.seq_sharded_gqa_decode``
over this rank's block of the KV cache (``flash_decode.cache_spec``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.distributed.sharding import (NO_TP, TP_AXIS, gather_tree,
                                              tp_plan)
from repro_torch.models.common import (apply_mlp, apply_norm,
                                       chunked_softmax_xent, embed_lookup,
                                       embed_specs, head_params, lm_logits,
                                       mlp_specs, norm_specs, stack_specs,
                                       tree_index, tree_stack, tree_unbind)
from repro_torch.models.ssm import (keep_model, mamba_prefill, ssm_block,
                                    ssm_cache_shapes, ssm_decode, ssm_specs)
from repro_torch.models.variant import BASELINE, Variant, remat_wrap
from repro_torch.serve import flash_decode


class HybridLM:
    def __init__(self, cfg):
        self.cfg = cfg
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                             f"multiple of attn_every {cfg.attn_every}")
        self.n_sites = cfg.n_layers // cfg.attn_every
        # one Mamba layer's, a site norm's and the shared block's specs
        self.mamba_specs = {"ln": norm_specs(cfg, cfg.d_model),
                            "ssm": ssm_specs(cfg)}
        self.site_norm_specs = norm_specs(cfg, cfg.d_model)
        self.shared_specs = {
            "ln1": norm_specs(cfg, cfg.d_model),
            "attn": attn.gqa_specs(cfg, cfg.d_model),
            "ln2": norm_specs(cfg, cfg.d_model),
            "mlp": mlp_specs(cfg, cfg.d_model, cfg.d_ff),
        }

    def param_specs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            # (sites, group, ...) double-stacked mamba params
            "mamba": stack_specs(
                stack_specs(self.mamba_specs, cfg.attn_every, "layers"),
                self.n_sites, "sites"),
            "site_norms": stack_specs(self.site_norm_specs, self.n_sites,
                                      "sites"),
            "shared": self.shared_specs,
            "ln_f": norm_specs(cfg, cfg.d_model),
        }

    def _shared(self, ctx, params):
        return gather_tree(ctx, params["shared"], self.shared_specs,
                           keep=(TP_AXIS,))

    def _site_norm(self, ctx, site_norm):
        return gather_tree(ctx, site_norm, self.site_norm_specs)

    def _mamba(self, ctx, p, tp):
        return gather_tree(ctx, p, self.mamba_specs,
                           keep=keep_model(self.cfg, tp))

    # -- training ----------------------------------------------------------------
    def _shared_block(self, params, site_norm, x, variant, positions,
                      ctx=None, tp=NO_TP):
        cfg = self.cfg
        p = self._shared(ctx, params)
        h = apply_norm(cfg, self._site_norm(ctx, site_norm), x)  # per-site
        h1 = apply_norm(cfg, p["ln1"], h)
        a = attn.gqa_attention(cfg, p["attn"], h1, causal=True,
                               positions=positions, kv_block=variant.kv_block,
                               variant=variant.attn_variant, tp=tp)
        h = h + a
        h2 = apply_norm(cfg, p["ln2"], h)
        return x + h + apply_mlp(cfg, p["mlp"], h2, tp)  # onto the backbone

    def hidden_states(self, params, tokens, ctx=None,
                      variant: Variant = BASELINE):
        """tokens (B, S) -> final hidden states (B, S, D) bf16, whole."""
        cfg = self.cfg
        B, S = tokens.shape
        tp = tp_plan(ctx, S)
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        positions = torch.arange(S, device=tokens.device)

        def mamba_body(p, x):
            p = self._mamba(ctx, p, tp)
            return x + ssm_block(cfg, p["ssm"], apply_norm(cfg, p["ln"], x),
                                 tp)

        # nested remat: the inner loop checkpoints its own body, or the
        # site-level recompute keeps every layer's SSD score matrices
        mamba_fn = remat_wrap(mamba_body, variant)

        def site_body(group_p, site_norm, x):
            x = self._shared_block(params, site_norm, x, variant, positions,
                                   ctx, tp)
            for p in tree_unbind(group_p):
                x = mamba_fn(p, x)
            return x

        site_fn = remat_wrap(site_body, variant)
        for group_p, site_norm in zip(tree_unbind(params["mamba"]),
                                      tree_unbind(params["site_norms"])):
            x = site_fn(group_p, site_norm, x)
        return tp.gather_seq(apply_norm(cfg, self._ln_f(ctx, params), x))

    def _ln_f(self, ctx, params):
        return gather_tree(ctx, params["ln_f"], self.site_norm_specs)

    def loss(self, params, batch, ctx=None, variant: Variant = BASELINE):
        h = self.hidden_states(params, batch["tokens"], ctx, variant)
        xent = chunked_softmax_xent(
            self.cfg, head_params(ctx, self.cfg, params["embed"]), h,
            batch["labels"], chunk=variant.xent_chunk,
            tp=tp_plan(ctx, h.shape[1]))
        return xent, {"xent": xent}

    # -- serving -----------------------------------------------------------------
    def cache_shapes(self, batch: int, seq_len: int) -> dict:
        """Two cache families: per-mamba-layer SSM caches and per-site KV
        caches; name -> (shape, logical axes, dtype), unstacked."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        kv = ((batch, seq_len, cfg.n_kv_heads, hd),
              ("batch", "kv_seq", "kv_heads", None), torch.bfloat16)
        return {"ssm": ssm_cache_shapes(cfg, batch), "k": kv, "v": kv}

    def prefill(self, params, tokens, ctx=None, variant: Variant = BASELINE):
        """tokens (B, S) -> (logits of the last position (B, V_padded) f32,
        cache {"ssm": {name: (sites, group, ...)}, "k"/"v": (sites, B, S, KV,
        hd) bf16}; on a mesh the rank's block)."""
        cfg = self.cfg
        B, S = tokens.shape
        tp = tp_plan(ctx, S)
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        positions = torch.arange(S, device=tokens.device)
        inv_freq = attn.rope_freqs(cfg.resolved_head_dim, cfg.rope_pct,
                                   cfg.rope_theta, device=tokens.device)
        caches = []
        for site in range(self.n_sites):
            shared = self._shared(ctx, params)
            h = apply_norm(cfg, self._site_norm(
                ctx, tree_index(params["site_norms"], site)), x)
            a, entry = attn.gqa_prefill(
                cfg, shared["attn"], apply_norm(cfg, shared["ln1"], h),
                positions, inv_freq, tp=tp, use_pallas=variant.use_pallas,
                kv_block=variant.kv_block, dtype=x.dtype)
            h = h + a
            h2 = apply_norm(cfg, shared["ln2"], h)
            x = x + h + apply_mlp(cfg, shared["mlp"], h2, tp)
            layer_caches = []
            for layer in range(cfg.attn_every):
                x, e = mamba_prefill(
                    cfg, self._mamba(ctx, tree_index(params["mamba"], site,
                                                     layer), tp),
                    x, variant, tp)
                layer_caches.append(e)
            caches.append({"ssm": tree_stack(layer_caches), **entry})
        x = apply_norm(cfg, self._ln_f(ctx, params),
                       tp.gather_seq(x)[:, -1:, :])
        return (lm_logits(cfg, head_params(ctx, cfg, params["embed"]), x,
                          tp)[:, 0], tree_stack(caches))

    def decode_step(self, params, cache, tokens, pos: int, ctx=None,
                    variant: Variant = BASELINE,
                    seq_shard_decode: bool = False):
        """tokens (B, 1) at position ``pos`` -> (logits (B, 1, V_padded) f32,
        cache).  The cache's tensors are updated in place (the reference
        returns a new cache; in place saves a copy of it per token), and the
        same dict is returned.  ``seq_shard_decode``: the k/v caches are
        this rank's ``flash_decode.cache_spec`` blocks on ``ctx``'s mesh and
        each site attends through the sequence-sharded decode."""
        cfg = self.cfg
        tp = tp_plan(ctx, 1)
        x = embed_lookup(ctx, cfg, params["embed"], tokens)
        for site in range(self.n_sites):
            shared = self._shared(ctx, params)
            h = apply_norm(cfg, self._site_norm(
                ctx, tree_index(params["site_norms"], site)), x)
            h1 = apply_norm(cfg, shared["ln1"], h)
            if seq_shard_decode:
                a, _, _ = flash_decode.seq_sharded_gqa_decode(
                    ctx, cfg, shared["attn"], h1, cache["k"][site],
                    cache["v"][site], pos)
            else:
                a, _, _ = attn.gqa_decode(cfg, shared["attn"], h1,
                                          cache["k"][site], cache["v"][site],
                                          pos, tp)
            h = h + a
            h2 = apply_norm(cfg, shared["ln2"], h)
            x = x + h + apply_mlp(cfg, shared["mlp"], h2, tp)
            for layer in range(cfg.attn_every):
                p = self._mamba(ctx, tree_index(params["mamba"], site, layer),
                                tp)
                h = apply_norm(cfg, p["ln"], x)
                y, new = ssm_decode(cfg, p["ssm"], h,
                                    tree_index(cache["ssm"], site, layer), tp)
                for name, t in new.items():
                    cache["ssm"][name][site, layer] = t
                x = x + y
        x = apply_norm(cfg, self._ln_f(ctx, params), x)
        return lm_logits(cfg, head_params(ctx, cfg, params["embed"]), x,
                         tp), cache
