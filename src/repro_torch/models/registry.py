"""Model registry (counterpart of ``repro.models.registry``).

``build(cfg)`` returns a model object exposing ``param_specs()``,
``cache_shapes(batch, seq_len)`` (name -> (shape, logical axes, dtype)),
``prefill(params, <tokens|batch>, ctx, variant)`` and
``decode_step(params, cache, tokens, pos, ctx, variant)``, for every family
the reference registers: ``DecoderLM`` (dense, vlm, moe), ``SSMLM`` (ssm),
``HybridLM`` (hybrid) and ``EncDecLM`` (encdec, whose prefill takes the
batch with its ``frames``).  ``input_abstract`` and ``cache_abstract``
give the step's inputs and the stacked caches as meta tensors (shapes and
dtypes, nothing allocated) beside their logical axes, as the reference's
``ShapeDtypeStruct`` trees; ``make_batch`` and ``init_cache`` make
concrete tensors on an explicit device.  On a mesh, ``held_axes`` names
the layout each parameter is held in (every leaf by its own logical axes,
as ``ShardCtx.spec`` resolves them), ``shard_params`` cuts a whole tree to
it and ``init_params_held`` draws a rank's blocks without the whole tree.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import entry_axes
from repro_torch.models.common import (init_leaf, spec_map, tree_leaves,
                                       tree_unflatten)
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


def input_abstract(cfg: ArchConfig, shape: ShapeConfig) -> tuple[dict, dict]:
    """(the step's batch as meta tensors, its logical axes), as the
    reference's ``input_abstract`` (tokens int64 here: the port's token
    dtype)."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    ax = ("batch", "seq")
    if shape.kind == "train":
        batch = {"tokens": meta((B, S), torch.int64),
                 "labels": meta((B, S), torch.int64)}
        axes = {"tokens": ax, "labels": ax}
    elif shape.kind == "prefill":
        batch, axes = {"tokens": meta((B, S), torch.int64)}, {"tokens": ax}
    else:  # decode: one new token against a seq_len cache
        batch = {"tokens": meta((B, 1), torch.int64)}
        axes = {"tokens": ("batch", None)}
    if cfg.family == "encdec" and shape.kind in ("train", "prefill"):
        batch["frames"] = meta((B, cfg.n_audio_ctx, cfg.d_model),
                               torch.bfloat16)
        axes["frames"] = ("batch", None, None)
    return batch, axes


def cache_abstract(cfg: ArchConfig, batch: int, seq_len: int
                   ) -> tuple[dict, dict]:
    """(the cache as meta tensors, its logical axes), stacked as the
    reference's ``cache_abstract``: for the hybrid, SSM caches (sites,
    group, ...) and KV caches (sites, ...); for the others, every entry
    (n_layers, ...); the stacked dims carry no axis."""
    model = build(cfg)
    shapes = model.cache_shapes(batch, seq_len)

    def entry(spec, lead):
        shp, axes, dtype = spec
        return (torch.empty(lead + shp, dtype=dtype, device="meta"),
                (None,) * len(lead) + axes)

    if cfg.family == "hybrid":
        lead = (model.n_sites, cfg.attn_every)
        abs_t: dict = {"ssm": {}}
        ax_t: dict = {"ssm": {}}
        for k, spec in shapes["ssm"].items():
            abs_t["ssm"][k], ax_t["ssm"][k] = entry(spec, lead)
        for k in ("k", "v"):
            abs_t[k], ax_t[k] = entry(shapes[k], lead[:1])
        return abs_t, ax_t
    abs_t, ax_t = {}, {}
    for k, spec in shapes.items():
        abs_t[k], ax_t[k] = entry(spec, (cfg.n_layers,))
    return abs_t, ax_t


def cache_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """``cache_abstract``'s tensors as (shape, dtype) pairs."""
    return spec_map(lambda t: (tuple(t.shape), t.dtype),
                    cache_abstract(cfg, batch, seq_len)[0])


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device) -> dict:
    """Concrete zero-filled cache on ``device``."""
    return spec_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device),
                    cache_abstract(cfg, batch, seq_len)[0])


# ---------------------------------------------------------------------------
# Parameters on a mesh
# ---------------------------------------------------------------------------

def held_axes(cfg: ArchConfig) -> dict:
    """The logical axes each parameter is held by on a mesh: every leaf's
    own (``ParamSpec.axes``).  ``ShardCtx.spec`` then gives its block: the
    vocabulary, heads, ffn, inner and expert dims over ``model``, ``embed``
    over the fsdp axes, a dim the rules cannot divide whole (recorded in
    ``ShardCtx.fallbacks``).  The models gather each layer's leaves over
    the fsdp axes at use and keep their ``model`` blocks
    (``sharding.gather_tree(..., keep=("model",))``), the rank's share of
    the layer's heads, ffn, SSD heads and inner dims, and of the
    vocabulary (tensor parallelism, ``sharding.tp_plan``); a moe layer's
    experts, shared experts and dense residual (``moe.HELD``) go through
    the same gather inside ``moe_layer``."""
    return spec_map(lambda s: s.axes, build(cfg).param_specs())


def shard_params(cfg: ArchConfig, params: dict, ctx) -> dict:
    """This rank's held blocks of a whole parameter tree (the whole leaves
    shared, not copied)."""
    return ctx.tree_shard(params, held_axes(cfg))


def init_params_held(cfg: ArchConfig, ctx, seed: int, device) -> dict:
    """This rank's parameters as ``shard_params`` would hold them, drawn
    without the whole tree: the whole leaves from one generator seeded
    ``seed`` (the same on every rank), each held block from its own
    generator, seeded from ``seed``, the leaf and the block's mesh
    position.  (The values differ from ``init_params``'s; use this where
    the whole tree does not fit one device.)"""
    specs = build(cfg).param_specs()
    axes = held_axes(cfg)
    whole = torch.Generator(device=device).manual_seed(seed)
    leaves = []
    for i, (spec, ax) in enumerate(zip(tree_leaves(specs),
                                       tree_leaves(axes))):
        sp = ctx.spec(spec.shape, ax)
        mesh_axes = [a for e in sp for a in entry_axes(e)]
        if ctx.axis_size(*mesh_axes) == 1:
            leaves.append(init_leaf(spec, whole))
            continue
        block = [n // ctx.axis_size(*entry_axes(e))
                 for n, e in zip(spec.shape, sp + (None,) * len(spec.shape))]
        gen = torch.Generator(device=device).manual_seed(
            seed + 7919 * (i + 1) + 104729 * (ctx.coord(mesh_axes) + 1))
        leaves.append(init_leaf(spec, gen, block))
    return tree_unflatten(specs, leaves)
