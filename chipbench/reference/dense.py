"""Reference forward pass of the dense family (a pre-norm GQA decoder),
float32:

    x = x + attn(norm1(x));  x = x + mlp(norm2(x))

with rotary positions, a SwiGLU MLP, a final norm and the logits divided
by ``logit_scale`` (granite's ``logits_scaling``). The parameter tree is
the one the benchmark made and handed to the program too: ``embed``,
``blocks`` (layers, ...), ``ln_f``.
"""
from __future__ import annotations

import torch

from chipbench.reference import ops


def forward(cfg: dict, params: dict, tokens, rnd=ops.exact):
    """tokens (B, S) -> (logits (B, vocab) of the last position, the cache
    {"k", "v": per layer (B, S, KV, D)}), float32."""
    ops.check_supported(cfg)
    eps = cfg["norm_eps"]
    blocks = params["blocks"]
    x = ops.embed(params["embed"], tokens)
    cache = {"k": [], "v": []}
    for layer in range(cfg["n_layers"]):
        def at(tree):
            return {k: at(v) if isinstance(v, dict) else v[layer]
                    for k, v in tree.items()}
        p = at(blocks)
        a, kv = ops.gqa_layer(rnd, cfg, p["attn"],
                              ops.rms_norm(x, p["ln1"]["scale"], eps))
        x = x + a
        x = x + ops.swiglu(rnd, p["mlp"], ops.rms_norm(x, p["ln2"]["scale"],
                                                       eps))
        cache["k"].append(kv["k"])
        cache["v"].append(kv["v"])
    x = ops.rms_norm(x[:, -1], params["ln_f"]["scale"], eps)
    return ops.last_logits(rnd, cfg, params["embed"], x), cache


def program_cache(cache: dict) -> list[tuple[str, object]]:
    """(name, tensor) of every leaf of the program's prefill cache, in the
    order ``reference_cache`` gives the reference's."""
    return [(f"layer{i}.{n}", cache[n][i])
            for i in range(cache["k"].shape[0]) for n in ("k", "v")]


def reference_cache(cache: dict) -> list[tuple[str, object]]:
    return [(f"layer{i}.{n}", cache[n][i])
            for i in range(len(cache["k"])) for n in ("k", "v")]


def as_program_cache(cache: dict) -> dict:
    """The reference's cache in the program's layout: (L, B, S, KV, D)."""
    return {n: torch.stack(cache[n]) for n in ("k", "v")}
