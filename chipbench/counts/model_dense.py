"""Model FLOPs of a dense GQA decoder's prefill of B x S tokens, and the
hand-written kernels' launches in it.

The work the function needs: every projection and MLP product over all
B S tokens, causal attention's half of the S x S pairs, the head at the
last position only (the vocabulary's own columns). Norms, rotary and the
elementwise work are not counted."""
from chipbench.counts import flash


def head_dim(cfg: dict) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]


def attention_shape(cfg: dict, B: int, S: int) -> dict:
    D = head_dim(cfg)
    return {"B": B, "S": S, "H": cfg["n_heads"], "KV": cfg["n_kv_heads"],
            "D": D, "Dv": D}


def attention_layer_flops(cfg: dict, B: int, S: int) -> float:
    """q, k, v and o projections, the attention and the SwiGLU MLP."""
    d, T = cfg["d_model"], B * S
    D = head_dim(cfg)
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    proj = 2.0 * T * d * (H * D + 2 * KV * D) + 2.0 * T * H * D * d
    mlp = 3 * 2.0 * T * d * cfg["d_ff"]
    return proj + flash.flops(attention_shape(cfg, B, S)) + mlp


def head_flops(cfg: dict, B: int) -> float:
    return 2.0 * B * cfg["d_model"] * cfg["vocab_size"]


def model_flops(cfg: dict, B: int, S: int) -> float:
    return cfg["n_layers"] * attention_layer_flops(cfg, B, S) \
        + head_flops(cfg, B)


def launches(cfg: dict, B: int, S: int) -> dict:
    """kernel count module name -> the shapes of its launches in one
    prefill, in order."""
    return {"flash": [attention_shape(cfg, B, S)] * cfg["n_layers"]}
