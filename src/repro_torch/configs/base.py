"""Architecture + shape configuration system (counterpart of
``repro.configs.base``, kept as its own copy: this package imports nothing of
the reference).

Every architecture is expressed as an ``ArchConfig`` (one file per arch in
this package).  Shapes (the assigned input-shape set) are global and shared by all
LM-family archs.  ``REDUCED`` variants are derived mechanically for CPU smoke tests.
The dataclasses, ``reduced`` and ``param_count`` are the reference's, field for
field, and the registry holds the reference's ten architectures: hybrid
``zamba2-2.7b``; ssm ``mamba2-2.7b``; dense and vlm ``granite-3-2b``,
``stablelm-3b``, ``internlm2-20b``, ``phi3-medium-14b``, ``chameleon-34b``;
moe ``arctic-480b`` and ``deepseek-v2-236b`` (mla); encdec
``whisper-medium``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


# ---------------------------------------------------------------------------
# Shapes (assigned): seq_len x global_batch, and which step they lower.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    dense_residual: bool = False       # arctic: parallel dense FFN branch
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0               # 0 => no q compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 => d_model // n_heads
    # variants / options
    norm: str = "rms"                  # rms | layer
    mlp: str = "swiglu"                # swiglu | gelu
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0              # stablelm: partial rotary
    qk_norm: bool = False              # chameleon
    tied_embeddings: bool = False      # granite
    logit_scale: float = 1.0           # granite (1/scale on logits)
    norm_eps: float = 1e-5
    # family payloads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0                # zamba2: shared attn block period
    n_encoder_layers: int = 0          # whisper
    n_audio_ctx: int = 1500            # whisper frontend-stub context
    # behaviour
    sub_quadratic: bool = False        # may run long_500k
    has_decode: bool = True            # encoder-only archs would set False
    dtype: str = "bfloat16"
    source: str = ""                   # provenance [source; tier]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def supports_shape(self, shape: ShapeConfig) -> tuple[bool, str]:
        """Whether this (arch x shape) cell is runnable, else the documented skip."""
        if shape.kind == "decode" and not self.has_decode:
            return False, "encoder-only arch has no decode step"
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, ("pure full-attention arch: 524288-token KV at batch 1 is "
                           "the quadratic case excluded by the brief (DESIGN.md §4)")
        return True, ""


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def reduced(cfg: ArchConfig) -> ArchConfig:
    """Mechanically shrink a config to CPU-smoke scale, same family/topology."""
    updates: dict = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_audio_ctx=16,
    )
    if cfg.moe is not None:
        updates["moe"] = replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1))
    if cfg.mla is not None:
        updates["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                   rope_head_dim=16, nope_head_dim=32, v_head_dim=32)
    if cfg.ssm is not None:
        updates["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    if cfg.attn_every:
        updates["attn_every"] = 2
        updates["d_ff"] = 256
    if cfg.n_encoder_layers:
        updates["n_encoder_layers"] = 2
    return replace(cfg, **updates)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


#: one module per registered architecture, the reference's ten
_ARCH_MODULES = ["zamba2_2p7b", "mamba2_2p7b", "granite_3_2b", "stablelm_3b",
                 "internlm2_20b", "phi3_medium_14b", "chameleon_34b",
                 "arctic_480b", "deepseek_v2_236b", "whisper_medium"]

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _loaded = True


def param_count(cfg: ArchConfig) -> tuple[int, int]:
    """(total_params, active_params) analytic estimate — used for MODEL_FLOPS=6ND."""
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    emb = cfg.vocab_size * d * (1 if cfg.tied_embeddings else 2)

    def attn_params() -> int:
        if cfg.mla is not None:
            m = cfg.mla
            qdim = cfg.n_heads * (m.nope_head_dim + m.rope_head_dim)
            q = d * qdim if not m.q_lora_rank else d * m.q_lora_rank + m.q_lora_rank * qdim
            kv_a = d * (m.kv_lora_rank + m.rope_head_dim)
            kv_b = m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
            o = cfg.n_heads * m.v_head_dim * d
            return q + kv_a + kv_b + o
        q = d * cfg.n_heads * hd
        kv = 2 * d * cfg.n_kv_heads * hd
        o = cfg.n_heads * hd * d
        return q + kv + o

    def dense_ffn(dff: int) -> int:
        return (3 if cfg.mlp == "swiglu" else 2) * d * dff

    def ssm_params(s: SSMConfig) -> int:
        d_in = s.expand * d
        nh = d_in // s.head_dim
        zxbcdt = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
        return zxbcdt + d_in * d + nh * 2  # in-proj + out-proj + A_log/D

    per_layer: float
    if cfg.family in ("dense", "vlm"):
        per_layer = attn_params() + dense_ffn(cfg.d_ff)
        active = per_layer
    elif cfg.family == "moe":
        m = cfg.moe
        moe_p = m.n_experts * 3 * d * m.d_ff_expert
        shared_p = m.n_shared_experts * 3 * d * m.d_ff_expert
        router = d * m.n_experts
        dense_res = dense_ffn(cfg.d_ff) if m.dense_residual else 0
        per_layer = attn_params() + moe_p + shared_p + router + dense_res
        active = (attn_params() + m.top_k * 3 * d * m.d_ff_expert + shared_p
                  + router + dense_res)
    elif cfg.family == "ssm":
        per_layer = ssm_params(cfg.ssm)
        active = per_layer
    elif cfg.family == "hybrid":
        per_layer = ssm_params(cfg.ssm)
        shared_attn = attn_params() + dense_ffn(cfg.d_ff)  # counted once
        total = L * per_layer + shared_attn + emb
        n_sites = L // cfg.attn_every if cfg.attn_every else 0
        act = L * per_layer + n_sites * 0 + shared_attn + emb
        return int(total), int(act)
    elif cfg.family == "encdec":
        enc = cfg.n_encoder_layers * (attn_params() + dense_ffn(cfg.d_ff))
        dec = L * (2 * attn_params() + dense_ffn(cfg.d_ff))  # self + cross
        return int(enc + dec + emb), int(enc + dec + emb)
    else:
        raise ValueError(cfg.family)
    return int(L * per_layer + emb), int(L * active + emb)
