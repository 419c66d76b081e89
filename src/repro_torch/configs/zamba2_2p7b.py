"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block every 6 layers.

54L d_model=2560 32H (kv=32) d_ff=10240 ssm_state=64 vocab=32000.
[arXiv:2411.15242; hf]  Zamba2's parameter-shared transformer block is modeled as a
single shared (attn + FFN) block applied at every 6th layer with per-site input
norms (LoRA per-site deltas omitted — DESIGN.md §4).  The same configuration
as ``repro.configs.zamba2_2p7b``, field for field.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

ZAMBA2_2P7B = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    attn_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=256),
    sub_quadratic=True,       # SSM backbone; shared-attn KV shards over seq for 500k
    source="[arXiv:2411.15242; hf]",
))
