"""mamba2-2.7b [ssm]: attention-free, SSD (state-space duality).

64L d_model=2560 ssm_state=128 vocab=50280. [arXiv:2405.21060; unverified]
d_inner = 2*d_model = 5120, head_dim 64 => 80 SSD heads.
The same configuration as ``repro.configs.mamba2_2p7b``, field for field.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

MAMBA2_2P7B = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,               # SSD heads (d_inner / head_dim)
    n_kv_heads=0,             # attention-free
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
    sub_quadratic=True,
    source="[arXiv:2405.21060; unverified]",
))
