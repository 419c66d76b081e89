"""phi3-medium-14b [dense]: RoPE SwiGLU GQA kv=10.

40L d_model=5120 40H d_ff=17920 vocab=100352. [arXiv:2404.14219; unverified]
The same configuration as ``repro.configs.phi3_medium_14b``, field for field.
"""
from repro_torch.configs.base import ArchConfig, register

PHI3_MEDIUM_14B = register(ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    sub_quadratic=False,
    source="[arXiv:2404.14219; unverified]",
))
