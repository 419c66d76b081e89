"""internlm2-20b [dense]: GQA kv=8.

48L d_model=6144 48H d_ff=16384 vocab=92544. [arXiv:2403.17297; hf]
The same configuration as ``repro.configs.internlm2_20b``, field for field.
"""
from repro_torch.configs.base import ArchConfig, register

INTERNLM2_20B = register(ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    sub_quadratic=False,
    source="[arXiv:2403.17297; hf]",
))
