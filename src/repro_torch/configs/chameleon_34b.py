"""chameleon-34b [vlm]: early-fusion over VQ image tokens; qk-norm stability fix.

48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536. [arXiv:2405.09818; unverified]
The VQ image tokenizer is the modality frontend stub: inputs are token ids drawn
from the unified 65536 vocab (text + image codes).
The same configuration as ``repro.configs.chameleon_34b``, field for field.
"""
from repro_torch.configs.base import ArchConfig, register

CHAMELEON_34B = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    sub_quadratic=False,
    source="[arXiv:2405.09818; unverified]",
))
