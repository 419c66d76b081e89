"""stablelm-3b [dense]: MHA (kv=32), LayerNorm, partial rotary (25%).

32L d_model=2560 32H d_ff=6912 vocab=50304. [hf:stabilityai/stablelm-2-1_6b; unverified]
The same configuration as ``repro.configs.stablelm_3b``, field for field.
"""
from repro_torch.configs.base import ArchConfig, register

STABLELM_3B = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layer",
    rope_pct=0.25,
    sub_quadratic=False,
    source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
))
