"""granite-3-2b [dense]: GQA kv=8, tied embeddings, logit scaling.

40L d_model=2048 32H d_ff=8192 vocab=49155. [hf:ibm-granite/granite-3.0-2b-base; hf]
The same configuration as ``repro.configs.granite_3_2b``, field for field.
"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_3_2B = register(ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    tied_embeddings=True,
    logit_scale=8.0,
    sub_quadratic=False,
    source="[hf:ibm-granite/granite-3.0-2b-base; hf]",
))
