"""arctic-480b [moe]: 128 experts top-2 + dense residual branch, GQA kv=8.

35L d_model=7168 56H d_ff=4864 vocab=32000. [hf:Snowflake/snowflake-arctic-base; hf]
The same configuration as ``repro.configs.arctic_480b``, field for field.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

ARCTIC_480B = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,                # dense-residual branch width
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  n_shared_experts=0, dense_residual=True),
    sub_quadratic=False,
    source="[hf:Snowflake/snowflake-arctic-base; hf]",
))
