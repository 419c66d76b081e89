"""deepseek-v2-236b [moe]: MLA (kv_lora=512), 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff=1536(expert) vocab=102400. [arXiv:2405.04434; hf]
The same configuration as ``repro.configs.deepseek_v2_236b``, field for field.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

DEEPSEEK_V2_236B = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,           # MLA: kv heads == q heads after up-projection
    d_ff=1536,                # per-expert FFN width (assignment)
    vocab_size=102400,
    head_dim=192,             # nope 128 + rope 64
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared_experts=2),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    sub_quadratic=False,
    source="[arXiv:2405.04434; hf]",
))
