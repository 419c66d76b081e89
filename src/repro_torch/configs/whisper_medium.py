"""whisper-medium [audio]: enc-dec, conv frontend stubbed (frame embeddings).

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. [arXiv:2212.04356; unverified]
Whisper-medium has 24 encoder + 24 decoder layers; ``n_layers`` counts the decoder
stack per the assignment, encoder depth recorded separately.
The same configuration as ``repro.configs.whisper_medium``, field for field.
"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_MEDIUM = register(ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm="layer",
    mlp="gelu",
    rope_pct=0.0,            # whisper uses learned/sinusoidal positions, no RoPE
    n_audio_ctx=1500,
    sub_quadratic=False,
    source="[arXiv:2212.04356; unverified]",
))
