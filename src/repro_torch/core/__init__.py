"""repro_torch.core — buffers, timing, the plain PyTorch instruction-mix
oracles, and device resolution."""
