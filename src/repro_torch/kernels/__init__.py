"""repro_torch.kernels — the kernels written by hand for Hopper."""
