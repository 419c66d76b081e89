"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): bfloat16 on the tensor cores and
the HBM3's bandwidth."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time a call needing ``flops`` operations and moving
    ``nbytes`` bytes can take on the card."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
