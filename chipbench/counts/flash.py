"""Work of one launch of the causal flash-attention kernel (a frozen copy of
``flash_attention.ops.flops``, causal, no query offset), and the bytes it
must move: q, k and v read once, o written once, bfloat16.

A launch's shape: {"B", "S", "H", "KV", "D", "Dv"} (queries and keys of
one length S, H query heads over KV key heads)."""

#: the kernel's names in a device trace (tensor-core and float32 routes)
KERNELS = ("flash_fwd",)
ELEMENT_BYTES = 2


def flops(shape: dict) -> float:
    """Both products over the causal half of the S x S pairs of each head:
    4 B H S S D / 2."""
    return 4.0 * shape["B"] * shape["H"] * shape["S"] ** 2 * shape["D"] / 2


def nbytes(shape: dict) -> float:
    B, S = shape["B"], shape["S"]
    return ELEMENT_BYTES * B * S * (shape["H"] * shape["D"]
                                    + shape["KV"] * (shape["D"] + shape["Dv"])
                                    + shape["H"] * shape["Dv"])


def launched() -> int:
    """The program's own count of the kernel's launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    return flash_attention.launch_counts["flash_attn"]
