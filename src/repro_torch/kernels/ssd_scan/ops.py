"""The SSD entry point (counterpart of ``repro.kernels.ssd_scan.ops``)."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan


def ssd(xdt, dA, Bm, Cm, chunk: int = 256):
    return ssd_scan(xdt, dA, Bm, Cm, chunk=chunk)


def flops(BH: int, S: int, P: int, N: int, chunk: int) -> float:
    """Per forward: intra 2*Q*Q*(N+P) + state 2*Q*N*P + off 2*Q*N*P per chunk."""
    nc = S // chunk
    per_chunk = 2 * chunk * chunk * (N + P) + 4 * chunk * N * P
    return float(BH * nc * per_chunk)
