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


def work_flops(BH: int, S: int, P: int, N: int, chunk: int,
               groups: int) -> float:
    """The operations the function needs (a bound's count; ``flops`` is the
    reference's, which multiplies whole Q x Q squares and C B^T once a
    row).  A chunk needs only the causal half of its pairs, Q (Q + 1) / 2:
    C B^T over them once a B/C group (``groups``: the distinct (S, N)
    matrices of B and C, BH when every row has its own, fewer where a
    group's rows repeat with stride 0 over its heads), and (C B^T o L) x
    over them once a row; a row's C state in every chunk but the first (no
    state enters it), and its state update in every chunk."""
    nc = S // chunk
    pairs = chunk * (chunk + 1) // 2
    return float(groups * nc * 2 * pairs * N
                 + BH * (nc * 2 * pairs * P + (2 * nc - 1) * 2 * chunk * N * P))
