"""Plain PyTorch per-call references for the membench kernels — counterpart
of ``repro.kernels.membench.ref`` (one sweep, no measurement loop)."""
from __future__ import annotations

import torch

from repro_torch.bench.mixes import RW_COMBINE_COEF


def ref_load_only(x):
    return x.to(torch.float32)[0, 0]


def ref_load_sum(x):
    return x.to(torch.float32).sum()


def ref_copy(x):
    return x


def ref_triad(x, y):
    return x + RW_COMBINE_COEF * y


def ref_rw(x, *ys):
    """The value every one of the W outputs of an rw tile holds."""
    v = x
    for y in ys:
        v = v + RW_COMBINE_COEF * y
    return v


def ref_chase(perm, block_rows: int):
    """Sum over tiles of the index a ``block_rows * 128``-step walk
    ``j = tile[j]`` from 0 reaches, walked tile by tile on the host."""
    m = block_rows * perm.shape[1]
    flat = perm.reshape(-1).tolist()
    total = torch.zeros((), dtype=torch.float32)
    for start in range(0, len(flat), m):
        j = 0
        for _ in range(m):
            j = flat[start + j]
        total = total + j
    return total.to(perm.device)


def ref_fma(x, depth: int):
    v = x.to(torch.float32)
    for _ in range(depth):
        v = v * 1.0000001 + 1e-9
    return v.sum()


def ref_mxu(x, block_rows: int):
    """Per-block (rows,128)@(128,128) -> y[0,0] of every block, accumulated."""
    rows, lanes = x.shape
    w = torch.eye(lanes, dtype=torch.float32, device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(rows // block_rows):
        blk = x[i * block_rows:(i + 1) * block_rows].to(torch.float32)
        total = total + torch.matmul(blk, w)[0, 0]
    return total


def reference(mix: str, x, depth: int = 8, block_rows: int = 128, y=None,
              ys=()):
    if mix.startswith("rw_"):
        return ref_rw(x, *ys)
    if mix == "latency_chase":
        return ref_chase(x, block_rows)
    if mix == "load_only":
        # accumulated over blocks: one lane per block
        return x.to(torch.float32)[::block_rows, 0].sum()
    if mix == "load_sum":
        return ref_load_sum(x)
    if mix == "copy":
        return ref_copy(x)
    if mix == "triad":
        return ref_triad(x, y)
    if mix.startswith("fma"):
        return ref_fma(x, depth)
    if mix == "mxu":
        return ref_mxu(x, block_rows)
    raise KeyError(mix)
