"""Mamba-2 SSD (full forward: intra-chunk + recurrence) — a hand-written CUDA
C++ kernel for Hopper, its wrapper and its plain PyTorch version.

Counterpart of ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas kernel
``_ssd_kernel``).  The kernel is ``csrc/ssd_scan.cu`` (its header says what
bounds it on an H100 and what the design does about it), with three routes
that ``launch_plan`` chooses between: bfloat16 products on the tensor cores
(float32 operands split into two bf16 halves) for state widths up to 64
(route 1) and up to 128 (route 2), and float32 FMAs (float32 inputs, and
the shapes the tensor-core routes do not take).  It is compiled
with ``nvcc`` for ``sm_90a`` at first use into ``build/ssd_scan/`` at the
checkout's root and loaded with ``ctypes`` (``repro_torch.kernels.build``).
Nothing is built or loaded when this module is imported.

The wrapper takes its plain version ONLY for tensors that lie on the CPU.
For CUDA tensors it launches the kernel or raises: no fallback.  It adds one
to ``launch_counts["ssd_scan"]``, and to ``route_launch_counts`` at the route
it launched, where it launches, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary, launch, raise_on

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory a block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232_448
_TILE = 64                  # rows per query / key tile of route 0
#: route 1 (tensor cores) of csrc/ssd_scan.cu: threads a CTA, CTAs an SM
#: its ``__launch_bounds__`` cuts registers for, columns of P a CTA owns,
#: padding of a staged row (bf16 elements), and the state widths it is
#: built for (N padded up to one of them)
TC_THREADS, TC_CTAS_PER_SM, TC_COLS, TC_PAD = 256, 2, 16, 8
TC_WIDTHS = (16, 32, 64)
#: route 2 (tensor cores at N up to 128): columns of P a CTA owns, CTAs an
#: SM its launch bound cuts registers for (threads and row padding are route
#: 1's), and the state widths it is built for (N padded up to one of them)
WIDE_COLS, WIDE_CTAS_PER_SM = 32, 2
WIDE_WIDTHS = (64, 128)
#: shared memory of one SM on an H100 (228 KiB), and what the card keeps
#: of it for each resident block (1 KiB)
SM_SMEM_BYTES, SMEM_PER_BLOCK = 233_472, 1024

#: launches of the kernel since the last ``reset_launch_counts``, and the
#: same launches by route
launch_counts: dict[str, int] = {"ssd_scan": 0}
route_launch_counts: dict[int, int] = {0: 0, 1: 0, 2: 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_launch_counts):
        for k in counts:
            counts[k] = 0


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = KernelLibrary(
    "ssd_scan", Path(__file__).resolve().parent / "csrc", {
        # dtype x dA  B heads so si ss  C heads so si ss  y state BH S P N Q
        # route stream
        "ssd_scan.cu": ("ssd_scan_fwd",
                        [_I, _P, _P, _P, _I, _LL, _LL, _LL, _P, _I, _LL, _LL,
                         _LL, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    }, headers=("../../tensor_core.cuh",))


def smem_bytes(P: int, N: int, Q: int) -> int:
    """Dynamic shared memory of one CTA of route 0 (``ssd_scan_smem_bytes``
    in the source): cum and decay rows, C and B tiles (padded), x, score and
    y tiles, and the (N, P) state, all float32."""
    return 4 * (2 * Q + 2 * _TILE * (N + 1) + 2 * _TILE * P
                + _TILE * (_TILE + 1) + N * P)


def tc_width(N: int) -> int | None:
    """The state width route 1 is built for that holds N (N padded up with
    zero columns), or None above the widest."""
    return next((w for w in TC_WIDTHS if N <= w), None)


def tc_smem_bytes(N: int, Q: int) -> int:
    """Dynamic shared memory of one CTA of route 1 (``tc_smem_bytes`` in the
    source): a chunk's C and B rows and its x columns in bf16 (rows padded by
    ``TC_PAD``), two buffers of the state's hi and lo halves, and three
    float32 rows (cum * log2 e and the two decays)."""
    row = tc_width(N) + TC_PAD
    return 2 * (2 * Q * row + Q * (TC_COLS + TC_PAD) + 4 * TC_COLS * row) \
        + 4 * 3 * Q


def wide_width(N: int) -> int | None:
    """The state width route 2 is built for that holds N (N padded up with
    zero columns), or None above the widest."""
    return next((w for w in WIDE_WIDTHS if N <= w), None)


def wide_smem_bytes(N: int, Q: int) -> int:
    """Dynamic shared memory of one CTA of route 2 (``wide_smem_bytes`` in
    the source): a chunk's B rows and its ``WIDE_COLS`` columns of x in bf16
    (rows padded by ``TC_PAD``), one buffer of the state's hi and lo halves,
    and three float32 rows.  C is not staged."""
    row = wide_width(N) + TC_PAD
    return 2 * (Q * row + Q * (WIDE_COLS + TC_PAD) + 2 * WIDE_COLS * row) \
        + 4 * 3 * Q


@functools.lru_cache(maxsize=256)
def launch_plan(BH: int, P: int, N: int, Q: int, dtype, sms: int = 132,
                aligned: bool = True) -> dict:
    """The route ``ssd_scan`` launches, its grid, its dynamic shared memory,
    the CTAs an SM holds at once and the waves of the grid on ``sms`` SMs.

    The tensor-core routes take bfloat16 with P and N multiples of 8, Q a
    multiple of 16, 16-byte aligned rows (``aligned``: x, B and C pointers
    and strides) and a chunk whose staging fits a block: route 1 N up to
    the widest of ``TC_WIDTHS``, ``TC_COLS`` columns of one row a CTA;
    route 2, ``WIDE_COLS`` columns a CTA, the rest up to the widest of
    ``WIDE_WIDTHS``: 64 < N <= 128, and at 32 < N <= 64 a chunk of 656
    to 944 steps, too long for route 1 to stage, which route 2's narrower
    staging at width 64 still holds.  Route 0
    (float32 FMAs) takes the rest, bfloat16 inputs widened to float32 by
    the wrapper: one CTA a row.  Cached: a serving prefill asks for the
    same plan once per layer (do not mutate the returned dict)."""
    split = (dtype == torch.bfloat16 and aligned and P % 8 == 0
             and N % 8 == 0 and Q % 16 == 0)
    if split and tc_width(N) is not None \
            and tc_smem_bytes(N, Q) <= MAX_SMEM_BYTES:
        route, cols, smem = 1, TC_COLS, tc_smem_bytes(N, Q)
        bound = TC_CTAS_PER_SM
    elif split and wide_width(N) is not None \
            and wide_smem_bytes(N, Q) <= MAX_SMEM_BYTES:
        route, cols, smem = 2, WIDE_COLS, wide_smem_bytes(N, Q)
        bound = WIDE_CTAS_PER_SM
    else:
        route, cols, smem = 0, P, smem_bytes(P, N, Q)
        bound = 2048 // 256
    grid = -(-P // cols) * BH
    per_sm = min(bound, SM_SMEM_BYTES // (smem + SMEM_PER_BLOCK))
    slots = per_sm * sms                 # 0: route 0 cannot launch (raises)
    return {"route": route, "grid": grid, "smem_bytes": smem,
            "ctas_per_sm": per_sm, "slots": slots,
            "waves": grid / slots if slots else float("inf"),
            "last_wave": (grid - 1) % slots + 1 if slots else 0}


def plain_ssd(xdt, dA, Bm, Cm):
    """Token-by-token recurrence (the port of
    ``repro.kernels.ssd_scan.ref.reference``): h_t = exp(dA_t) h_{t-1} +
    B_t x_t^T; y_t = C_t . h_t, in float32.  xdt: (BH, S, P); dA: (BH, S);
    Bm/Cm: (BH, S, N).  Returns y (BH, S, P) float32 and h (BH, N, P)."""
    BH, S, P = xdt.shape
    N = Bm.shape[-1]
    x = xdt.to(torch.float32)
    a = dA.to(torch.float32)
    Bf = Bm.to(torch.float32)
    Cf = Cm.to(torch.float32)
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(S):
        h = torch.exp(a[:, t])[:, None, None] * h + \
            Bf[:, t, :, None] * x[:, t, None, :]             # (BH, N, P)
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], h))
    return torch.stack(ys, dim=1), h


def _bc_layout(m: torch.Tensor, name: str, BH: int, S: int, N: int):
    """(heads, outer stride, inner stride, step stride) of B or C: a
    (BH, S, N) tensor, or a (Bb, H, S, N) view with Bb * H == BH (e.g. one
    group's rows expanded over its heads with stride 0); the last dim must
    have stride 1."""
    if m.ndim == 3 and tuple(m.shape) == (BH, S, N):
        return 1, m.stride(0), 0, m.stride(1)
    if m.ndim == 4 and m.shape[0] * m.shape[1] == BH \
            and tuple(m.shape[2:]) == (S, N):
        return m.shape[1], m.stride(0), m.stride(1), m.stride(2)
    raise ValueError(f"{name} must be (BH, S, N) = ({BH}, {S}, {N}) or "
                     f"(B, H, S, N) with B*H = BH, got {tuple(m.shape)}")


def ssd_scan(xdt, dA, Bm, Cm, *, chunk: int = 256):
    """xdt: (BH, S, P) dt-weighted inputs; dA: (BH, S) float32; Bm/Cm: (BH,
    S, N), or (B, H, S, N) views with B * H = BH (stride 0 over H allowed).

    Returns (y (BH, S, P) in xdt's dtype, final_state (BH, N, P) float32).
    The chunk is ``min(chunk, S)`` and must divide S (the reference's
    assert)."""
    if not all(isinstance(t, torch.Tensor) for t in (xdt, dA, Bm, Cm)):
        raise TypeError("xdt, dA, Bm and Cm must be tensors")
    if xdt.ndim != 3 or dA.ndim != 2:
        raise ValueError(f"xdt must be (BH, S, P) and dA (BH, S), got "
                         f"{tuple(xdt.shape)} and {tuple(dA.shape)}")
    BH, S, P = xdt.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    if tuple(dA.shape) != (BH, S):
        raise ValueError(f"dA must be ({BH}, {S}), got {tuple(dA.shape)}")
    layouts = [_bc_layout(m, name, BH, S, N)
               for name, m in (("Bm", Bm), ("Cm", Cm))]
    if len({t.device for t in (xdt, dA, Bm, Cm)}) != 1:
        raise ValueError("xdt, dA, Bm and Cm must lie on one device")
    if xdt.device.type == "cpu":
        def per_head(m):
            return m if m.ndim == 3 else m.reshape(BH, S, N)
        y, h = plain_ssd(xdt, dA, per_head(Bm), per_head(Cm))
        return y.to(xdt.dtype), h
    if xdt.device.type != "cuda":
        raise ValueError(f"xdt lies on {xdt.device}: need a cpu or cuda "
                         f"tensor")
    if xdt.dtype not in _DTYPE_CODE or Bm.dtype != xdt.dtype \
            or Cm.dtype != xdt.dtype:
        raise TypeError(f"xdt, Bm and Cm must share one dtype, float32 or "
                        f"bfloat16; got {xdt.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dA.dtype != torch.float32:
        raise TypeError(f"dA must be float32, got {dA.dtype}")
    if not (xdt.is_contiguous() and dA.is_contiguous()) \
            or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("xdt and dA must be contiguous, and Bm/Cm have "
                         "stride 1 on their last dim")
    if P % 4 or N % 4:
        raise ValueError(f"ssd_scan.cu takes P and N multiples of 4; got "
                         f"P={P}, N={N}")
    (bh_, bso, bsi, bss), (ch_, cso, csi, css) = layouts
    aligned = all(v % 8 == 0 for v in (bso, bsi, bss, cso, csi, css)) \
        and all(t.data_ptr() % 16 == 0 for t in (xdt, Bm, Cm))
    route = launch_plan(BH, P, N, Q, xdt.dtype, aligned=aligned)["route"]
    if route == 0 and smem_bytes(P, N, Q) > MAX_SMEM_BYTES:
        raise ValueError(f"P={P}, N={N}, chunk={Q} need "
                         f"{smem_bytes(P, N, Q)} B of shared memory, more "
                         f"than the {MAX_SMEM_BYTES} B a block may use")
    out_dtype = xdt.dtype
    if route == 0 and out_dtype != torch.float32:
        # route 0 computes in float32: bf16 inputs widened (exactly), y
        # rounded back once, as the kernel itself would round it
        xdt, Bm, Cm = xdt.float(), Bm.float(), Cm.float()
        (bh_, bso, bsi, bss), (ch_, cso, csi, css) = [
            _bc_layout(m, name, BH, S, N) for name, m in (("Bm", Bm),
                                                          ("Cm", Cm))]
    y = torch.empty_like(xdt)
    st = torch.empty((BH, N, P), dtype=torch.float32, device=xdt.device)
    err = launch(LIBRARY.entry("ssd_scan.cu"), xdt, _DTYPE_CODE[xdt.dtype],
                 xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), bh_, bso, bsi,
                 bss, Cm.data_ptr(), ch_, cso, csi, css, y.data_ptr(),
                 st.data_ptr(), BH, S, P, N, Q, route)
    launch_counts["ssd_scan"] += 1
    route_launch_counts[route] += 1
    raise_on(err, "ssd_scan")
    return y.to(out_dtype), st
