"""Causal GQA flash attention (forward) — a hand-written CUDA C++ kernel for
Hopper, its wrapper and its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the Pallas
kernel ``_attn_kernel``).  The kernel is ``csrc/flash_attn.cu`` (its header
says what bounds it on an H100 and what the design does about it); it is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/
flash_attention/`` at the checkout's root and loaded with ``ctypes``
(``repro_torch.kernels.build``).  Nothing is built or loaded when this module
is imported.

The wrapper takes its plain version ONLY for tensors that lie on the CPU.
For CUDA tensors it launches the kernel or raises: no fallback.  It adds one
to ``launch_counts["flash_attn"]`` where it launches, and nowhere else;
a launch with a query offset adds one to ``offset_launch_counts
["flash_attn"]`` too.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary, launch, raise_on

#: the (D, Dv) pairs the CUDA kernel is built for (a template over both):
#: the GQA head dims with Dv == D, and MLA's expanded prefill, q and k of 128
#: nope + 64 rope dims against v of 128
HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (96, 96), (128, 128), (192, 128))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the kernel since the last ``reset_launch_counts``
launch_counts: dict[str, int] = {"flash_attn": 0}
#: of those, the launches with a causal query offset (``q_offset`` > 0)
offset_launch_counts: dict[str, int] = {"flash_attn": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, offset_launch_counts):
        for k in counts:
            counts[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "flash_attention", Path(__file__).resolve().parent / "csrc", {
        # dtype q k v o B Sq Sk H KV D Dv causal q_offset scale stream
        "flash_attn.cu": ("flash_attn_fwd",
                          [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, ctypes.c_float, _P]),
    }, headers=("../../tensor_core.cuh",))


def plain_flash(q, k, v, *, causal: bool = True,
                q_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention in float32 (the port of
    ``repro.kernels.flash_attention.ref.reference``): q (B, Sq, H, D), k/v
    (B, Sk, KV, D|Dv) -> (B, Sq, H, Dv) in q's dtype.  Under the causal
    mask query row s sees keys 0 .. s + ``q_offset``."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qf = q.to(torch.float32).reshape(B, Sq, KV, G, D)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qf, kf) / (D ** 0.5)
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] + q_offset >= \
            torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask[None, None, None], s,
                        torch.tensor(-1e30, device=q.device))
    w = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    w = w / torch.sum(w, dim=-1, keepdim=True)
    o = torch.einsum("bkgqj,bjkd->bkgqd", w, vf)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, -1).to(q.dtype)


def _check(q, k, v, q_block: int, kv_block: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"{name} must be a 4-D tensor (B, S, heads, "
                             f"head_dim)")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} has dtype {t.dtype}: flash attention "
                            f"takes float32 or bfloat16")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k and v must share one device and dtype")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} lies on {t.device}: need a cpu or cuda "
                             f"tensor")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or v.shape[0] != B or k.shape[1] != v.shape[1] \
            or k.shape[2] != v.shape[2] or k.shape[3] != D:
        raise ValueError(f"shapes do not pair: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    # the reference's assert: Sq % q_block == 0 and Sk % kv_block == 0
    Sk = k.shape[1]
    if q_block < 1 or kv_block < 1 or Sq % min(q_block, Sq) \
            or Sk % min(kv_block, Sk):
        raise ValueError(f"Sq={Sq} must be a multiple of q_block={q_block} "
                         f"and Sk={Sk} of kv_block={kv_block} (each block "
                         f"capped at its sequence length)")


def check_built(D: int, Dv: int) -> None:
    """Raise unless the CUDA kernel is built for head dims (D, Dv) (its
    plain version takes any)."""
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attn.cu is built for the (D, Dv) pairs "
                         f"{HEAD_DIMS}; got D={D}, Dv={Dv}")


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 256,
                    kv_block: int = 256, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D/Dv) -> (B, Sq, H, Dv), GQA with
    H = G * KV.  ``q_block``/``kv_block`` keep the reference's signature and
    its divisibility rule; the CUDA kernel tiles by 64 query rows and 64 keys
    (bfloat16, on the tensor cores) or 32 keys (float32) whatever they are
    (the output depends on the tiling only by rounding).  ``q_offset``: the
    queries are positions ``q_offset .. q_offset + Sq - 1`` of the keys'
    sequence under the causal mask (a rank's block of the sequence against
    the keys up to its end: ``Sk - Sq``); 0 is the square mask."""
    _check(q, k, v, q_block, kv_block)
    if q_offset < 0 or (q_offset and not causal):
        raise ValueError(f"q_offset {q_offset}: a causal mask's offset, "
                         f">= 0")
    if q.device.type == "cpu":
        return plain_flash(q, k, v, causal=causal, q_offset=q_offset)
    B, Sq, H, D = q.shape
    _, Sk, KV, Dv = v.shape
    check_built(D, Dv)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    err = launch(LIBRARY.entry("flash_attn.cu"), q, _DTYPE_CODE[q.dtype],
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                 Sq, Sk, H, KV, D, Dv, int(causal), int(q_offset),
                 1.0 / (D ** 0.5))
    launch_counts["flash_attn"] += 1
    if q_offset:
        offset_launch_counts["flash_attn"] += 1
    raise_on(err, "flash_attn")
    return o
