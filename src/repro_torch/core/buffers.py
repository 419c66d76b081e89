"""Benchmark buffer initialization — the paper's denormal-avoiding discipline.

x86-membench initializes buffers with a cycle of a user-defined number, its
reciprocal, and the additive inverses of both: (v, 1/v, -v, -1/v).  This
guarantees no denormals (which stall FP pipelines) while keeping non-trivial
data (data values influence power draw and, under power caps, throughput —
paper §2/§3.2).

Counterpart of ``repro.core.buffers``.  The buffers are built ON the target
device: the 4-cycle is rounded from float64 to the working dtype once and
then repeated, so a multi-GiB working set never exists as a host array.  The
values equal the reference's elementwise (each element is one rounding of the
same float64 either way; ``tests/test_torch_buffers.py`` asserts it).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.device import resolve_device

DEFAULT_VALUE = 1.234567

#: dtype names a BenchSpec may carry -> torch dtype
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
}


def as_dtype(dtype) -> torch.dtype:
    """A dtype name (``"float32"``) or a ``torch.dtype`` -> ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return DTYPES[str(dtype)]
    except KeyError:
        raise TypeError(f"data type {dtype!r} not understood; known: "
                        f"{sorted(DTYPES)}") from None


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the name the result JSON carries)."""
    return str(as_dtype(dtype)).removeprefix("torch.")


def itemsize(dtype) -> int:
    return torch.empty((), dtype=as_dtype(dtype)).element_size()


def _cycled(cycle: torch.Tensor, n: int) -> torch.Tensor:
    if n % cycle.numel() == 0:
        return cycle.repeat(n // cycle.numel())
    return cycle.repeat(n // cycle.numel() + 1)[:n].contiguous()


def init_pattern(n: int, value: float = DEFAULT_VALUE, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """(v, 1/v, -v, -1/v) cycled to length n, built on ``device``."""
    if value == 0 or not math.isfinite(value):
        raise ValueError("init value must be finite and nonzero")
    dev = resolve_device(device)
    cycle = torch.tensor([value, 1.0 / value, -value, -1.0 / value],
                         dtype=torch.float64).to(as_dtype(dtype)).to(dev)
    return _cycled(cycle, n)


def working_set_shape(nbytes: int, dtype=torch.float32, lanes: int = 128
                      ) -> tuple[int, int]:
    """The (rows, lanes) shape ``working_set`` would allocate for ~nbytes —
    lets callers plan/validate a sweep without touching device memory."""
    rows = max(8, int(round(nbytes / (lanes * itemsize(dtype)) / 8)) * 8)
    return (rows, lanes)


def working_set(nbytes: int, dtype=torch.float32, value: float = DEFAULT_VALUE,
                lanes: int = 128, device=None) -> torch.Tensor:
    """A contiguous 2D (rows, lanes) buffer of ~nbytes on ``device``, rows a
    multiple of 8 — the same shape the reference allocates, so tiles line up
    with the reference."""
    dt = as_dtype(dtype)
    rows, lanes = working_set_shape(nbytes, dt, lanes)
    return working_block(rows, lanes, dt, value, device)


def working_block(rows: int, lanes: int = 128, dtype=torch.float32,
                  value: float = DEFAULT_VALUE, device=None) -> torch.Tensor:
    """The (rows, lanes) buffer ``working_set`` fills, for any row count: a
    block of whole rows of a working set, made where it lives (the pattern
    repeats every 4 elements and a row holds a multiple of 4, so each block
    of rows equals the same rows of the whole buffer)."""
    dt = as_dtype(dtype)
    n = rows * lanes
    if not dt.is_floating_point:
        dev = resolve_device(device)
        cycle = torch.tensor([1, 7, -1, -7], dtype=dt, device=dev)
        return _cycled(cycle, n).reshape(rows, lanes)
    return init_pattern(n, value, dt, device).reshape(rows, lanes)


def has_denormals(arr) -> bool:
    t = torch.as_tensor(arr)
    if not t.dtype.is_floating_point:
        return False
    tiny = torch.finfo(t.dtype).tiny
    a = t.detach().to("cpu", torch.float64)
    nz = a[a != 0.0]
    return bool(torch.any(nz.abs() < tiny))


def sizes_logspace(lo: int, hi: int, per_decade: int = 8) -> list[int]:
    """Log-spaced working-set sizes (bytes), 8-row aligned by working_set()."""
    n = max(2, int(np.ceil((np.log10(hi) - np.log10(lo)) * per_decade)))
    out = np.unique(np.geomspace(lo, hi, n).astype(np.int64))
    return [int(x) for x in out]


# --------------------------------------------------------------------------
# shared sweep grids — ONE grid constructor for every sweep
# --------------------------------------------------------------------------

#: canonical hierarchy span (the reference's, kept so grids agree)
HIERARCHY_SPAN = (16 * 2**10, 128 * 2**20)

#: the fixed quick/smoke ladder (the reference's)
QUICK_SIZES = (32 * 2**10, 256 * 2**10, 2 * 2**20, 16 * 2**20)


def snap_sizes(sizes, dtype=torch.float32, lanes: int = 128) -> list[int]:
    """Requested byte counts -> the *real* working-set sizes
    ``working_set`` would allocate, deduplicated and sorted.  Two requests
    that round to the same (rows, lanes) tile are one measurement."""
    isz = itemsize(dtype)
    out = set()
    for s in sizes:
        rows, l = working_set_shape(int(s), dtype, lanes)
        out.add(rows * l * isz)
    return sorted(out)


def size_grid(lo: int = HIERARCHY_SPAN[0], hi: int = HIERARCHY_SPAN[1],
              per_decade: int = 6, dtype=torch.float32) -> list[int]:
    """Log-spaced grid snapped to real working-set sizes (the grid every
    sweep actually measures; ``sizes_logspace`` kept as the raw generator)."""
    return snap_sizes(sizes_logspace(lo, hi, per_decade), dtype=dtype)


def hierarchy_grid(quick: bool = False, lo: int = HIERARCHY_SPAN[0],
                   hi: int = HIERARCHY_SPAN[1], per_decade: int = 6
                   ) -> tuple[int, ...]:
    """The canonical hierarchy-sweep working-set grid.  ``quick`` returns the
    fixed one-size-per-level ladder shared by every ``--quick`` mode."""
    if quick:
        return QUICK_SIZES
    return tuple(size_grid(lo, hi, per_decade))
