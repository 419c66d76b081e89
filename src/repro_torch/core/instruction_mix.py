"""The instruction-mix ladder — C2 of the paper, as plain PyTorch oracles.

Arm-membench measures the same data stream under LOAD-only / LOAD+FADD /
LOAD+NOP mixes; the throughput *gap* between mixes attributes the bottleneck
(load/store units vs front end).  This module sweeps *work per loaded byte*:

    mix            ops/element   Armv8 analogue
    ``load_sum``   1 add         the FADD accumulation loop (loads feeding FADDs)
    ``copy``       1 store       STREAM-copy (write path exercised)
    ``triad``      2 flops       STREAM-triad a = b + s*c
    ``fma_k``      2k flops      FADD loop with k-deep dependent FMA chain —
                                 the NOP-substitution ladder
    ``mxu``        2*128 flops   one 128x128 matmul per tile

These are the *oracles* — the ``torch`` backend, counterpart of the
reference's ``xla`` backend (``repro.core.instruction_mix``): the semantic
yardstick the hand-written CUDA kernels in ``repro_torch.kernels.membench``
are held against, and the only path that runs without a GPU.  Each function
loops ``passes`` times over the buffer inside one call (the paper's
measurement loop) and returns a 0-dim float32 tensor on the buffer's device.

The returned scalar equals the reference's for the same
``(x, passes, unroll, interleave)``, so the reference's bookkeeping is kept
even where eager PyTorch does not need it for liveness: the one-element
``acc * 1e-30`` perturbation (``_perturb``) and the post-loop fold of one
element of every rotating output slot (``_consume_slots``).  Eager PyTorch
runs each statement as written — it hoists nothing out of a loop and deletes
no dead sweep — so here those two only shape the value.  They are NOT wrapped
in ``torch.compile``, which would bring the compiler hazards back.

In place: ``_perturb`` adds to element ``[0, 0]`` of the caller's buffer
(the reference, whose arrays are immutable, perturbs a copy).  The addend is
``acc * 1e-30`` rounded to the buffer's dtype, which a buffer built by
``core.buffers.working_set`` absorbs without changing a bit.

The ``rw_RtoW`` family and ``latency_chase`` (``k_rw*``, ``k_chase*``,
``chase_perm``, ``rw_streams``) have no counterpart here yet.
"""
from __future__ import annotations

import torch

from repro_torch.bench.mixes import RW_COMBINE_COEF

_FMA_A = 1.0000001
_FMA_B = 1e-9


def _zero(x: torch.Tensor) -> torch.Tensor:
    """The float32 scalar accumulator, on ``x``'s device."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _perturb(x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """One-element self-dependent write (in place; see the module note)."""
    eps = (acc * 1e-30).to(x.dtype)
    x[(0,) * x.ndim] += eps
    return x


def _check_unroll(passes: int, unroll: int) -> None:
    if passes % unroll:
        raise ValueError(
            f"passes={passes} is not a multiple of unroll={unroll}")


def _pass_loop(step, passes: int, unroll: int, init):
    """The measurement pass loop: ``passes / unroll`` trips of ``unroll``
    chained copies of ``step(i, carry) -> carry``.  For SCALAR-accumulator
    mixes (load_sum / fma / mxu / strided / blocked).  ``passes`` must be a
    multiple of ``unroll``."""
    _check_unroll(passes, unroll)
    carry = init
    for i in range(passes // unroll):
        for _ in range(unroll):         # chained: the sweeps stay ordered
            carry = step(i, carry)
    return carry


def _rotating_pass_loop(sweep, passes: int, unroll: int, state, out0):
    """The measurement pass loop for mixes whose sweeps produce ARRAY
    outputs (copy / triad): the carry holds one output slot per unrolled
    sweep, sweep ``j`` of a trip fills slot ``j``.

    ``sweep(i, state, out) -> (state, out_new)``: ``out`` is the most
    recently produced output (the previous sweep's slot, wrapping to the
    last slot of the previous trip), which is how self-dependent mixes like
    triad chain trips.  Returns ``(state, slots)``; callers fold one element
    of every slot into the result with ``_consume_slots``, as the reference
    does."""
    _check_unroll(passes, unroll)
    slots = (out0,) * unroll
    for i in range(passes // unroll):
        out = slots[-1]                 # the rotation point: newest slot
        new = []
        for _ in range(unroll):         # chained via state AND out
            state, out = sweep(i, state, out)
            new.append(out)
        slots = tuple(new)
    return state, slots


def _consume_slots(acc: torch.Tensor, slots) -> torch.Tensor:
    """Fold the last element of every rotating output slot into ``acc``."""
    for out in slots:
        acc = acc + out.reshape(-1)[-1].to(torch.float32)
    return acc


def _row_chunks(x: torch.Tensor, interleave: int) -> torch.Tensor:
    """Split rows into ``interleave`` equal chunks — one independent
    dependence chain each.  Data-dependent divisibility surfaces here."""
    rows = x.shape[0]
    if rows % interleave:
        raise ValueError(
            f"interleave={interleave} does not divide {rows} rows")
    return x.reshape(interleave, rows // interleave, *x.shape[1:])


def k_load_sum(x, passes: int, unroll: int = 1):
    def body(_, carry):
        x, acc = carry
        acc = acc + x.sum(dtype=torch.float32)
        return (_perturb(x, acc), acc)
    _, acc = _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


def k_load_sum_istream(x, passes: int, unroll: int = 1, interleave: int = 2):
    """load_sum with ``interleave`` independent accumulator chains, one per
    row chunk, combined only after the sweep — same bytes and (to within the
    final combine) the same flops as k_load_sum."""
    def body(_, carry):
        x, acc = carry
        xs = _row_chunks(x, interleave)
        parts = [xs[j].sum(dtype=torch.float32)
                 for j in range(interleave)]    # independent chains
        s = parts[0]
        for p in parts[1:]:                     # combined after the sweep
            s = s + p
        acc = acc + s
        return (_perturb(x, acc), acc)
    _, acc = _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


def k_copy(x, passes: int, unroll: int = 1):
    def sweep(i, carry, _y):
        x, acc = carry
        scale = (1.0 + acc * 0e0).to(x.dtype)   # y depends on acc
        y = x * scale
        acc = acc + y.reshape(-1)[0].to(torch.float32)
        return (x, acc), y
    (_, acc), ys = _rotating_pass_loop(sweep, passes, unroll,
                                       (x, _zero(x)), torch.zeros_like(x))
    return _consume_slots(acc, ys)


def k_copy_istream(x, passes: int, unroll: int = 1, interleave: int = 2):
    """copy with the store stream split into ``interleave`` independent
    per-chunk streams (same bytes; the chunk stores carry no cross-chunk
    dependence)."""
    def sweep(i, carry, _y):
        x, acc = carry
        scale = (1.0 + acc * 0e0).to(x.dtype)
        xs = _row_chunks(x, interleave)
        y = torch.empty_like(x)
        ys = _row_chunks(y, interleave)
        for j in range(interleave):
            torch.mul(xs[j], scale, out=ys[j])
        acc = acc + y.reshape(-1)[0].to(torch.float32)
        return (x, acc), y
    (_, acc), ys = _rotating_pass_loop(sweep, passes, unroll,
                                       (x, _zero(x)), torch.zeros_like(x))
    return _consume_slots(acc, ys)


def k_fma(x, passes: int, depth: int, unroll: int = 1):
    def body(_, carry):
        x, acc = carry
        # dependent chain v = v*a + b per element, in float32; the first
        # link is out of place so x itself is never written
        v = (x.to(torch.float32) * _FMA_A).add_(_FMA_B)
        for _ in range(depth - 1):
            v.mul_(_FMA_A).add_(_FMA_B)
        acc = acc + v.sum()
        return (_perturb(x, acc), acc)
    _, acc = _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


def k_mxu(x, w, passes: int, unroll: int = 1):
    """x: (rows, 128); w: (128, 128) — one matmul per pass, accumulated in
    float32 (inputs are widened first, which for bfloat16 is exact)."""
    def body(_, carry):
        x, acc = carry
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
        acc = acc + y[:1, :1].sum()
        return (_perturb(x, acc), acc)
    _, acc = _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


def k_strided_sum(x, streams: int, passes: int, unroll: int = 1):
    """load_sum over S interleaved strided address streams (C3 — the paper's
    multi-pointer addressing study)."""
    def body(_, carry):
        x, acc = carry
        s = _zero(x)
        for k in range(streams):               # S interleaved address streams
            s = s + x[k::streams].sum(dtype=torch.float32)
        x[0, 0] += (s * 1e-30).to(x.dtype)
        return (x, acc + s)
    _, acc = _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


def k_blocked_sum(x, rows: int, passes: int, unroll: int = 1):
    """load_sum walking the buffer in (rows, lanes) blocks (C4 — the
    LD1D/LD2D/LD4D registers-per-load analogue).  The per-block sums are one
    batched reduction, then folded; the reference folds them one by one in
    block order, which differs only in rounding."""
    n_blocks = x.shape[0] // rows

    def body(_, carry):
        x, acc = carry
        blocks = x[:n_blocks * rows].reshape(n_blocks, -1)
        s = blocks.sum(dim=1, dtype=torch.float32).sum()
        x[0, 0] += (s * 1e-30).to(x.dtype)
        return (x, acc + s)

    _, acc = _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


def k_triad(a, b, c, passes: int, unroll: int = 1):
    """STREAM triad a = b + s*c with a self-dependence chaining the passes
    (the rotating ``out`` slot IS the self-dependent a stream).  Computed in
    the working dtype, one rounding per operation, as the reference does."""
    def sweep(_, acc, a):
        a = b + RW_COMBINE_COEF * c + a * 1e-30   # triad with self-dependence
        return acc + a[0, 0].to(torch.float32), a
    acc, slots = _rotating_pass_loop(sweep, passes, unroll, _zero(b), a)
    return _consume_slots(acc, slots)


def run_mix(mix_name: str, x, passes: int, w=None, unroll: int = 1,
            interleave: int = 1):
    if interleave > 1:
        # only the mixes with an interleaved variant (independent per-chunk
        # dependence chains); the bench backends gate this before timing
        if mix_name == "load_sum":
            return k_load_sum_istream(x, passes, unroll, interleave)
        if mix_name == "copy":
            return k_copy_istream(x, passes, unroll, interleave)
        raise KeyError(
            f"mix {mix_name!r} has no interleaved (interleave > 1) variant; "
            f"interleavable mixes: load_sum, copy, rw_RtoW")
    if mix_name == "load_sum":
        return k_load_sum(x, passes, unroll)
    if mix_name == "copy":
        return k_copy(x, passes, unroll)
    if mix_name == "mxu":
        if w is None:
            w = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        return k_mxu(x, w, passes, unroll)
    if mix_name == "triad":
        return k_triad(torch.zeros_like(x), x, x * 0.5, passes, unroll)
    if mix_name.startswith("fma_"):
        return k_fma(x, passes, int(mix_name.split("_")[1]), unroll)
    raise KeyError(mix_name)
