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
    ``rw_RtoW``    2(R-1) flops  R read streams folded triad-style, stored to
                                 W write streams (store-path attribution)
    ``latency_chase``  0         dependent pointer walk ``j = flat[j]`` (the
                                 latency probe; ``k_chase_loaded`` adds
                                 bandwidth generators, time-shared)

These are the *oracles* — the ``torch`` backend, counterpart of the
reference's ``xla`` backend (``repro.core.instruction_mix``): the semantic
yardstick the hand-written CUDA kernels in ``repro_torch.kernels.membench``
are held against, and the only path that runs without a GPU.  Each function
loops ``passes`` times over the buffer inside one call (the paper's
measurement loop) and returns a 0-dim float32 tensor on the buffer's device.
Each is written as a generator that yields after every pass (``stepped``):
``k_load_sum(x, passes)`` runs it to its end, ``k_load_sum.steps(x,
passes)`` is the generator, which the mesh backends advance one pass at a
time on every shard in turn (``pass_major``), so that every device has work
queued early.

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

The chase walk is a chain of dependent scalar loads.  As one tensor index
per step it would be one device operation per step (2**17 per timed call),
so ``k_chase*`` walk a host ``tolist()`` view of the permutation buffer: on
this backend a ``latency_chase`` point times a Python walk, not any
memory's latency (the ``cuda`` backend's kernel walks on the card).
"""
from __future__ import annotations

from functools import lru_cache, wraps

import numpy as np
import torch

from repro_torch.bench.mixes import (GEN_SWEEPS_PER_PASS, RW_COMBINE_COEF,
                                     get_mix)

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


def stepped(gen_fn):
    """An oracle written as a generator that yields after each pass and
    returns its scalar, as a plain function: ``k(...)`` runs every pass and
    returns the scalar; ``k.steps(...)`` is the generator, which the mesh
    backends advance one pass at a time on every shard in turn."""
    @wraps(gen_fn)
    def run(*args, **kwargs):
        return drain(gen_fn(*args, **kwargs))
    run.steps = gen_fn
    return run


def pass_major(runs: dict) -> dict:
    """Advance every pass generator one pass at a time, in the dict's
    order, until each has returned; key -> its return value."""
    out, live = {}, dict(runs)
    while live:
        for i, steps in list(live.items()):
            try:
                next(steps)
            except StopIteration as stop:
                out[i] = stop.value
                del live[i]
    return out


def drain(steps):
    """Run a pass generator to its end; its return value."""
    return pass_major({0: steps})[0]


def _pass_loop(step, passes: int, unroll: int, init):
    """The measurement pass loop (a generator: it yields after each pass
    and returns the carry): ``passes / unroll`` trips of ``unroll`` chained
    copies of ``step(i, carry) -> carry``.  For SCALAR-accumulator mixes
    (load_sum / fma / mxu / strided / blocked).  ``passes`` must be a
    multiple of ``unroll``."""
    _check_unroll(passes, unroll)
    carry = init
    for i in range(passes // unroll):
        for _ in range(unroll):         # chained: the sweeps stay ordered
            carry = step(i, carry)
            yield
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
            yield
        slots = tuple(new)
    return state, slots


def _consume_slots(acc: torch.Tensor, slots) -> torch.Tensor:
    """Fold the last element of every rotating output slot into ``acc`` (a
    slot is one tensor, or a tuple of them for the rw family)."""
    for out in slots:
        for o in (out if isinstance(out, tuple) else (out,)):
            acc = acc + o.reshape(-1)[-1].to(torch.float32)
    return acc


def _row_chunks(x: torch.Tensor, interleave: int) -> torch.Tensor:
    """Split rows into ``interleave`` equal chunks — one independent
    dependence chain each.  Data-dependent divisibility surfaces here."""
    rows = x.shape[0]
    if rows % interleave:
        raise ValueError(
            f"interleave={interleave} does not divide {rows} rows")
    return x.reshape(interleave, rows // interleave, *x.shape[1:])


@stepped
def k_load_sum(x, passes: int, unroll: int = 1):
    def body(_, carry):
        x, acc = carry
        acc = acc + x.sum(dtype=torch.float32)
        return (_perturb(x, acc), acc)
    _, acc = yield from _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


@stepped
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
    _, acc = yield from _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


@stepped
def k_copy(x, passes: int, unroll: int = 1):
    def sweep(i, carry, _y):
        x, acc = carry
        scale = (1.0 + acc * 0e0).to(x.dtype)   # y depends on acc
        y = x * scale
        acc = acc + y.reshape(-1)[0].to(torch.float32)
        return (x, acc), y
    (_, acc), ys = yield from _rotating_pass_loop(sweep, passes, unroll,
                                       (x, _zero(x)), torch.zeros_like(x))
    return _consume_slots(acc, ys)


@stepped
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
    (_, acc), ys = yield from _rotating_pass_loop(sweep, passes, unroll,
                                       (x, _zero(x)), torch.zeros_like(x))
    return _consume_slots(acc, ys)


@stepped
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
    _, acc = yield from _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


@stepped
def k_mxu(x, w, passes: int, unroll: int = 1):
    """x: (rows, 128); w: (128, 128) — one matmul per pass, accumulated in
    float32 (inputs are widened first, which for bfloat16 is exact)."""
    def body(_, carry):
        x, acc = carry
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
        acc = acc + y[:1, :1].sum()
        return (_perturb(x, acc), acc)
    _, acc = yield from _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


@stepped
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
    _, acc = yield from _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


@stepped
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

    _, acc = yield from _pass_loop(body, passes, unroll, (x, _zero(x)))
    return acc


@stepped
def k_triad(a, b, c, passes: int, unroll: int = 1):
    """STREAM triad a = b + s*c with a self-dependence chaining the passes
    (the rotating ``out`` slot IS the self-dependent a stream).  Computed in
    the working dtype, one rounding per operation, as the reference does."""
    def sweep(_, acc, a):
        a = b + RW_COMBINE_COEF * c + a * 1e-30   # triad with self-dependence
        return acc + a[0, 0].to(torch.float32), a
    acc, slots = yield from _rotating_pass_loop(sweep, passes, unroll,
                                                _zero(b), a)
    return _consume_slots(acc, slots)


@stepped
def k_rw(streams, outs, passes: int, unroll: int = 1):
    """The R:W ratio family: R read streams combined triad-style
    (``v = s0 + 1.5*s1 + ...`` in the working dtype, one rounding per
    operation), the result stored to W write streams, every pass.

    ``outs``: W write buffers carried through the pass loop; their values
    are never read, only their number, so callers may alias one buffer for
    all W seeds.  As in the reference, the ``acc * 1e-30`` terms ride on the
    coefficient and on each store (value-neutral at working-set
    magnitudes), and the returned scalar is ``passes * v[0,0] + W * unroll
    * v[-1,-1]``.  rw_1to1 is ``copy``'s stream pattern, rw_2to1
    ``triad``'s."""
    def sweep(_, acc, outs):
        eps = (acc * 1e-30).to(streams[0].dtype)
        coef = torch.tensor(RW_COMBINE_COEF, dtype=eps.dtype,
                            device=eps.device) + eps
        v = streams[0] + eps
        for s in streams[1:]:
            v = v + coef * s
        outs = tuple(v + w * eps for w in range(len(outs)))
        return acc + v.reshape(-1)[0].to(torch.float32), outs
    acc, slots = yield from _rotating_pass_loop(sweep, passes, unroll,
                                     _zero(streams[0]), tuple(outs))
    return _consume_slots(acc, slots)


@stepped
def k_rw_istream(streams, outs, passes: int, unroll: int = 1,
                 interleave: int = 2):
    """k_rw with the R-stream combine split into ``interleave`` independent
    row-chunk folds, concatenated before the W stores — identical values and
    accounting to k_rw."""
    def sweep(_, acc, outs):
        eps = (acc * 1e-30).to(streams[0].dtype)
        coef = torch.tensor(RW_COMBINE_COEF, dtype=eps.dtype,
                            device=eps.device) + eps
        chunked = [_row_chunks(s, interleave) for s in streams]
        vs = []
        for j in range(interleave):             # independent fold chains
            v = chunked[0][j] + eps
            for s in chunked[1:]:
                v = v + coef * s[j]
            vs.append(v)
        v = torch.cat(vs, dim=0)                # combined before the stores
        outs = tuple(v + w * eps for w in range(len(outs)))
        return acc + v.reshape(-1)[0].to(torch.float32), outs
    acc, slots = yield from _rotating_pass_loop(sweep, passes, unroll,
                                     _zero(streams[0]), tuple(outs))
    return _consume_slots(acc, slots)


def rw_streams(x, reads: int) -> tuple:
    """The R read streams of an rw mix: x plus R-1 scaled companions (each a
    distinct buffer, so the kernel really issues R loads per element)."""
    return (x,) + tuple(x * (0.5 ** r) for r in range(1, reads))


@lru_cache(maxsize=64)
def _chase_perm_np(rows: int, lanes: int, parts: int):
    if parts < 1 or rows % parts:
        raise ValueError(
            f"chase_perm: parts={parts} must divide rows={rows} (each part "
            f"is a row-contiguous segment with its own pointer cycle)")
    n = rows * lanes
    m = n // parts
    rng = np.random.default_rng(0)          # deterministic walk order
    out = np.empty(n, dtype=np.int32)
    for s in range(parts):
        order = rng.permutation(m)
        seg = np.empty(m, dtype=np.int32)
        seg[order] = np.roll(order, -1)     # order[i] -> order[i+1]: 1 cycle
        out[s * m:(s + 1) * m] = seg
    out.flags.writeable = False             # cached: shared by every caller
    return out.reshape(rows, lanes)


def chase_perm(shape, parts: int = 1):
    """The pointer-chase buffer for ``latency_chase``: an int32 (rows, lanes)
    numpy array whose flat view is split into ``parts`` row-contiguous
    segments, each holding one full permutation cycle of PART-LOCAL flat
    indices 0..m-1 (``flat[j]`` is the successor of ``j``); ``parts =
    rows / block_rows`` gives every kernel tile its own cycle.  Bit for bit
    the reference's buffer (the same seeded ``np.random.default_rng(0)``
    sequence).  Cached and read-only: place a copy with
    ``torch.tensor(chase_perm(...), device=...)``."""
    rows, lanes = shape
    return _chase_perm_np(int(rows), int(lanes), int(parts))


def _walker(perm: torch.Tensor):
    """``walk(j)``: n dependent steps ``j = flat[j]`` over a host list view
    of the whole buffer (one cycle of n when built by ``chase_perm``)."""
    flat = perm.reshape(-1).tolist()
    n = len(flat)

    def walk(j: int) -> int:
        for _ in range(n):
            j = flat[j]
        return j
    return walk


@stepped
def k_chase(perm, passes: int, unroll: int = 1):
    """The latency probe: one pass = n dependent loads ``j = flat[j]``
    walking the buffer's cycle, ``j`` carried from pass to pass; returns the
    float32 sum of ``j`` after every pass, plus the final ``j`` (0.0 on a
    ``chase_perm`` buffer, whose walk always returns to 0)."""
    walk = _walker(perm)

    def body(_, carry):
        j, acc = carry
        j = walk(j)
        return (j, acc + j)

    j, acc = yield from _pass_loop(body, passes, unroll, (0, _zero(perm)))
    return acc + j


@stepped
def k_chase_loaded(perm, gen, passes: int, unroll: int = 1, load: int = 1):
    """The single-device loaded-latency composite, time-shared: each probe
    pass of ``k_chase`` is followed by ``load * GEN_SWEEPS_PER_PASS``
    load_sum sweeps of ``gen`` (the bandwidth generators), chained through
    the accumulator and ``_perturb`` (in place on ``gen``) as
    ``k_load_sum``'s are."""
    walk = _walker(perm)

    def body(_, carry):
        gen, j, acc = carry
        j = walk(j)
        acc = acc + j
        for _ in range(load * GEN_SWEEPS_PER_PASS):
            acc = acc + gen.sum(dtype=torch.float32)
            gen = _perturb(gen, acc)
        return (gen, j, acc)

    _, j, acc = yield from _pass_loop(body, passes, unroll,
                                      (gen, 0, _zero(gen)))
    return acc + j


@stepped
def run_mix(mix_name: str, x, passes: int, w=None, unroll: int = 1,
            interleave: int = 1):
    return (yield from _mix_steps(mix_name, x, passes, w, unroll, interleave))


def _mix_steps(mix_name: str, x, passes: int, w, unroll: int,
               interleave: int):
    """``run_mix``'s oracle, as its pass generator."""
    if interleave > 1:
        # only the mixes with an interleaved variant (independent per-chunk
        # dependence chains); the bench backends gate this before timing
        if mix_name == "load_sum":
            return k_load_sum_istream.steps(x, passes, unroll, interleave)
        if mix_name == "copy":
            return k_copy_istream.steps(x, passes, unroll, interleave)
        if mix_name.startswith("rw_"):
            reads, writes = get_mix(mix_name).rw
            return k_rw_istream.steps(rw_streams(x, reads), (x,) * writes,
                                      passes, unroll, interleave)
        raise KeyError(
            f"mix {mix_name!r} has no interleaved (interleave > 1) variant; "
            f"interleavable mixes: load_sum, copy, rw_RtoW")
    if mix_name == "load_sum":
        return k_load_sum.steps(x, passes, unroll)
    if mix_name == "copy":
        return k_copy.steps(x, passes, unroll)
    if mix_name == "mxu":
        if w is None:
            w = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        return k_mxu.steps(x, w, passes, unroll)
    if mix_name == "triad":
        return k_triad.steps(torch.zeros_like(x), x, x * 0.5, passes, unroll)
    if mix_name == "latency_chase":
        # convenience path: x supplies only the shape and device — the probe
        # walks a permutation buffer built here (the bench backends bind
        # theirs outside the timed call)
        perm = torch.tensor(chase_perm(x.shape), device=x.device)
        return k_chase.steps(perm, passes, unroll)
    if mix_name.startswith("fma_"):
        return k_fma.steps(x, passes, int(mix_name.split("_")[1]), unroll)
    if mix_name.startswith("rw_"):
        # convenience path: companions built here, INSIDE any timing — the
        # bench backends bind their own streams outside the timed call
        reads, writes = get_mix(mix_name).rw
        return k_rw.steps(rw_streams(x, reads), (x,) * writes, passes,
                          unroll)
    raise KeyError(mix_name)
