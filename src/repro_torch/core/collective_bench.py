"""Collective / interconnect throughput — C6's remote-access study, on the
``torch.distributed`` mesh (counterpart of ``repro.core.collective_bench``).

The paper measures NUMA-remote access and multi-core scaling; the GPU
analogue is per-link NVLink throughput under each collective pattern.
Runs on any mesh of ``launch.mesh.make_mesh`` (gloo processes on the CPU
for harness validation; NCCL between GPUs).  Reports algorithm bandwidth
*and* ring-model link bandwidth, so results compare directly against the
link's data-sheet rate.

The reference computes each collective with XLA outside any Pallas kernel;
here each is one call of the collective library (NCCL on the card) on the
axis's process group:

    all_reduce      dist.all_reduce, in place on the rank's row
    all_gather      all_gather_single (all_gather_into_tensor before torch
                    2.13): the rows tiled, replicated on every rank
    reduce_scatter  reduce_scatter_single (reduce_scatter_tensor): the
                    replicated (n, m) input, each rank keeps its row
    all_to_all      all_to_all_single: the rank's (1, m) row as (n, m/n)
                    lanes, exchanged, back to (1, m)
    ppermute        batch_isend_irecv, rank i of the axis to i + 1 mod n

``all_reduce`` works in place (torch has no out-of-place all-reduce), so a
timed repetition sums what the last one left: the values grow by n a call
and the traffic does not change; the first call's output is the
reference's.  Each rank times its own calls (``core.timing.time_fn``); the
result takes the slowest rank's mean and its σ, since the reference times
one SPMD program that ends with its slowest device, and every rank returns
that same result.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import buffers, timing


@dataclass
class CollectiveResult:
    op: str
    axis: str
    group_size: int
    nbytes: int
    mean_s: float
    std_s: float
    algo_gbps: float       # payload bytes / time
    link_gbps: float       # ring-model per-link wire bandwidth


OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "ppermute")


def _ring_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    return {"all_reduce": 2 * (n - 1) / n,
            "all_gather": (n - 1) / n,
            "reduce_scatter": (n - 1) / n,
            "all_to_all": (n - 1) / n,
            "ppermute": 1.0}[op]


def _library(*names):
    """The first of ``names`` this torch has (the collectives were renamed
    ``*_single`` in torch 2.13; the semantics are the same)."""
    import torch.distributed as dist
    return next(getattr(dist, n) for n in names if hasattr(dist, n))


def global_input(n: int, nbytes: int, dtype=torch.float32, device=None):
    """The reference's buffer: ``init_pattern`` of ~nbytes, the element
    count rounded down to a multiple of 128 x n (at least 128 x n), as
    (n, m)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    elems = max(128, nbytes // itemsize)
    elems = (elems // (128 * n)) * 128 * n or 128 * n
    return buffers.init_pattern(elems, dtype=dtype,
                                device=device).reshape(n, -1)


def collective_case(mesh, axis: str, op: str, nbytes: int,
                    dtype=torch.float32):
    """(fn, arg, payload bytes): ``fn(arg)`` runs ``op`` once over
    ``axis`` and returns this rank's output — (1, m) for the ops whose
    output is split over the axis, the whole (n, m) for ``all_gather``.
    The global input is ``global_input``'s (n, m) buffer."""
    import torch.distributed as dist
    if op not in OPS:
        raise KeyError(op)
    n = mesh.shape[axis]
    x = global_input(n, nbytes, dtype, mesh.device)
    group, ranks, i = mesh.groups[axis], mesh.ranks[axis], mesh.coords[axis]
    payload = x.numel() * x.element_size() // n      # per-device payload
    row = x[i:i + 1].clone()

    if op == "all_reduce":
        def fn(v):
            dist.all_reduce(v, group=group)
            return v
        return fn, row, payload
    if op == "all_gather":
        gather = _library("all_gather_single", "all_gather_into_tensor")
        out = torch.empty_like(x)

        def fn(v):
            gather(out, v, group=group)
            return out
        return fn, row, payload
    if op == "reduce_scatter":
        scatter = _library("reduce_scatter_single", "reduce_scatter_tensor")
        out = torch.empty_like(row)

        def fn(v):
            scatter(out, v, group=group)
            return out
        return fn, x, payload
    if op == "all_to_all":
        lanes = row.reshape(n, -1)
        out = torch.empty_like(lanes)

        def fn(v):
            dist.all_to_all_single(out, v, group=group)
            return out.reshape(1, -1)
        return fn, lanes, payload
    out = torch.empty_like(row)
    if n == 1:                  # the one rank sends to itself: a copy
        def fn(v):
            return out.copy_(v)
        return fn, row, payload
    send, recv = ranks[(i + 1) % n], ranks[(i - 1) % n]

    def fn(v):
        ops = [dist.P2POp(dist.isend, v, send, group),
               dist.P2POp(dist.irecv, out, recv, group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out
    return fn, row, payload


def plain_output(op: str, x, i: int):
    """What rank ``i`` of the axis returns for ``op`` on the global (n, m)
    input ``x`` (``collective_case``'s, first call), computed on the host
    in float64 and rounded once to x's dtype: the plain version the
    library's result is held against (its own n-term sums round in its
    order, so within n ulps)."""
    n = x.shape[0]
    xd = x.detach().to("cpu", torch.float64)
    if op == "all_reduce":
        out = xd.sum(0, keepdim=True)
    elif op == "all_gather":
        out = xd
    elif op == "reduce_scatter":
        out = n * xd[i:i + 1]
    elif op == "all_to_all":
        out = torch.stack([xd[j].reshape(n, -1)[i] for j in range(n)]
                          ).reshape(1, -1)
    elif op == "ppermute":
        out = xd[(i - 1) % n:(i - 1) % n + 1]
    else:
        raise KeyError(op)
    return out.to(x.dtype)


def _slowest(mean_s: float, std_s: float) -> tuple[float, float]:
    """(mean, σ) of the rank with the largest mean, the same on every rank."""
    import torch.distributed as dist
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, (mean_s, std_s))
    return max(rows)


def bench_collective(mesh, axis: str, op: str, nbytes: int,
                     reps: int = 10, dtype=torch.float32) -> CollectiveResult:
    n = mesh.shape[axis]
    fn, arg, payload = collective_case(mesh, axis, op, nbytes, dtype)
    t = timing.time_fn(fn, arg, reps=reps, warmup=2, bytes_per_call=payload,
                       device=mesh.device)
    mean_s, std_s = _slowest(t.mean_s, t.std_s)
    link = payload * _ring_factor(op, n) / mean_s / 1e9
    return CollectiveResult(op=op, axis=axis, group_size=n,
                            nbytes=payload, mean_s=mean_s, std_s=std_s,
                            algo_gbps=payload / mean_s / 1e9, link_gbps=link)


def bench_all(mesh, nbytes: int = 4 * 2**20, ops=None, reps: int = 10):
    ops = ops or list(OPS)
    out = []
    for axis in mesh.axis_names:
        if mesh.shape[axis] < 2:
            continue
        for op in ops:
            out.append(bench_collective(mesh, axis, op, nbytes, reps=reps))
    return out
