"""Per-mix callables + work accounting for the membench CUDA kernels —
counterpart of ``repro.kernels.membench.ops``.

Accounting delegates to the shared mix registry (``repro_torch.bench.mixes``)
so the kernels and the plain PyTorch oracles can never disagree about
bytes/flops.
"""
from __future__ import annotations

import torch

from repro_torch.bench.mixes import GEN_SWEEPS_PER_PASS, get_mix
from repro_torch.kernels.membench import membench as mb


def _split_mix(mix: str, depth: int) -> tuple[str, int]:
    """'fma_4' -> ('fma', 4); other names pass through with default depth."""
    if mix.startswith("fma_"):
        return "fma", int(mix.split("_")[1])
    return mix, depth


def make_kernel(mix: str = "load_sum", depth: int = 8, block_rows: int = 128,
                streams: int = 1, interleave: int = 1):
    """Returns fn(x) -> tensor (0-dim float32, or an array for copy/triad):
    one sweep of the kernel.  ``triad`` returns fn(x, y) — two read streams,
    one write stream; ``rw_RtoW`` fn(x, *ys) — its R-1 extra read streams —
    giving the tuple of its W outputs; ``latency_chase`` fn(perm), perm the
    int32 permutation buffer."""
    base_mix, depth_eff = _split_mix(mix, depth)
    if base_mix == "triad":
        return lambda x, y: mb.membench_call(
            x, mix="triad", block_rows=block_rows, streams=streams, y=y)
    if base_mix.startswith("rw_"):
        return lambda x, *ys: mb.membench_call(
            x, mix=base_mix, block_rows=block_rows, streams=streams, ys=ys,
            interleave=interleave)
    return lambda x: mb.membench_call(
        x, mix=base_mix, depth=depth_eff, block_rows=block_rows,
        streams=streams, interleave=interleave)


def make_timed_kernel(mix: str = "load_sum", depth: int = 8,
                      block_rows: int = 128, streams: int = 1,
                      passes: int = 1, unroll: int = 1, interleave: int = 1,
                      load: int = 0):
    """Like make_kernel, but ``passes`` sweeps run inside ONE launch (the
    paper's measurement loop, ``unroll`` sweeps per loop trip), so launch
    overhead does not swamp cache-resident working sets — except the
    chase, which launches once per pass (a pass lasts milliseconds; see
    ``membench.chase``), as its loaded composite does.  Always returns a
    function giving a 0-dim float32 tensor on the buffer's device — fn(x),
    fn(x, out=) for ``copy``, fn(x, y, out=) for ``triad``, fn(x, *ys,
    outs=) for ``rw_RtoW``, fn(perm) for ``latency_chase`` (fn(perm, gen)
    when ``load`` > 0) — whose value is the reference's Pallas backend's for
    the same knobs:

      scalar mixes   the sum over passes of the one-sweep kernel value
      copy / triad   passes * out[0,0] + unroll * out[-1,-1]: the reference
                     adds out[0,0] after every sweep and, after the loop, the
                     last element of each of its ``unroll`` rotating output
                     slots.  Those slots exist only to keep XLA from
                     narrowing the sweeps; here every sweep writes the ONE
                     output buffer (``out``, allocated when not given), and
                     the two elements are read after the launch, outside the
                     accounted traffic as in the reference.
      rw_RtoW        passes * sum_w out_w[0,0] + unroll * sum_w
                     out_w[-1,-1]: the same rule for each of the W outputs
                     (the reference chains every output leaf).  The
                     ``torch`` oracle ``k_rw`` gives passes * v[0,0] + W *
                     unroll * v[-1,-1] instead, as the reference's xla
                     oracle does against its Pallas kernel.

    ``load`` > 0 (``latency_chase`` only — the bench spec gates it) builds
    the loaded-latency composite fn(perm, gen), time-shared as the
    reference's single-device backends run it: each of the ``passes`` probe
    passes is one chase launch, followed by ``load * GEN_SWEEPS_PER_PASS``
    load_sum sweeps of ``gen`` in one acc.cu launch; the two results chain
    through the accumulator.  Its value is the sum of the chase results and
    the generator sums.
    """
    base_mix, depth_eff = _split_mix(mix, depth)
    kw = dict(block_rows=block_rows, streams=streams, passes=passes,
              unroll=unroll)

    def _carried(*outs):
        f32 = torch.float32
        first = sum(o[0, 0].to(f32) for o in outs)
        last = sum(o[-1, -1].to(f32) for o in outs)
        return first * float(passes) + last * float(unroll)

    if base_mix == "triad":
        return lambda x, y, out=None: _carried(mb.triad(x, y, out, **kw))
    if base_mix == "copy":
        return lambda x, out=None: _carried(
            mb.copy(x, out, interleave=interleave, **kw))
    if base_mix.startswith("rw_"):
        reads, writes = get_mix(base_mix).rw
        return lambda x, *ys, outs=None: _carried(*mb.rw(
            x, *ys, reads=reads, writes=writes, outs=outs,
            interleave=interleave, **kw))
    if base_mix == "latency_chase" and load:
        sweeps = load * GEN_SWEEPS_PER_PASS
        tiling = dict(block_rows=block_rows, streams=streams)

        def fnl(perm, gen):
            acc = torch.zeros((), dtype=torch.float32, device=perm.device)
            for _ in range(passes):
                acc = acc + mb.chase(perm, **tiling)
                acc = acc + mb.load_sum(gen, passes=sweeps, unroll=unroll,
                                        **tiling)
            return acc
        return fnl
    if base_mix == "mxu":
        return lambda x, w=None: mb.mxu(x, w, **kw)
    return lambda x: mb.membench_call(x, mix=base_mix, depth=depth_eff,
                                      interleave=interleave, **kw)


def work_per_call(mix: str, x, depth: int = 8) -> tuple[float, float]:
    """(bytes, flops) moved/executed by one kernel invocation — straight from
    the shared mix registry."""
    from repro_torch.bench import mixes as mixreg
    name = mix
    if mix == "fma":
        name = f"fma_{depth}"
    m = mixreg.get_mix(name)
    return (m.bytes_per_pass(x.numel() * x.element_size()),
            m.flops_per_pass(x.numel()))
