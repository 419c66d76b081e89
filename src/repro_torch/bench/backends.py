"""Pluggable benchmark backends: the plain PyTorch oracles (``torch``) and the
hand-written CUDA kernels (``cuda``) — counterparts of the reference's ``xla``
and ``pallas`` backends (``repro.bench.backends``).

A Backend turns (BenchSpec, mix, working set, passes) into a zero-arg callable
that runs the timed work; the Runner serializes on the device afterwards.
Work accounting is NOT a backend concern — the Runner reads it from the shared
mix registry, so all backends report identical bytes/flops for the same spec
by construction.

The built-in backends split ``build`` into two halves so the Runner can cache
the first:

    make_case(spec, mix, shape, dtype, passes)   the per-knob callable —
        a pure function of the knobs and the buffer *shape*, never closing
        over a buffer.  This is where every divisibility rule is checked, so
        a bad knob surfaces while the Runner plans, before any timing.
    bind_case(case, spec, mix, x)                per-buffer binding —
        closes over the actual working set plus any companion buffers
        (triad's second read stream, the output buffer of copy / triad, the
        mxu operand, the rw family's extra read streams and W outputs, the
        chase's permutation buffer), all allocated here, outside the timed
        call, and dropped with the buffer.

Third-party backends only need ``build`` (the original protocol); the Runner
falls back to it, uncached, when ``make_case`` is absent.

The multi-device backends ``sharded`` (the devices of one process) and
``distributed`` (the devices of every process of a ``torch.distributed``
run) are the reference's: each shard of a 1-D mesh runs the ``torch``
backend's oracle case over its block of rows.  Their working sets are
``MeshBuffer``s, made shard by shard where each shard lives.
"""
from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

import torch

from repro_torch.bench.mixes import MixDef, get_mix, interleavable
from repro_torch.bench.spec import BenchSpec, BenchSpecError, knob_names
from repro_torch.obs import trace


#: BenchSpec fields that can NEVER change what make_case builds — either
#: they are explicit slots of the cache key already (mixes/sizes/dtype/
#: backend/passes resolve to the per-case key columns) or they only shape
#: the measurement around the case (repetition discipline, buffer fill
#: value, labels).  Everything else — including any FUTURE knob — is part of
#: the key by default: forgetting to classify a new field makes the cache
#: miss, never alias.
_NON_CASE_FIELDS = frozenset({
    "mixes", "sizes", "dtype", "backend", "passes",     # explicit key slots
    "reps", "warmup", "value", "target_bytes", "tags",  # measurement-only
})


def case_knobs(spec: BenchSpec) -> tuple:
    """(name, value) pairs of every spec field that can affect a case,
    derived from the dataclass fields (not an explicit list) so new knobs
    are cache-safe by construction."""
    import dataclasses
    return tuple((f.name, getattr(spec, f.name))
                 for f in dataclasses.fields(spec)
                 if f.name not in _NON_CASE_FIELDS)


def _gate(backend_name: str, rule: str) -> str:
    """Suffix naming the backend gate that rejected a knob combination, plus
    the valid knob names — so the error decodes without opening spec.py."""
    return (f" [gate: {rule}, raised by {backend_name}.validate; valid spec "
            f"knobs: {', '.join(knob_names())}]")


@runtime_checkable
class Backend(Protocol):
    """One way of executing a mix on a device."""
    name: str

    def supports(self, mix: MixDef) -> bool:
        """Can this backend run the mix at all (knobs aside)?"""
        ...

    def validate(self, spec: BenchSpec) -> None:
        """Raise BenchSpecError for knob combinations this backend can't run."""
        ...

    def build(self, spec: BenchSpec, mix: MixDef, x, passes: int
              ) -> Callable[[], object]:
        """Zero-arg callable running `passes` passes of `mix` over `x`."""
        ...


class _CaseBackend:
    """Shared make_case/bind_case machinery for the built-in backends."""
    multi_device = False     # True: accepts BenchSpec(devices > 1)

    def supports(self, mix: MixDef) -> bool:
        return self.name in mix.backends

    def case_key(self, spec: BenchSpec, mix: MixDef, shape, dtype,
                 passes: int) -> tuple:
        """Everything ``make_case`` depends on — the Runner's cache key.
        The knob columns derive from the FULL spec field set minus the
        measurement-only fields (``case_knobs``), so a future knob that
        changes a case can never alias a stale cached one."""
        return (self.name, mix.name, tuple(shape), str(dtype), passes,
                case_knobs(spec))

    def make_case(self, spec: BenchSpec, mix: MixDef, shape, dtype,
                  passes: int) -> Callable:
        raise NotImplementedError

    def prepare_buffer(self, spec: BenchSpec, x):
        """Per-size buffer placement hook, called once before binding that
        size's cases."""
        return x

    def bind_case(self, case: Callable, spec: BenchSpec, mix: MixDef, x
                  ) -> Callable[[], object]:
        return lambda: case(x)

    def abstract_args(self, spec: BenchSpec, mix: MixDef, shape, dtype
                      ) -> tuple:
        """Tensors matching ``make_case``'s positional buffers, on the
        ``meta`` device (shape and dtype, no storage): what
        ``repro_torch.istream`` runs a case on, so that no working set is
        built — but for the chase's int32 permutation buffer, a CPU tensor
        holding ``chase_perm`` (one cycle over the buffer), since its walk
        reads the values."""
        meta = torch.empty(tuple(shape), dtype=dtype, device="meta")
        if mix.chase:
            perm = _chase_buffer(torch.empty(tuple(shape), dtype=dtype), 1)
            return (perm, meta) if spec.load else (perm,)
        return (meta,) * self._arity(mix)

    def _arity(self, mix: MixDef) -> int:
        return _mix_arity(mix)

    def build(self, spec, mix, x, passes):
        case = self.make_case(spec, mix, x.shape, x.dtype, passes)
        return self.bind_case(case, spec, mix, self.prepare_buffer(spec, x))


def _validate_oracle_knobs(spec: BenchSpec, backend_name: str) -> None:
    """Knob rules of the core.instruction_mix oracles."""
    for m in spec.mixes:
        mix = get_mix(m)
        if "torch" not in mix.backends:
            raise BenchSpecError(f"mix {m!r} not supported on {backend_name}"
                                 + _gate(backend_name, "mix support"))
        if spec.streams > 1 and m != "load_sum":
            raise BenchSpecError(
                f"{backend_name} backend expresses streams>1 only for "
                f"load_sum (the strided-walk oracle); got mix {m!r}"
                + _gate(backend_name, "streams>1 needs the strided oracle"))
        if spec.block_rows is not None and m != "load_sum":
            raise BenchSpecError(
                f"{backend_name} backend expresses block_rows only for "
                f"load_sum (the blocked-walk oracle); got mix {m!r}"
                + _gate(backend_name, "block_rows needs the blocked oracle"))
        if spec.interleave > 1 and not interleavable(mix):
            raise BenchSpecError(
                f"mix {m!r} has no interleaved variant on {backend_name} "
                f"(interleave>1 needs independent per-chunk chains — "
                f"load_sum, copy, or the rw_RtoW family)"
                + _gate(backend_name, "interleave>1 needs an interleavable "
                                      "mix"))
    if spec.streams > 1 and spec.block_rows is not None:
        raise BenchSpecError(f"{backend_name} backend: streams and "
                             "block_rows are mutually exclusive knobs"
                             + _gate(backend_name,
                                     "streams xor block_rows"))
    if spec.interleave > 1 and (spec.streams > 1
                                or spec.block_rows is not None):
        raise BenchSpecError(
            f"{backend_name} backend: interleave>1 does not compose with "
            f"streams>1 or block_rows (the interleaved oracles walk the "
            f"whole buffer in row chunks)"
            + _gate(backend_name, "interleave xor streams/block_rows"))


def _mix_arity(mix: MixDef, load: int = 0) -> int:
    """Positional buffer count of a mix's oracle case (reads then writes)."""
    if mix.chase:
        return 2 if load else 1
    if mix.name == "triad":
        return 3
    if mix.rw is not None:
        return mix.rw[0] + mix.rw[1]
    return 1


def _chase_buffer(x, parts: int) -> torch.Tensor:
    """The int32 permutation buffer of a chase case, of x's shape, on x's
    device (``parts`` local cycles)."""
    from repro_torch.core.instruction_mix import chase_perm
    return torch.tensor(chase_perm(x.shape, parts), device=x.device)


def _mix_operands(mix: MixDef, x, place=None, load: int = 0,
                  parts: int = 1) -> tuple:
    """Every buffer a mix's oracle case consumes, in positional order, built
    OUTSIDE the timed call.  ``x`` passes through as-is; companion streams
    are triad's (a, c), the rw family's R-1 extra read streams and W write
    seeds, the chase probe's permutation buffer (``parts`` local cycles: one
    per mesh shard) plus ``x`` as the generator buffer when ``load`` > 0.
    ``place`` puts the permutation buffer, built on the host, where ``x``
    lives (None: on x's device; the mesh backends split it over the mesh
    and build the other companions shard by shard)."""
    if mix.chase:
        if place is None:
            perm = _chase_buffer(x, parts)
        else:
            from repro_torch.core.instruction_mix import chase_perm
            perm = place(chase_perm(tuple(x.shape), parts))
        return (perm, x) if load else (perm,)
    if mix.name == "triad":
        return (torch.zeros_like(x), x, x * 0.5)
    if mix.rw is not None:
        from repro_torch.core.instruction_mix import rw_streams
        reads, writes = mix.rw
        # the W write-seed slots only supply their number — k_rw overwrites
        # every output before reading it — so alias x rather than allocating
        # W buffers (peak footprint stays one working set + companions)
        return rw_streams(x, reads) + (x,) * writes
    return (x,)


def _oracle_case(spec: BenchSpec, mix: MixDef, rows: int, passes: int,
                 backend_name: str) -> Callable:
    """The per-shape oracle kernel for a mix, as its pass generator
    (``instruction_mix.stepped``; ``instruction_mix.drain`` runs it to its
    scalar).  A pure function of its inputs: triad takes (a, b, c), rw_RtoW
    its R+W stream buffers, latency_chase (perm) or (perm, gen), everything
    else takes x."""
    from repro_torch.core import instruction_mix as im
    unroll, interleave = spec.unroll, spec.interleave
    if passes % unroll:
        # the Runner rounds auto-picked passes up; a direct build() with
        # explicit passes surfaces here
        raise BenchSpecError(
            f"passes={passes} is not a multiple of unroll={unroll}"
            + _gate(backend_name, "passes % unroll == 0"))
    if interleave > 1 and rows % interleave:
        raise BenchSpecError(
            f"interleave {interleave} does not divide {rows} rows"
            + ("" if backend_name == "torch" else
               f" (the per-device shard on {backend_name})")
            + _gate(backend_name, "interleave | rows"))
    if mix.name == "load_sum" and spec.streams > 1:
        streams = spec.streams
        return lambda x: im.k_strided_sum.steps(x, streams, passes, unroll)
    if mix.name == "load_sum" and spec.block_rows is not None:
        brows = spec.block_rows
        if rows % brows:
            raise BenchSpecError(
                f"block_rows {brows} does not divide {rows} rows"
                + ("" if backend_name == "torch" else
                   f" (the per-device shard on {backend_name})"))
        return lambda x: im.k_blocked_sum.steps(x, brows, passes, unroll)
    if mix.chase:
        load = spec.load
        if load:
            # the single-device composite: probe + generators time-shared in
            # one timed call
            return lambda perm, gen: im.k_chase_loaded.steps(
                perm, gen, passes, unroll, load=load)
        return lambda perm: im.k_chase.steps(perm, passes, unroll)
    if mix.name == "triad":
        return lambda a, b, c: im.k_triad.steps(a, b, c, passes, unroll)
    if mix.rw is not None:
        reads = mix.rw[0]
        if interleave > 1:
            return lambda *bufs: im.k_rw_istream.steps(
                bufs[:reads], bufs[reads:], passes, unroll, interleave)
        return lambda *bufs: im.k_rw.steps(bufs[:reads], bufs[reads:],
                                           passes, unroll)
    name = mix.name
    return lambda x: im.run_mix.steps(name, x, passes, unroll=unroll,
                                      interleave=interleave)


def _bind_oracle_case(case: Callable, mix: MixDef, x, load: int = 0
                      ) -> Callable[[], object]:
    """Close an oracle case over its buffers; companion streams are built
    here, outside the timed call."""
    bufs = _mix_operands(mix, x, load=load)
    return lambda: case(*bufs)


class TorchBackend(_CaseBackend):
    """The plain PyTorch oracles from core.instruction_mix (any device)."""
    name = "torch"

    def validate(self, spec: BenchSpec) -> None:
        _validate_oracle_knobs(spec, self.name)

    def make_case(self, spec, mix, shape, dtype, passes):
        trace.event("backend.dispatch", backend=self.name, mix=mix.name,
                    load=spec.load)
        from repro_torch.core import instruction_mix as im
        steps = _oracle_case(spec, mix, shape[0], passes, self.name)
        return lambda *bufs: im.drain(steps(*bufs))

    def bind_case(self, case, spec, mix, x):
        return _bind_oracle_case(case, mix, x, load=spec.load)


class CudaBackend(_CaseBackend):
    """The hand-written CUDA kernels (kernels/membench) with explicit tiling.

    On a CUDA tensor every case launches its kernel; on a CPU tensor (the
    tests) the wrappers take their plain versions.  ``BenchSpec.interpret``
    has no meaning here and is ignored.
    """
    name = "cuda"

    def _resolve(self, spec: BenchSpec, rows: int) -> int:
        from repro_torch.kernels.membench import membench as mb
        if spec.block_rows is not None:
            return spec.block_rows       # explicit knob: never adjusted
        return mb.default_block_rows(rows, spec.streams)

    def validate(self, spec: BenchSpec) -> None:
        from repro_torch.kernels.membench import membench as mb
        for m in spec.mixes:
            mix = get_mix(m)
            if not self.supports(mix):
                raise BenchSpecError(f"mix {m!r} not supported on cuda"
                                     + _gate(self.name, "mix support"))
            if spec.interleave > 1 and not interleavable(mix):
                raise BenchSpecError(
                    f"mix {m!r} has no interleaved variant on cuda "
                    f"(interleave>1 needs independent per-chunk chains — "
                    f"load_sum, copy, or the rw_RtoW family)"
                    + _gate(self.name, "interleave>1 needs an "
                                       "interleavable mix"))
        if spec.unroll not in mb.UNROLLS:
            raise BenchSpecError(
                f"unroll {spec.unroll} is not one of {mb.UNROLLS} (the cuda "
                f"kernels unroll the pass loop at compile time)"
                + _gate(self.name, "unroll in compiled set"))
        if spec.interleave not in mb.INTERLEAVES:
            raise BenchSpecError(
                f"interleave {spec.interleave} is not one of "
                f"{mb.INTERLEAVES} (the cuda kernels keep the chains in "
                f"registers)" + _gate(self.name, "interleave in compiled set"))
        if spec.dtype not in ("float32", "bfloat16"):
            raise BenchSpecError(
                f"dtype {spec.dtype!r}: the cuda kernels take float32 or "
                f"bfloat16" + _gate(self.name, "dtype"))

    def make_case(self, spec, mix, shape, dtype, passes):
        from repro_torch.kernels.membench import ops as mb_ops
        rows = self._resolve(spec, shape[0])
        if rows > shape[0] or shape[0] % rows:
            raise BenchSpecError(
                f"block_rows {rows} does not divide {shape[0]} rows")
        n_blocks = shape[0] // rows
        if n_blocks % spec.streams:
            raise BenchSpecError(
                f"streams {spec.streams} does not divide {n_blocks} blocks")
        if passes % spec.unroll:
            raise BenchSpecError(
                f"passes={passes} is not a multiple of unroll={spec.unroll}"
                + _gate(self.name, "passes % unroll == 0"))
        if spec.interleave > 1 and rows % spec.interleave:
            raise BenchSpecError(
                f"interleave {spec.interleave} does not divide the "
                f"{rows}-row tile"
                + _gate(self.name, "interleave | block_rows"))
        trace.event("backend.dispatch", backend=self.name, mix=mix.name,
                    block_rows=rows, load=spec.load)
        return mb_ops.make_timed_kernel(
            mix.name, depth=mix.fma_depth or 8, block_rows=rows,
            streams=spec.streams, passes=passes, unroll=spec.unroll,
            interleave=spec.interleave, load=spec.load)

    def _arity(self, mix):
        """fn(x), fn(x, y) for triad, fn(x, *extra_read_streams) for rw."""
        if mix.name == "triad":
            return 2
        if mix.rw is not None:
            return mix.rw[0]
        return 1

    def bind_case(self, case, spec, mix, x):
        # companions and outputs are allocated here, outside the timed call
        if mix.chase:
            # one pointer cycle per tile: the kernel walks each tile's
            # TILE-LOCAL cycle, the tiles one after another
            from repro_torch.kernels.membench import membench as mb
            rows = self._resolve(spec, x.shape[0])
            perm = _chase_buffer(x, x.shape[0] // rows)
            # the wrapper's one check of this buffer, paid here so that no
            # timed call pays it (even with warmup 0)
            mb.check_chase_perm(perm, rows)
            if spec.load:
                return lambda: case(perm, x)
            return lambda: case(perm)
        if mix.rw is not None:
            from repro_torch.core.instruction_mix import rw_streams
            ys = rw_streams(x, mix.rw[0])[1:]
            outs = tuple(torch.empty_like(x) for _ in range(mix.rw[1]))
            return lambda: case(x, *ys, outs=outs)
        if mix.name == "triad":
            y, out = x * 0.5, torch.empty_like(x)
            return lambda: case(x, y, out=out)
        if mix.name == "copy":
            out = torch.empty_like(x)
            return lambda: case(x, out=out)
        if mix.name == "mxu":
            w = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
            return lambda: case(x, w)
        return lambda: case(x)


class MeshBuffer:
    """A (rows, lanes) buffer split into row blocks, one a mesh shard:
    ``shards[i]`` is block i on its shard's device.  A process of a
    distributed run holds only its own shards, so ``shards`` maps shard
    index -> tensor and may hold fewer than the mesh has.  ``shape`` is the
    whole buffer's."""

    def __init__(self, shape, shards: dict):
        self.shape = tuple(shape)
        self.shards = dict(shards)


class _MeshOracleBackend(_CaseBackend):
    """Shared machinery for backends that run the instruction-mix oracles
    per shard of a 1-D device mesh (``sharded`` on one process's devices,
    ``distributed`` on every process's devices).

    Subclasses choose the layout: which shards this process holds and on
    which of its devices (``_layout``).  ``make_case`` — the ``torch``
    backend's oracle case on each shard, the scalars summed on the first
    shard's device in shard order — is the same for both, so bytes/flops
    parity across torch / sharded / distributed holds by construction (the
    Runner reads accounting from the shared mix registry, never from the
    backend).  The shards' pass loops are enqueued pass-major
    (``instruction_mix.pass_major``), as the reference's ``shard_map`` runs them side by
    side.  A ``latency_chase`` walk on a CUDA shard launches ``chase.cu``
    (``_probe_steps``), the one kernel a mesh runs; on the CPU it is the
    oracle's host walk.  The device pool is that of the Runner's device
    (``core.device.device_pool``): every visible GPU, or the logical CPU
    devices ``REPRO_TORCH_CPU_DEVICES`` asks for.  A mesh larger than the
    pool raises; no shard is put elsewhere to make up the count.
    """
    multi_device = True

    def supports(self, mix: MixDef) -> bool:
        # mixes._BACKEND_ALIASES maps sharded/distributed -> torch (single
        # source of truth for which mixes the oracles implement)
        return mix.supports(self.name)

    def _pool(self, k: int, device) -> list:
        """The first k devices of the pool of ``device``'s kind."""
        from repro_torch.core.device import CPU_DEVICES_ENV, device_pool
        dev = torch.device(device)
        pool = device_pool(dev)
        if k > len(pool):
            fix = (f"set {CPU_DEVICES_ENV}=N for N logical CPU devices"
                   if dev.type == "cpu" else
                   "a mesh never puts two shards on one GPU")
            raise BenchSpecError(
                f"devices={k} exceeds the {len(pool)} visible device(s) of "
                f"{dev.type}; {fix}")
        if dev.type == "cuda" and (dev.index or 0) != 0:
            raise BenchSpecError(
                f"the {self.name} mesh starts at cuda:0 and the run "
                f"serializes there; run on cuda (cuda:0), not {dev}")
        return pool[:k]

    def _layout(self, k: int, device) -> dict:
        """shard index -> device, for the shards this process holds."""
        return dict(enumerate(self._pool(k, device)))

    def validate(self, spec: BenchSpec) -> None:
        _validate_oracle_knobs(spec, self.name)
        if spec.load and spec.devices != spec.load + 1:
            raise BenchSpecError(
                f"{self.name} backend places the latency probe on shard 0 "
                f"and each of the {spec.load} generator(s) on its own "
                f"sibling shard: need devices == load + 1 "
                f"({spec.load + 1}), got devices={spec.devices}"
                + _gate(self.name, "devices == load + 1"))

    def check_devices(self, spec: BenchSpec, device) -> None:
        """The Runner's device-count check, before any buffer is made."""
        self._layout(spec.devices, device)

    def working_set(self, spec: BenchSpec, nbytes: int, dtype, device
                    ) -> MeshBuffer:
        """The working set, each shard made on its own device (the fill
        repeats row by row), so no device ever holds more than its shard."""
        from repro_torch.core import buffers
        k = spec.devices
        rows, lanes = buffers.working_set_shape(nbytes, dtype)
        self._check_rows(rows, k)
        layout = self._layout(k, device)
        trace.event("mesh.place", backend=self.name, mesh_shape=[k],
                    devices=[str(layout[i]) for i in sorted(layout)])
        return MeshBuffer((rows, lanes), {
            i: buffers.working_block(rows // k, lanes, dtype, spec.value, d)
            for i, d in layout.items()})

    def _check_rows(self, rows: int, k: int) -> None:
        if rows % k:
            raise BenchSpecError(
                f"devices={k} does not divide the {rows}-row working set")

    def _split(self, a, k: int, device) -> MeshBuffer:
        """A whole buffer (tensor or host array) -> its row blocks on this
        process's shards."""
        rows = a.shape[0]
        self._check_rows(rows, k)
        r = rows // k
        layout = self._layout(k, device)
        if isinstance(a, torch.Tensor):
            shards = {i: a[i * r:(i + 1) * r].to(d)
                      for i, d in layout.items()}
        else:
            shards = {i: torch.tensor(a[i * r:(i + 1) * r], device=d)
                      for i, d in layout.items()}
        return MeshBuffer(a.shape, shards)

    def prepare_buffer(self, spec, x):
        """A whole tensor (a direct ``build``) is split over the mesh of its
        device's kind; a ``MeshBuffer`` from ``working_set`` is placed
        already."""
        if isinstance(x, MeshBuffer):
            return x
        return self._split(x, spec.devices, x.device)

    def _reduce(self, total: torch.Tensor) -> torch.Tensor:
        """The cross-process step of a rep (none on one process)."""
        return total

    def make_case(self, spec, mix, shape, dtype, passes):
        from repro_torch.core import instruction_mix as im
        k = spec.devices
        rows = shape[0]
        self._check_rows(rows, k)
        composite = bool(mix.chase and spec.load)
        # dispatch provenance: which backend, what mesh shape, and whether a
        # generator co-schedule is composed in (the loaded-latency split)
        trace.event("backend.dispatch", backend=self.name, mix=mix.name,
                    mesh_shape=[k], load=spec.load, composite=composite)
        if mix.chase:
            # every shard walks its own pointer cycle (_probe_steps); in the
            # composite only shard 0 does (the probe), while every sibling
            # shard runs load_sum sweeps over its block of the generator
            # buffer — spatial co-scheduling, not the single-device
            # time-shared emulation
            from repro_torch.bench.mixes import GEN_SWEEPS_PER_PASS
            if passes % spec.unroll:
                raise BenchSpecError(
                    f"passes={passes} is not a multiple of "
                    f"unroll={spec.unroll}"
                    + _gate(self.name, "passes % unroll == 0"))
            gen_passes = passes * GEN_SWEEPS_PER_PASS
            unroll = spec.unroll

            def shard_case(i):
                if composite and i:
                    return lambda perm, gen: im.k_load_sum.steps(gen,
                                                                 gen_passes)
                return lambda perm, *gen: _probe_steps(perm, passes, unroll)
        else:
            one = _oracle_case(spec, mix, rows // k, passes, self.name)

            def shard_case(i):
                return one
        reduce = self._reduce

        def case(*bufs):
            held = sorted(bufs[0].shards)
            # pass-major: pass p of every shard is enqueued before pass p+1
            # of any, each on its own device with no sync between them, so
            # every device has work queued after one pass's enqueue, not
            # after every pass of the shards before it.  In the composite
            # the probe comes last in each round: on the CPU its walk runs
            # on the host, so the generators' passes go first
            order = ([i for i in held if i] + [0]
                     if composite and 0 in held else held)
            out = im.pass_major({i: shard_case(i)(*(b.shards[i]
                                                    for b in bufs))
                                 for i in order})
            total = out[held[0]]
            for i in held[1:]:      # shard order, on the first shard's device
                total = total + out[i].to(total.device)
            return reduce(total)
        return case

    def bind_case(self, case, spec, mix, x):
        # companions live outside the timed call, shard by shard where x's
        # shards live; the chase's permutation buffer (one cycle a shard) is
        # built on the host and split like x, and on a CUDA shard checked
        # here for chase.cu, once, so that no timed call pays for it
        k = spec.devices
        if mix.chase:
            dev = x.shards[min(x.shards)].device
            bufs = _mix_operands(mix, x,
                                 place=lambda a: self._split(a, k, dev),
                                 load=spec.load, parts=k)
            for perm in bufs[0].shards.values():
                if perm.device.type == "cuda":
                    from repro_torch.kernels.membench import membench as mb
                    mb.check_chase_perm(perm, perm.shape[0])
        else:
            per = {i: _mix_operands(mix, t) for i, t in x.shards.items()}
            n = len(per[min(per)])
            bufs = tuple(MeshBuffer(x.shape, {i: per[i][j] for i in per})
                         for j in range(n))
        return lambda: case(*bufs)


def _probe_steps(perm: torch.Tensor, passes: int, unroll: int):
    """One mesh shard's chase walk over its cycle, as a pass generator.  On
    a CUDA shard it launches ``chase.cu`` once a pass, the whole shard one
    tile (one thread follows the shard's one cycle: the nearest counterpart
    of the reference's on-device ``fori_loop`` walk); the passes' results
    are summed in pass order, as ``membench.chase`` sums them.  On the CPU
    it is the torch oracle's host walk (``k_chase``).  Each pass starts at
    0 on the card and carries ``j`` on the host; on a ``chase_perm`` cycle,
    which returns to 0, both give 0.0."""
    from repro_torch.core import instruction_mix as im
    if perm.device.type != "cuda":
        return (yield from im.k_chase.steps(perm, passes, unroll))
    from repro_torch.kernels.membench import membench as mb
    acc = torch.zeros((), dtype=torch.float32, device=perm.device)
    for _ in range(passes):
        acc = acc + mb.chase(perm, block_rows=perm.shape[0])
        yield
    return acc


class ShardedBackend(_MeshOracleBackend):
    """The working set spread over the first k devices of a 1-D mesh.

    Reproduces the paper's Figure-4 core-count scaling study (aggregate
    bandwidth vs cores until the memory interface saturates): each device
    runs the *same* instruction-mix oracle the torch backend runs, over its
    shard — so every mix that runs on ``torch`` runs sharded, with identical
    bytes/flops accounting by construction.  ``BenchSpec(devices=k)`` picks
    the mesh size; at ``devices=1`` this is the torch backend plus the mesh
    bookkeeping.
    """
    name = "sharded"


class DistributedBackend(_MeshOracleBackend):
    """The sharded oracle-per-shard machinery over the **global** devices of
    a multi-process run (``torch.distributed``) — the paper's Fig-4 scaling
    study taken past one process.

    The ``devices`` knob is unchanged: it counts *global* mesh devices, so a
    spec that ran ``sharded`` on 4 devices runs ``distributed`` on two
    processes of 2 byte for byte (same accounting, same per-shard cases).
    What differs from ``sharded``:

    * the pool: every process's devices, round-robin across processes, and
      each process makes only its own shards;
    * the serialization point: every rep ends with an ``all_reduce`` of the
      processes' partial sums (the reference's trailing cross-shard
      ``.sum()``), and afterwards ``bench.distributed.gather_result`` merges
      the per-process timings into one BenchResult on every process;
      process 0 saves it.

    Initialization (``bench.distributed.ensure_initialized``) comes first —
    the CLI's ``run`` / ``launch`` do this.  Outside an initialized run this
    backend is ``sharded`` exactly.
    """
    name = "distributed"

    def _global_pool(self, device) -> list[tuple[int, int]]:
        """(process, local device index) of the global devices, round-robin
        across processes — ``devices=k`` spreads the mesh as evenly as the
        process topology allows (k=2 on 2x2 is one device per process, not
        two on process 0), so a Fig-4 sweep over intermediate counts crosses
        processes instead of filling one."""
        from repro_torch.bench import distributed as dist
        counts = dist.local_device_counts(device)
        return [(p, i) for i in range(max(counts))
                for p in range(len(counts)) if i < counts[p]]

    def _layout(self, k: int, device) -> dict:
        from repro_torch.bench import distributed as dist
        if dist.process_count() == 1:
            return super()._layout(k, device)
        gpool = self._global_pool(device)
        if k > len(gpool):
            raise BenchSpecError(
                f"devices={k} exceeds the {len(gpool)} global device(s) of "
                f"{dist.process_count()} processes")
        # SPMD needs every process inside the mesh: a process owning no
        # shard has nothing to time — fail with the fix
        missing = sorted(set(range(dist.process_count()))
                         - {p for p, _ in gpool[:k]})
        if missing:
            raise BenchSpecError(
                f"devices={k} leaves process(es) {missing} with no mesh "
                f"shard; use devices >= one per process or launch fewer "
                f"processes")
        me = dist.process_index()
        local = self._pool(max(i for p, i in gpool if p == me) + 1, device)
        return {s: local[i] for s, (p, i) in enumerate(gpool[:k]) if p == me}

    def _reduce(self, total):
        from repro_torch.bench import distributed as dist
        if dist.is_initialized():
            import torch.distributed as tdist
            tdist.all_reduce(total.reshape(1))  # in place, through the view
        return total


_BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    _BACKENDS[backend.name] = backend
    return backend


register_backend(TorchBackend())
register_backend(ShardedBackend())
register_backend(DistributedBackend())
register_backend(CudaBackend())


def get_backend(name: str) -> Backend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_BACKENDS)}"
        ) from None


def available_backends() -> list[str]:
    return sorted(_BACKENDS)
