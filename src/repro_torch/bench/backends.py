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
        mxu operand), all allocated here, outside the timed call, and
        dropped with the buffer.

Third-party backends only need ``build`` (the original protocol); the Runner
falls back to it, uncached, when ``make_case`` is absent.

The multi-device backends of the reference (``sharded``, ``distributed``)
have no counterpart here yet: none is registered, and ``BenchSpec`` refuses
``devices > 1``.
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


def _mix_operands(mix: MixDef, x) -> tuple:
    """Every buffer a mix's oracle case consumes, in positional order, built
    OUTSIDE the timed call.  ``x`` passes through as-is; triad gets its
    companion streams (a, c)."""
    if mix.name == "triad":
        return (torch.zeros_like(x), x, x * 0.5)
    return (x,)


def _oracle_case(spec: BenchSpec, mix: MixDef, rows: int, passes: int,
                 backend_name: str) -> Callable:
    """The per-shape oracle kernel for a mix (pure function of its inputs;
    triad takes (a, b, c), everything else takes x)."""
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
            + _gate(backend_name, "interleave | rows"))
    if mix.name == "load_sum" and spec.streams > 1:
        streams = spec.streams
        return lambda x: im.k_strided_sum(x, streams, passes, unroll)
    if mix.name == "load_sum" and spec.block_rows is not None:
        brows = spec.block_rows
        if rows % brows:
            raise BenchSpecError(
                f"block_rows {brows} does not divide {rows} rows")
        return lambda x: im.k_blocked_sum(x, brows, passes, unroll)
    if mix.name == "triad":
        return lambda a, b, c: im.k_triad(a, b, c, passes, unroll)
    name = mix.name
    return lambda x: im.run_mix(name, x, passes, unroll=unroll,
                                interleave=interleave)


def _bind_oracle_case(case: Callable, mix: MixDef, x
                      ) -> Callable[[], object]:
    """Close an oracle case over its buffers; companion streams are built
    here, outside the timed call."""
    bufs = _mix_operands(mix, x)
    return lambda: case(*bufs)


class TorchBackend(_CaseBackend):
    """The plain PyTorch oracles from core.instruction_mix (any device)."""
    name = "torch"

    def validate(self, spec: BenchSpec) -> None:
        _validate_oracle_knobs(spec, self.name)

    def make_case(self, spec, mix, shape, dtype, passes):
        trace.event("backend.dispatch", backend=self.name, mix=mix.name,
                    load=spec.load)
        return _oracle_case(spec, mix, shape[0], passes, self.name)

    def bind_case(self, case, spec, mix, x):
        return _bind_oracle_case(case, mix, x)


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
        return mb.default_block_rows(rows)

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
            interleave=spec.interleave)

    def bind_case(self, case, spec, mix, x):
        # companions and outputs are allocated here, outside the timed call
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


_BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    _BACKENDS[backend.name] = backend
    return backend


register_backend(TorchBackend())
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
