"""The instruction-mix registry — C2 of the paper, declared exactly once.

Arm-membench's central idea is that the *same* data stream measured under
different instruction mixes (LOAD-only / LOAD+FADD / LOAD+NOP) attributes the
bottleneck.  Every mix this package knows — run through the plain PyTorch
oracles (backend ``torch``) *or* the hand-written CUDA kernels (backend
``cuda``) — is declared here, with its own bytes/flops accounting, so the two
backends can never disagree about what a measurement means.  The names and
formulas are those of the JAX reference package's registry (``xla`` there is
``torch`` here, ``pallas`` is ``cuda``); a parity test holds them equal.

    mix            ops/element     Armv8 analogue
    ``load_only``  0               pure LD1D loop (cuda-only: the kernel
                                   makes loads the compiler may not delete;
                                   plain tensor code has no such load)
    ``load_sum``   1 add           the FADD accumulation loop
    ``copy``       1 store         STREAM-copy (write path exercised)
    ``triad``      2 flops         STREAM-triad a = b + s*c (2 reads, 1 write)
    ``fma_k``      2k flops        NOP-substitution ladder: k-deep dependent
                                   FMA chain; the knee is the measured ridge
    ``mxu``        2*128 flops     one 128x128 matmul per tile (matrix-unit
                                   saturation)
    ``rw_RtoW``    2(R-1) flops    parameterized R:W load/store-ratio family
                                   (store-path attribution): R read streams
                                   combined triad-style, stored to W write
                                   streams — copy == rw_1to1, triad == rw_2to1
    ``latency_chase``  0           dependent-chain pointer walk: every load's
                                   address comes from the previous load, so
                                   time per step is access *latency*, not
                                   bandwidth; the probe half of the
                                   Mess-style loaded-latency composite
                                   (``BenchSpec.load`` adds generators)

The ``rw_RtoW`` family is generated by one shared formula (``rw_ratio``):
``bytes_per_pass = (R + W) * nbytes`` and ``flops_per_pass = 2(R-1) * n`` —
the (R-1) mul+add pairs that fold R read streams into one value.  The
registry lists a canonical ladder (``RW_RATIOS``); any ``rw_RtoW`` with
R, W in 1..``MAX_RW`` resolves through ``get_mix``, like the fma family.

Consumers: ``repro_torch.bench.backends`` (kernel dispatch),
``repro_torch.bench.runner`` (work accounting),
``repro_torch.kernels.membench.ops.work_per_call`` (accounting view).

The declared formulas here are *paper-logical* — the traffic the algorithm
needs, the GB/s denominators.

Every mix runs on both backends except ``load_only`` (``cuda`` only), as in
the reference.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

FMA_DEPTHS = (1, 2, 4, 8, 16, 32, 64)

#: canonical registered R:W ladder (reads, writes); get_mix accepts any
#: rw_RtoW with both sides in 1..MAX_RW
RW_RATIOS = ((1, 2), (1, 1), (2, 1), (3, 1), (4, 1))
MAX_RW = 8
#: no leading zeros: a spelling like rw_01to1 must NOT resolve, or the
#: BenchPoint.mix it produces would not match the name the spec asked for
_RW_NAME = re.compile(r"rw_([1-9]\d*)to([1-9]\d*)\Z")

#: the coefficient folding each extra read stream into the store value
#: (v = s0 + c*s1 + ... — triad's scale constant); shared by the triad and
#: rw oracles and their kernels
RW_COMBINE_COEF = 1.5

#: full-buffer sweeps each co-scheduled bandwidth generator performs per
#: probe pass in a loaded-latency composite (``BenchSpec.load`` > 0).  A
#: Mess-style generator runs for the *duration* of the probe; on a
#: serialized substrate that duration is emulated by a fixed generator:probe
#: work ratio — one sweep is vectorized and ~100x cheaper than the serial
#: chase walk, so a single sweep per pass would be invisible in the latency
#: signal.  Shared by the torch/cuda composites and the Runner's
#: generator-GB/s accounting — declared ONCE here so they cannot disagree.
GEN_SWEEPS_PER_PASS = 16

#: backends of a mix that both the oracles and the kernels run
_BOTH = ("torch", "cuda")

# execution aliases: the sharded/distributed backends run the torch oracles
# per shard, so a mix runnable on torch is runnable on both (same oracles,
# same accounting)
_BACKEND_ALIASES = {"sharded": "torch", "distributed": "torch"}


@dataclass(frozen=True)
class MixDef:
    """One instruction mix: name + per-element work accounting + backends."""
    name: str
    flops_per_elem: float          # arithmetic per element per pass
    reads_per_elem: float = 1.0
    writes_per_elem: float = 0.0
    backends: tuple[str, ...] = _BOTH
    fma_depth: int = 0             # chain depth for the fma family
    rw: tuple[int, int] | None = None   # (reads, writes) for the rw family
    chase: bool = False            # dependent-chain latency probe?
    description: str = ""

    def bytes_per_pass(self, nbytes: int) -> float:
        return (self.reads_per_elem + self.writes_per_elem) * nbytes

    def flops_per_pass(self, n_elems: int) -> float:
        return self.flops_per_elem * n_elems

    def supports(self, backend: str) -> bool:
        return _BACKEND_ALIASES.get(backend, backend) in self.backends


def rw_name(reads: int, writes: int) -> str:
    return f"rw_{reads}to{writes}"


def interleavable(mix: "MixDef") -> bool:
    """Does the mix have an independent-chains (``interleave`` > 1) kernel
    variant?  Declared ONCE here — both backends read it (the variants live
    in core.instruction_mix ``k_*_istream`` and the membench kernels' chunked
    bodies)."""
    return mix.name in ("load_sum", "copy") or mix.rw is not None


def rw_ratio(reads: int = 1, writes: int = 1) -> MixDef:
    """The parameterized R:W family — ONE shared accounting formula.

    Per element per pass: R stream reads + W stream writes (so
    ``bytes_per_pass = (R + W) * nbytes``) and the 2(R-1) flops that combine
    the R read streams triad-style (``v = s0 + 1.5*s1 + ... + 1.5*s_{R-1}``)
    before storing ``v`` to each of the W write streams.  The formula
    generalizes the fixed mixes: ``rw_1to1`` accounts exactly like ``copy``
    and ``rw_2to1`` exactly like ``triad``.
    """
    if not (1 <= reads <= MAX_RW and 1 <= writes <= MAX_RW):
        raise ValueError(
            f"rw_ratio needs 1 <= reads, writes <= {MAX_RW} (each stream is "
            f"a full working-set buffer): got ({reads}, {writes})")
    return MixDef(
        rw_name(reads, writes),
        flops_per_elem=2.0 * (reads - 1),
        reads_per_elem=float(reads), writes_per_elem=float(writes),
        rw=(reads, writes),
        description=f"{reads} read : {writes} write streams "
                    f"(store-path attribution, R:W = {reads}:{writes})")


def _build_registry() -> dict[str, MixDef]:
    out = {
        "load_only": MixDef(
            "load_only", 0.0, backends=("cuda",),
            description="pure data movement; one lane feeds the accumulator"),
        "load_sum": MixDef(
            "load_sum", 1.0,
            description="load + accumulate (the FADD loop)"),
        "copy": MixDef(
            "copy", 0.0, reads_per_elem=1.0, writes_per_elem=1.0,
            description="STREAM copy: read stream + write stream"),
        "triad": MixDef(
            "triad", 2.0, reads_per_elem=2.0, writes_per_elem=1.0,
            description="STREAM triad a = b + s*c"),
        "mxu": MixDef(
            "mxu", 2.0 * 128.0,
            description="one (rows,128)@(128,128) matmul per tile"),
        "latency_chase": MixDef(
            "latency_chase", 0.0, reads_per_elem=1.0, writes_per_elem=0.0,
            chase=True,
            description="dependent-chain pointer walk (latency probe): each "
                        "load's address is the previous load's value, so no "
                        "two loads overlap — time/step IS access latency; "
                        "compose with BenchSpec.load bandwidth generators "
                        "for Mess-style loaded-latency curves"),
    }
    for k in FMA_DEPTHS:
        out[f"fma_{k}"] = MixDef(
            f"fma_{k}", 2.0 * k, fma_depth=k,
            description=f"{k}-deep dependent FMA chain per element")
    for r, w in RW_RATIOS:
        out[rw_name(r, w)] = rw_ratio(r, w)
    return out


_REGISTRY: dict[str, MixDef] = _build_registry()


def registry() -> dict[str, MixDef]:
    """name -> MixDef for every known mix (shared, do not mutate)."""
    return dict(_REGISTRY)


def get_mix(name: str) -> MixDef:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("fma_"):
        # the fma family is open-ended: any positive chain depth is a valid
        # mix (registry() lists only the canonical ladder)
        try:
            k = int(name.split("_", 1)[1])
        except ValueError:
            k = 0
        if k >= 1:
            return MixDef(name, 2.0 * k, fma_depth=k,
                          description=f"{k}-deep dependent FMA chain per element")
    if name.startswith("rw_"):
        # like fma, the rw family is open-ended within 1..MAX_RW per side
        m = _RW_NAME.match(name)
        if m:
            try:
                return rw_ratio(int(m.group(1)), int(m.group(2)))
            except ValueError as e:
                raise KeyError(str(e)) from None
    raise KeyError(f"unknown mix {name!r}; known: {sorted(_REGISTRY)}")


def _sort_key(m: MixDef) -> tuple:
    """Deterministic listing order: families sort by their parameter (fma by
    depth, rw by R:W ratio) inside their alphabetic slot, everything else by
    name — CLI output no longer depends on registration order."""
    if m.rw is not None:
        return ("rw", m.rw[0] / m.rw[1], m.name)
    if m.fma_depth:
        return ("fma", float(m.fma_depth), m.name)
    return (m.name, 0.0, m.name)


def mix_names(backend: str | None = None) -> list[str]:
    """All mix names, optionally only those a given backend supports, in
    deterministic order (sorted by family parameter, then name)."""
    return [m.name for m in sorted(_REGISTRY.values(), key=_sort_key)
            if backend is None or m.supports(backend)]
