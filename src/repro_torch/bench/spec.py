"""BenchSpec — one benchmark point-set as a frozen, serializable declaration.

The paper treats every measurement as the product of (instruction mix x
working-set size x access pattern x repetition discipline).  A BenchSpec *is*
that product: a validated, hashable, JSON-round-trippable configuration that
the Runner executes on any registered backend.  Knob -> paper mapping:

    sizes        C1  working-set sweep across the memory hierarchy
    mixes        C2  instruction-mix ladder (see repro_torch.bench.mixes; incl. the
                 parameterized rw_RtoW read/write-ratio family — validation
                 resolves family members through the registry's get_mix, so a
                 bad R:W surfaces as BenchSpecError before any timing)
    streams      C3  interleaved address streams (addressing-mode overhead)
    block_rows   C4  rows per load step (LD1D/LD2D/LD4D analogue)
    devices      Fig 4  working set spread over the first k devices
                 (multi-device backends only; none is registered in this
                 package yet, so ``devices > 1`` is refused)
    unroll       §5  per-pass unroll factor: the measurement loop body holds
                 ``unroll`` chained sweeps per trip (fewer loop-control ops
                 per byte moved — the decode-width probe)
    interleave   §5  independent dependence chains per sweep: the working set
                 is split into ``interleave`` row chunks, each with its own
                 accumulator, combined only after the sweep (shortens the
                 dependence critical path without changing bytes/flops)
    load         Mess-style loaded latency: number of bandwidth-generator
                 streams co-scheduled with a ``latency_chase`` probe in ONE
                 timed composite (0 = idle probe).  Requires every mix in
                 the spec to be a chase mix; on the mesh backends the probe
                 runs on shard 0 and each generator on its own sibling
                 shard, so ``devices`` must equal ``load + 1``
    reps/warmup/passes   the serialized-timing repetition discipline (§4/§5)

``unroll`` and ``interleave`` vary instruction pressure and ILP at *constant*
accounting, so bandwidth-bound points can be told from instruction-bound ones.

The fields, defaults, error wording and ``spec_version`` are those of
``repro.bench.spec``: a spec JSON written by either package loads in the
other (``repro_torch.convert`` maps the backend names).  The device is NOT
a spec field — it is an argument of the Runner — and ``interpret`` is kept
only so the JSON keeps its keys; this package ignores it.

spec_version history: 1 = original knob set; 2 = adds ``devices`` (older
files load with the single-device default); 3 = adds ``unroll`` /
``interleave`` (the instruction-stream knobs; older files load with 1/1);
4 = adds ``load`` (co-scheduled bandwidth generators for loaded-latency
composites; older files load with the idle default 0).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path

from repro_torch.bench import mixes as mixreg

SPEC_VERSION = 4


class BenchSpecError(ValueError):
    """Invalid BenchSpec field or unsupported knob/backend combination."""


def knob_names() -> tuple[str, ...]:
    """Every valid BenchSpec field name, sorted — error messages list these
    so an unknown/invalid knob is decodable without opening this file."""
    return tuple(sorted(f.name for f in dataclasses.fields(BenchSpec)))


@dataclass(frozen=True)
class BenchSpec:
    """Declarative benchmark configuration (frozen; use ``.replace()``)."""
    mixes: tuple[str, ...] = ("load_sum",)
    sizes: tuple[int, ...] = (32 * 2**10, 1 * 2**20, 16 * 2**20)
    dtype: str = "float32"
    backend: str = "torch"
    block_rows: int | None = None     # None = backend default tiling
    streams: int = 1
    devices: int = 1                  # mesh devices (multi-device backends)
    unroll: int = 1                   # sweeps per measurement-loop trip
    interleave: int = 1               # independent dependence chains / sweep
    load: int = 0                     # co-scheduled bandwidth generators
    passes: int | None = None         # None = auto from target_bytes
    target_bytes: float = 2e8         # auto pass-picking: bytes per timed call
    reps: int = 10
    warmup: int = 2
    value: float = 1.234567           # buffer init value (denormal-avoiding)
    interpret: bool = True            # kept for JSON parity; ignored here
    tags: tuple[str, ...] = ()        # free-form labels carried into results

    # -- validation ---------------------------------------------------------
    def __post_init__(self):
        # coerce lists (e.g. from JSON) to tuples so the spec stays hashable
        for f in ("mixes", "sizes", "tags"):
            v = getattr(self, f)
            if isinstance(v, list):
                object.__setattr__(self, f, tuple(v))
        self.validate()

    def validate(self) -> None:
        # late import: backends.py imports this module for BenchSpecError
        from repro_torch.bench.backends import get_backend
        try:
            backend = get_backend(self.backend)
        except KeyError as e:
            raise BenchSpecError(str(e)) from None
        if not self.mixes:
            raise BenchSpecError("spec needs at least one mix")
        for m in self.mixes:
            try:
                mix = mixreg.get_mix(m)
            except KeyError as e:
                raise BenchSpecError(str(e)) from None
            if not backend.supports(mix):
                raise BenchSpecError(
                    f"mix {m!r} is not supported by backend "
                    f"{self.backend!r} (declared: {mix.backends})")
            if self.load > 0 and not mix.chase:
                raise BenchSpecError(
                    f"load={self.load} co-schedules bandwidth generators "
                    f"around a latency probe, so every mix must be a chase "
                    f"mix (e.g. 'latency_chase'); got {m!r}")
        if not self.sizes or any(int(s) <= 0 for s in self.sizes):
            raise BenchSpecError(f"sizes must be positive ints: {self.sizes}")
        if self.streams < 1:
            raise BenchSpecError(f"streams must be >= 1: {self.streams}")
        if self.devices < 1:
            raise BenchSpecError(f"devices must be >= 1: {self.devices}")
        if self.devices > 1 and not getattr(backend, "multi_device", False):
            raise BenchSpecError(
                f"backend {self.backend!r} runs on a single device; "
                f"devices={self.devices} needs a multi-device backend "
                f"(e.g. 'sharded')")
        if self.block_rows is not None and (
                self.block_rows < 1 or self.block_rows % 8):
            raise BenchSpecError(
                f"block_rows must be a positive multiple of 8 (so tiles "
                f"line up with the reference's): {self.block_rows}")
        if self.unroll < 1:
            raise BenchSpecError(f"unroll must be >= 1: {self.unroll}")
        if self.interleave < 1:
            raise BenchSpecError(
                f"interleave must be >= 1: {self.interleave}")
        if self.load < 0:
            raise BenchSpecError(f"load must be >= 0: {self.load}")
        if self.passes is not None and self.passes < 1:
            raise BenchSpecError(f"passes must be >= 1: {self.passes}")
        if self.passes is not None and self.passes % self.unroll:
            raise BenchSpecError(
                f"passes={self.passes} must be a multiple of "
                f"unroll={self.unroll} (the measurement loop runs whole "
                f"unrolled bodies); drop passes to let the Runner round up")
        if self.reps < 1 or self.warmup < 0:
            raise BenchSpecError(
                f"need reps >= 1, warmup >= 0: {self.reps}, {self.warmup}")
        if self.target_bytes <= 0:
            raise BenchSpecError(f"target_bytes must be > 0: {self.target_bytes}")
        from repro_torch.core.buffers import as_dtype
        try:
            as_dtype(self.dtype)
        except TypeError as e:
            raise BenchSpecError(f"bad dtype {self.dtype!r}: {e}") from None

    # -- convenience --------------------------------------------------------
    def replace(self, **kw) -> "BenchSpec":
        return dataclasses.replace(self, **kw)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for f in ("mixes", "sizes", "tags"):   # JSON-canonical (round-trips)
            d[f] = list(d[f])
        d["spec_version"] = SPEC_VERSION
        return d

    def to_json(self, path: str | Path | None = None) -> str:
        s = json.dumps(self.to_dict(), indent=2, sort_keys=True)
        if path is not None:
            Path(path).write_text(s)
        return s

    @classmethod
    def from_dict(cls, d: dict) -> "BenchSpec":
        d = dict(d)
        ver = d.pop("spec_version", SPEC_VERSION)
        if ver > SPEC_VERSION:
            raise BenchSpecError(
                f"spec_version {ver} is newer than supported {SPEC_VERSION}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise BenchSpecError(
                f"unknown spec fields: {sorted(unknown)}; valid fields: "
                f"{list(knob_names())}")
        return cls(**d)

    @classmethod
    def from_json(cls, src: str | Path) -> "BenchSpec":
        """Accepts a Path, a path string, or an inline JSON object string
        (anything starting with '{'); a mistyped path raises
        FileNotFoundError rather than a JSON parse error."""
        if isinstance(src, Path):
            text = src.read_text()
        else:
            s = str(src)
            text = s if s.lstrip().startswith("{") else Path(s).read_text()
        return cls.from_dict(json.loads(text))


def quick_spec(backend: str = "torch", **kw) -> BenchSpec:
    """The --quick preset: small sizes, few reps, light pass target."""
    base = dict(mixes=("load_sum", "copy", "fma_8"),
                sizes=(32 * 2**10, 256 * 2**10, 2 * 2**20),
                reps=3, warmup=1, target_bytes=2e7, backend=backend)
    base.update(kw)
    return BenchSpec(**base)
