"""Legacy hierarchy-sweep API — a thin wrapper over ``repro_torch.bench``.

``run_sweep`` builds a BenchSpec and hands it to the Runner (the package's
one measurement loop); SweepPoint/SweepResult remain as the pre-``bench``
result schema for existing artifacts and callers.  New code should use
``repro_torch.bench.BenchSpec`` + ``Runner`` directly — BenchResult carries
schema_version, backend, and machine metadata that this legacy schema lacks.

Counterpart of ``repro.core.sweep``: the same schema, with this package's
plain-PyTorch ``torch`` backend where the reference runs ``xla``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path

import torch

from repro_torch.bench.runner import pick_passes  # noqa: F401  (legacy re-export)


@dataclass
class SweepPoint:
    nbytes: int
    mix: str
    dtype: str
    passes: int
    mean_s: float
    std_s: float
    gbps: float
    gflops: float


@dataclass
class SweepResult:
    points: list[SweepPoint] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def by_mix(self, mix: str) -> list[SweepPoint]:
        return [p for p in self.points if p.mix == mix]

    def to_json(self, path: str | Path):
        Path(path).write_text(json.dumps(
            {"meta": self.meta, "points": [asdict(p) for p in self.points]},
            indent=2))

    @staticmethod
    def from_json(path: str | Path) -> "SweepResult":
        d = json.loads(Path(path).read_text())
        return SweepResult([SweepPoint(**p) for p in d["points"]], d["meta"])

    @staticmethod
    def from_bench(res) -> "SweepResult":
        """Downgrade a repro_torch.bench.BenchResult to the legacy schema."""
        return SweepResult(
            points=[SweepPoint(nbytes=p.nbytes, mix=p.mix, dtype=p.dtype,
                               passes=p.passes, mean_s=p.mean_s, std_s=p.std_s,
                               gbps=p.gbps, gflops=p.gflops)
                    for p in res.points],
            meta=dict(res.meta))


def run_sweep(sizes: list[int] | None = None,
              mix_names: list[str] | None = None,
              dtype=torch.float32,
              reps: int = 10,
              target_bytes: float = 2e8,
              value: float | None = None,
              device=None) -> SweepResult:
    """Run the legacy sweep on the ``torch`` backend on ``device`` (None =
    ``cuda``, which raises where there is no CUDA device)."""
    from repro_torch.bench import BenchSpec, Runner
    from repro_torch.core import buffers
    sizes = sizes or buffers.sizes_logspace(16 * 2**10, 64 * 2**20,
                                            per_decade=6)
    spec = BenchSpec(
        mixes=tuple(mix_names or ("load_sum", "copy", "fma_8")),
        sizes=tuple(sizes), dtype=buffers.dtype_name(dtype), backend="torch",
        reps=reps, warmup=2, target_bytes=target_bytes,
        value=buffers.DEFAULT_VALUE if value is None else value)
    return SweepResult.from_bench(Runner(device=device).run(spec))
