"""Multi-device scaling API — a thin wrapper over ``repro_torch.bench``.

Counterpart of ``repro.core.scaling``.  The paper's Figure 4 (bandwidth vs
cores) is served by the ``sharded`` backend: ``BenchSpec(backend="sharded",
devices=k)`` places the working set across the first k devices of a 1-D mesh
and runs the shared mix registry's oracles per shard.  ``scaling_curve``
owns no measurement loop — it declares one BenchSpec per device count and
lets the Runner execute them through ``run_many``.  New code should use
``repro_torch.bench`` directly; BenchResult carries the ``devices`` knob per
point plus schema/machine metadata this view lacks.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ScalingPoint:
    devices: int
    mix: str
    nbytes_total: int
    mean_s: float
    gbps: float
    speedup: float = 1.0


def scaling_curve(nbytes_per_device: int, mix: str = "load_sum",
                  device_counts=None, passes: int = 8, reps: int = 8,
                  backend: str = "sharded", runner=None):
    """Weak-scaling sweep: ``nbytes_per_device * k`` total bytes on k devices,
    speedup relative to the first device count measured.  ``backend`` may be
    ``"distributed"`` inside an initialized multi-process run (the counts
    then span *global* devices and must cover every process; timings are
    gathered so the curve is identical on all processes).  ``runner=None``
    makes a ``Runner()`` on the default device (``cuda``); the default
    counts are the ladder values the runner's device pool covers."""
    from repro_torch.bench import BenchSpec, Runner
    from repro_torch.bench import distributed as dist
    from repro_torch.core.device import device_pool
    runner = runner or Runner()
    if device_counts is None:
        device_counts = (
            dist.covering_device_counts(device=runner.device)
            if backend == "distributed" else
            [d for d in dist.DEVICE_LADDER
             if d <= len(device_pool(runner.device))])
    specs = [BenchSpec(mixes=(mix,), sizes=(nbytes_per_device * k,),
                       backend=backend, devices=k, passes=passes,
                       reps=reps, warmup=2)
             for k in device_counts]
    res = dist.gather_result(runner.run_many(specs))
    return [ScalingPoint(devices=p.devices, mix=p.mix, nbytes_total=p.nbytes,
                         mean_s=p.mean_s, gbps=p.gbps, speedup=rel)
            for p, rel in res.baseline_relative(group_key=lambda p: p.mix)]
