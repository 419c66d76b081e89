"""Straggler detection — the paper's σ-reporting discipline, weaponized
(counterpart of ``repro.ft.stragglers``).

Arm-membench reports the standard deviation of every measurement series; a
slow HBM stack / downclocked card shows up as a per-device throughput
outlier long before it shows up as a failed step.  ``probe_devices`` runs
the membench load_sum kernel *per device* and flags outliers: on a CUDA
device that is ``acc.cu``'s load_sum, one launch a rep (its ``passes``
sweeps inside the launch), with no fallback; on the CPU the plain oracle
(``instruction_mix.run_mix``).  ``StepTimer`` watches live step times for
drift (mid-run stragglers).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import buffers
from repro_torch.core.device import device_pool


@dataclass
class DeviceProbe:
    device: str
    gbps: float
    z_score: float
    is_straggler: bool


def load_sum_fn(x, passes: int):
    """fn() -> 0-dim float32: ``passes`` load_sum sweeps of x on the device
    x lies on, synchronised: one ``acc.cu`` launch on a CUDA device, the
    plain oracle (``run_mix``, which drains its pass generator) on the
    CPU."""
    import torch

    if x.device.type == "cuda":
        from repro_torch.kernels.membench import membench as mb
        from repro_torch.kernels.membench.ops import make_timed_kernel
        kernel = make_timed_kernel(
            "load_sum", block_rows=mb.default_block_rows(x.shape[0]),
            passes=passes)

        def run():
            out = kernel(x)
            torch.cuda.synchronize(x.device)
            return out
        return run
    from repro_torch.core.instruction_mix import run_mix
    return lambda: run_mix("load_sum", x, passes)


def probe_devices(nbytes: int = 4 * 2**20, passes: int = 4, reps: int = 5,
                  z_threshold: float = -3.0, device=None) -> list[DeviceProbe]:
    """Per-device load throughput over ``core.device.device_pool(device)``
    (None = ``cuda``: every visible GPU); z < -3 (slower than fleet) flags
    straggler."""
    results = []
    for i, dev in enumerate(device_pool(device)):
        x = buffers.working_set(nbytes, device=dev)
        run = load_sum_fn(x, passes)
        run()  # warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter_ns()
            run()
            times.append((time.perf_counter_ns() - t0) / 1e9)
        gbps = nbytes * passes / np.mean(times) / 1e9
        results.append([f"{dev.type}:{i}", gbps])
    vals = np.array([r[1] for r in results])
    mu, sd = vals.mean(), vals.std() + 1e-12
    return [DeviceProbe(device=r[0], gbps=r[1], z_score=(r[1] - mu) / sd,
                        is_straggler=(r[1] - mu) / sd < z_threshold)
            for r in results]


@dataclass
class StepTimer:
    """Online step-time monitor: EWMA + σ band; flags drift mid-run."""
    alpha: float = 0.05
    z_threshold: float = 4.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    slow_steps: list = field(default_factory=list)

    def update(self, step: int, dt: float) -> bool:
        if self.n < 5:  # burn-in
            self.mean = (self.mean * self.n + dt) / (self.n + 1)
            self.var = self.var * 0.5 + (dt - self.mean) ** 2 * 0.5
            self.n += 1
            return False
        sd = max(self.var ** 0.5, 1e-9)
        is_slow = (dt - self.mean) / sd > self.z_threshold
        if is_slow:
            self.slow_steps.append((step, dt))
        self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
        self.var = ((1 - self.alpha) * self.var
                    + self.alpha * (dt - self.mean) ** 2)
        self.n += 1
        return is_slow
