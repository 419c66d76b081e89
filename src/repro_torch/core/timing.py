"""Serialized timing harness — the CNTVCT + DSB SY/ISB discipline, on PyTorch.

The paper reads the generic timer with data/instruction barriers and reports the
cumulative mean over one hundred internal repetitions (§4/§5).  Here:
serialization = ``torch.cuda.synchronize(device)`` after the call on a CUDA
device (a launch returns before the device finishes; nothing counts as done
until all device work is visible), and nothing extra on the CPU, where eager
PyTorch is synchronous; repetition = ``reps`` timed calls after ``warmup``
untimed ones; the report carries the running cumulative mean and the standard
deviation (the paper reports σ for every plot).  The reported time is host
wall clock (``perf_counter_ns``), as in ``repro.core.timing``.

A launch costs far more than a cache-resident pass, so kernels take an
*internal pass count*: they loop over the buffer inside one launch exactly
like membench's measurement loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.obs import trace


@dataclass
class TimingResult:
    times_s: list[float]
    bytes_per_call: float = 0.0
    flops_per_call: float = 0.0

    @property
    def mean_s(self) -> float:
        return float(np.mean(self.times_s))

    @property
    def std_s(self) -> float:
        return float(np.std(self.times_s))

    @property
    def min_s(self) -> float:
        return float(np.min(self.times_s))

    @property
    def cumulative_mean_s(self) -> list[float]:
        c = np.cumsum(self.times_s) / np.arange(1, len(self.times_s) + 1)
        return [float(x) for x in c]

    @property
    def gbps(self) -> float:
        return self.bytes_per_call / self.mean_s / 1e9 if self.mean_s else 0.0

    @property
    def gflops(self) -> float:
        return self.flops_per_call / self.mean_s / 1e9 if self.mean_s else 0.0

    def samples(self, limit: int | None = None) -> tuple[float, ...]:
        """The raw per-rep timings (last ``limit`` when bounded) — what the
        result schema retains per point (``BenchPoint.rep_times_s``) so a
        downstream consumer (the run ledger's noise test) can compute CIs
        instead of trusting the mean triple.  The public (mean, std, min)
        triple is untouched: it is still computed over ALL reps."""
        times = self.times_s if limit is None else self.times_s[-limit:]
        return tuple(float(t) for t in times)

    def summary(self) -> dict:
        return {"mean_s": self.mean_s, "std_s": self.std_s, "min_s": self.min_s,
                "reps": len(self.times_s), "gbps": self.gbps,
                "gflops": self.gflops,
                "rel_std": self.std_s / self.mean_s if self.mean_s else 0.0}


def _serializer(device):
    """The serialization point for ``device``: a full device synchronize on
    CUDA (the DSB SY / ISB analogue), a no-op on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def time_fn(fn, *args, reps: int = 20, warmup: int = 3,
            bytes_per_call: float = 0.0, flops_per_call: float = 0.0,
            device=None) -> TimingResult:
    """Time ``fn(*args)`` on ``device`` (None = ``cuda``); every timed call
    ends at the device's serialization point."""
    # BenchSpec validates these for Runner callers; direct callers (legacy
    # sweep/autotune paths, notebooks) used to sail through to np.mean([]) —
    # a RuntimeWarning and a NaN TimingResult instead of an error
    if reps < 1:
        raise ValueError(f"reps must be >= 1: {reps}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0: {warmup}")
    sync = _serializer(device)
    tr = trace.get_tracer()
    if tr.enabled:
        # traced path: one span around the warmup block (first call holds
        # any kernel build), one per timed rep.  A separate branch, not a
        # conditional inside the loop: the disabled path below is the
        # byte-identical original loop, so tracing OFF adds zero overhead
        # to the timed reps (guarded by a no-op benchmark test).
        with tr.span("timing.warmup", cat="timing", reps=warmup):
            if warmup:
                fn(*args)
                for _ in range(warmup - 1):
                    fn(*args)
                sync()
        times = []
        for i in range(reps):
            with tr.span("timing.rep", cat="timing", rep=i):
                t0 = time.perf_counter_ns()
                fn(*args)
                sync()
                times.append((time.perf_counter_ns() - t0) / 1e9)
        return TimingResult(times, bytes_per_call, flops_per_call)
    if warmup:                 # warmup=0 is valid: first timed rep is cold
        fn(*args)
        for _ in range(warmup - 1):
            fn(*args)
        sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn(*args)
        sync()                            # the DSB SY / ISB analogue
        times.append((time.perf_counter_ns() - t0) / 1e9)
    return TimingResult(times, bytes_per_call, flops_per_call)
