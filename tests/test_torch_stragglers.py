"""The port's straggler probe and step-time monitor
(``repro_torch.ft.stragglers``) against the reference's, and the
characterization example (``examples_torch/characterize_machine.py``), on
the CPU.

``probe_devices`` times a load_sum per device with ``time.perf_counter_ns``;
the same deterministic clock is patched into both modules (the port on 4
logical CPU devices, the reference in one subprocess on 4 forced host
devices), so both compute their GB/s, z-scores and flags from the same
durations and must agree exactly: the arithmetic is the same float64 numpy
code on both sides.  ``StepTimer`` is pure Python float64 on both sides,
compared exactly on seeded series with outliers."""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.buffers import working_set as ref_working_set
from repro.core.instruction_mix import run_mix as ref_run_mix
from repro.ft import stragglers as ref_st
from repro_torch.convert import tensor_from_reference
from repro_torch.core.device import CPU_DEVICES_ENV
from repro_torch.ft import stragglers as st

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
N_DEV, NBYTES, PASSES, REPS = 4, 64 * 2**10, 2, 3
#: ns of each (device, rep): device 2 is the slow one
DURATIONS = np.random.default_rng(7).integers(
    900_000, 1_100_000, (N_DEV, REPS)) + np.array([[0], [0], [900_000], [0]])
THRESHOLDS = (-3.0, -1.0)


def clock_ticks() -> list[int]:
    """The values a probe reads, in order: per device, per rep, t0 and t1."""
    ticks, now = [], 10**12
    for d in range(N_DEV):
        for r in range(REPS):
            ticks += [now, now + int(DURATIONS[d, r])]
            now += 5 * 10**6
    return ticks


REF_SNIPPET = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
import json, types
from repro.ft import stragglers
out = {}
for z in %r:
    stragglers.time = types.SimpleNamespace(
        perf_counter_ns=iter(%r).__next__)
    out[str(z)] = [[p.gbps, p.z_score, bool(p.is_straggler)]
                   for p in stragglers.probe_devices(
                       nbytes=%d, passes=%d, reps=%d, z_threshold=z)]
print(json.dumps(out))
""" % (N_DEV, THRESHOLDS, clock_ticks(), NBYTES, PASSES, REPS)


@pytest.fixture(scope="module")
def reference_probes():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SNIPPET],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("z", THRESHOLDS)
def test_probe_devices_matches_the_reference(reference_probes, monkeypatch,
                                             z):
    monkeypatch.setenv(CPU_DEVICES_ENV, str(N_DEV))
    monkeypatch.setattr(st, "time", types.SimpleNamespace(
        perf_counter_ns=iter(clock_ticks()).__next__))
    got = st.probe_devices(nbytes=NBYTES, passes=PASSES, reps=REPS,
                           z_threshold=z, device="cpu")
    assert [p.device for p in got] == [f"cpu:{i}" for i in range(N_DEV)]
    assert [[p.gbps, p.z_score, bool(p.is_straggler)] for p in got] == \
        reference_probes[str(z)]
    # the slow device is flagged at the tighter threshold only
    assert [p.is_straggler for p in got] == [False, False, z == -1.0, False]


def test_probe_devices_times_every_device(monkeypatch):
    """Unpatched: one probe a logical device, positive GB/s, z-scores that
    sum to zero."""
    monkeypatch.setenv(CPU_DEVICES_ENV, "3")
    got = st.probe_devices(nbytes=NBYTES, passes=1, reps=2, device="cpu")
    assert len(got) == 3 and all(p.gbps > 0 for p in got)
    assert abs(sum(p.z_score for p in got)) < 1e-6


@pytest.mark.parametrize("passes", [1, 3])
def test_the_probed_sum_is_the_reference_load_sum(passes):
    """What a CPU probe computes: the load_sum oracle, the reference's
    value on the same working set (a float32 sum in another order: the
    oracles' tolerance, n x 1.3e-7 x passes)."""
    x = ref_working_set(NBYTES)
    got = float(st.load_sum_fn(tensor_from_reference(np.asarray(x)),
                               passes)())
    want = float(ref_run_mix("load_sum", x, passes))
    assert abs(got - want) <= max(x.size * 1.3e-7 * passes, 1e-4)


def test_device_probe_keeps_the_reference_fields():
    import dataclasses
    assert [f.name for f in dataclasses.fields(st.DeviceProbe)] == \
        [f.name for f in dataclasses.fields(ref_st.DeviceProbe)]


def _series(seed: int, n: int = 200) -> list[float]:
    rng = np.random.default_rng(seed)
    dt = 0.1 + 0.002 * rng.standard_normal(n)
    dt[rng.choice(np.arange(10, n), 6, replace=False)] *= 3.0   # outliers
    return [float(v) for v in dt]


@pytest.mark.parametrize("seed,alpha,z", [(0, 0.05, 4.0), (1, 0.05, 3.0),
                                          (2, 0.2, 4.0)])
def test_step_timer_matches_the_reference(seed, alpha, z):
    a, b = st.StepTimer(alpha=alpha, z_threshold=z), \
        ref_st.StepTimer(alpha=alpha, z_threshold=z)
    flags = [(a.update(i, dt), b.update(i, dt))
             for i, dt in enumerate(_series(seed))]
    assert all(x == y for x, y in flags)
    assert any(x for x, _ in flags)          # the outliers are seen
    assert (a.mean, a.var, a.n, a.slow_steps) == \
        (b.mean, b.var, b.n, b.slow_steps)


def test_step_timer_flags_outlier():
    t = st.StepTimer(z_threshold=3.0)
    for i in range(20):
        t.update(i, 0.1 + 0.001 * (i % 3))
    assert t.update(20, 1.0) is True        # 10x step time => straggler
    assert t.slow_steps and t.slow_steps[-1][0] == 20


def test_characterize_example_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable,
                        str(ROOT / "examples_torch" /
                            "characterize_machine.py"), "--device", "cpu",
                        "--out-dir", str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "== per-device probe (straggler check) ==" in r.stdout
    assert "cpu:0:" in r.stdout
    for name in ("fitted_machine_model.json", "machine_model_host.json",
                 "characterize_sweep.json"):
        assert (tmp_path / name).stat().st_size > 0, name


def test_without_a_gpu_the_probe_raises_naming_the_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="--device cpu"):
        st.probe_devices(nbytes=NBYTES)
