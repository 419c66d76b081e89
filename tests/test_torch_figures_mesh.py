"""fig4 (the devices sweep on the ``sharded`` mesh and, multi-process, on
``distributed``) and ``scripts_torch/launch_distributed.py`` of the port:
the declared specs against the reference's ``run_curve``, ``--smoke`` as a
program on 4 logical CPU devices and on 2 x 2 over gloo, the accounting of
the reference's registry, and the launcher check that keeps a worker from
respawning (torchrun's ``WORLD_SIZE`` included)."""
import json
import os
import subprocess
import sys

import pytest

import benchmarks.fig4_scaling as ref_fig4
import benchmarks_torch.fig4_scaling as fig4
import repro.bench
import repro_torch.bench
from _figures import ROOT, ROW, Stop, row_names, same_specs
from repro.bench.mixes import get_mix as ref_get_mix
from repro_torch.core.device import CPU_DEVICES_ENV



@pytest.mark.parametrize("quick,smoke", [(True, False), (False, False),
                                         (False, True)])
@pytest.mark.parametrize("backend", ["sharded", "distributed"])
def test_fig4_declares_the_reference_specs(monkeypatch, quick, smoke,
                                           backend):
    """The devices sweep's specs and the triad reference's, recorded from
    the reference's ``run_curve`` and from the port's, at devices 1, 2, 4
    (the reference's ``xla`` triad is the port's ``torch``)."""
    per_dev, reps = fig4.sizes_for(quick, smoke)
    counts = (1, 2, 4) if backend == "sharded" else (2, 4)
    logs = []
    for pkg, mod, kw in ((repro.bench, ref_fig4, {}),
                         (repro_torch.bench, fig4, {"device": "cpu"})):
        log = []

        class Recording(pkg.Runner):
            def run_many(self, specs, *a, **k):
                log.extend(specs)
                return None

            def run(self, spec, *a, **k):
                log.append(spec)
                raise Stop

        monkeypatch.setattr(pkg, "Runner", Recording)
        with pytest.raises(Stop):
            mod.run_curve(backend, per_dev, counts, reps, **kw)
        logs.append(log)
    same_specs(*logs)
    assert logs[1][-1].backend == ("torch" if backend == "sharded"
                                   else backend)


def _fig4_cpu(args, devices: int | None = 4, **env):
    """``python -m benchmarks_torch.fig4_scaling`` as a program, on the
    CPU, with ``devices`` logical devices; (exit code, stdout)."""
    e = {k: v for k, v in os.environ.items()
         if k not in fig4.LAUNCHER_ENV and k != CPU_DEVICES_ENV}
    e.update(PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
             OMP_NUM_THREADS="1", **env)
    if devices is not None:
        e[CPU_DEVICES_ENV] = str(devices)
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks_torch.fig4_scaling", "--smoke",
         "--device", "cpu", *args], cwd=ROOT, env=e, capture_output=True,
        text=True, timeout=300)
    return out.returncode, out.stdout + out.stderr


def test_fig4_smoke_on_four_cpu_devices():
    rc, out = _fig4_cpu([])
    assert rc == 0, out
    assert row_names(out) == ["fig4/devices1", "fig4/devices2",
                              "fig4/devices4", "fig4/stream_triad_1dev"]
    assert "speedup=1.00x;processes=1" in out


def test_fig4_distributed_smoke_on_gloo():
    rc, out = _fig4_cpu(["--distributed", "--processes", "2",
                         "--devices-per-process", "2"], devices=None)
    assert rc == 0, out
    # process 0 emits the gathered rows: the covering counts of 2 x 2
    assert row_names(out) == ["fig4_dist/devices2", "fig4_dist/devices4",
                          "fig4_dist/stream_triad_2dev"]
    assert all(line.startswith("[p0] ") for line in out.splitlines()
               if ROW.match(line))
    assert "processes=2" in out


def test_fig4_sharded_run_matches_the_reference_accounting(monkeypatch,
                                                           capsys):
    """In process, on 4 logical CPU devices: every point's accounting is
    the reference registry's for its spec."""
    monkeypatch.setenv(CPU_DEVICES_ENV, "4")
    per_dev, reps = fig4.sizes_for(smoke=True)
    res = fig4.run_curve("sharded", per_dev, (1, 2, 4), reps, "cpu")
    out = capsys.readouterr().out
    assert row_names(out)[:3] == [f"fig4/devices{k}" for k in (1, 2, 4)]
    for p in res.points:
        mix = ref_get_mix(p.mix)
        assert p.nbytes == per_dev * p.devices and p.passes == 4
        assert p.bytes_per_call == mix.bytes_per_pass(p.nbytes) * p.passes
        assert p.flops_per_call == mix.flops_per_pass(p.nbytes // 4) \
            * p.passes


@pytest.mark.parametrize("name", ["REPRO_COORDINATOR", "MASTER_ADDR",
                                  "MASTER_PORT", "REPRO_NUM_PROCESSES",
                                  "WORLD_SIZE"])
def test_fig4_launcher_check_keys_on_the_port_env_names(monkeypatch, name):
    from repro_torch.bench import distributed as dist
    assert set(fig4.LAUNCHER_ENV) == \
        set(dist.ENV_COORDINATOR) | set(dist.ENV_NUM_PROCESSES)
    for k in fig4.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not fig4.under_launcher()
    monkeypatch.setenv(name, "1")
    assert fig4.under_launcher()


def test_fig4_does_not_respawn_under_world_size_alone(monkeypatch, capsys):
    """torchrun's WORLD_SIZE (here without a coordinator) marks a worker:
    ``--distributed`` runs the worker role in this process and never calls
    the launcher (the reference's infinite-respawn trap)."""
    from repro_torch.bench import distributed as dist
    for k in fig4.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")

    def respawn(*a, **kw):
        raise AssertionError("fig4 respawned under WORLD_SIZE")
    monkeypatch.setattr(dist, "launch_local", respawn)
    assert fig4.main(smoke=True, distributed=True, device="cpu") == 0
    assert row_names(capsys.readouterr().out) == [
        "fig4_dist/devices1", "fig4_dist/stream_triad_1dev"]


def test_fig4_distributed_needs_two_processes(capsys):
    assert fig4.main(smoke=True, distributed=True, processes=1,
                     device="cpu") == 2
    assert "--processes >= 2" in capsys.readouterr().err



def test_launch_distributed_script_on_gloo(tmp_path):
    out = tmp_path / "launch.json"
    e = {k: v for k, v in os.environ.items() if k not in fig4.LAUNCHER_ENV}
    e.pop(CPU_DEVICES_ENV, None)
    r = subprocess.run([sys.executable, str(ROOT / "scripts_torch" /
                                            "launch_distributed.py"),
                        "--processes", "2", "--devices-per-process", "2",
                        "--device", "cpu", "--", "--mixes", "load_sum",
                        "--sizes", "64K", "--reps", "2", "--no-ledger",
                        "--out", str(out)], cwd=tmp_path, env=e,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(out.read_text())
    assert doc["machine"]["process_count"] == 2
    assert [p["devices"] for p in doc["points"]] == [4]
    assert {p["backend"] for p in doc["points"]} == {"distributed"}
