"""The port's collective study (``repro_torch.core.collective_bench``,
``repro_torch.launch.mesh``, ``benchmarks_torch.collective_bench_main``)
against the reference's, on the CPU.

One launch of 8 gloo processes on the (data, model) = (2, 4) mesh runs
``bench_all`` at 64 KiB, shared by the module; the reference runs the same
call in one subprocess on 8 forced host devices.  In both, ``time_fn`` is
wrapped so that it records the collective's output before it times it (a
patch of a name in the child process: nothing of either package changes),
and the global outputs are compared value for value.  The sums of the
``init_pattern`` rows add n equal float32 values in the library's order
(2v and 4v are exact, the 3v on the way to 4v rounds), so each output is
held to n float32 ulps of the reference's.  Workers get one thread each."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks_torch import collective_bench_main as cbm
from benchmarks_torch import run as run_mod
from repro.core import collective_bench as ref_cb
from repro_torch.bench import distributed as dist
from repro_torch.core import collective_bench as cb
from repro_torch.core.device import CPU_DEVICES_ENV
from repro_torch.launch import mesh as mesh_mod

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
NBYTES = 64 * 2**10
SHAPE, AXES = (2, 4), ("data", "model")
#: the output of each op is split over the axis (row i on the rank at
#: coordinate i) but for all_gather's, which every rank holds whole
REPLICATED = {"all_gather"}
ENV_ALL = (dist.ENV_COORDINATOR + dist.ENV_NUM_PROCESSES
           + dist.ENV_PROCESS_ID)


def _clean_env(**extra):
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    for k in ("XLA_FLAGS", CPU_DEVICES_ENV) + ENV_ALL:
        env.pop(k, None)
    env.update(extra)
    return env


PORT_WORKER = r"""
import dataclasses, json, sys
import numpy as np
from repro_torch.bench import distributed as dist
from repro_torch.core import collective_bench as cb
from repro_torch.launch.mesh import make_mesh

out = sys.argv[1]
dist.ensure_initialized("cpu")
mesh = make_mesh(%r, %r, device="cpu")
outputs = []
time_fn = cb.timing.time_fn


def recording(fn, *args, **kw):
    outputs.append(fn(*args).clone().numpy())
    return time_fn(fn, *args, **kw)


cb.timing.time_fn = recording
res = cb.bench_all(mesh, nbytes=%d, reps=2)
rank = dist.process_index()
np.savez(f"{out}/rank{rank}.npz", *outputs)
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump({"coords": mesh.coords, "ranks": mesh.ranks,
               "results": [dataclasses.asdict(r) for r in res]}, f)
""" % (SHAPE, AXES, NBYTES)

REF_SNIPPET = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import numpy as np
from repro.core import collective_bench as cb
from repro.launch.mesh import make_mesh

out = sys.argv[1]
mesh = make_mesh(%r, %r)
outputs = []
time_fn = cb.timing.time_fn


def recording(fn, *args, **kw):
    outputs.append(np.asarray(fn(*args)))
    return time_fn(fn, *args, **kw)


cb.timing.time_fn = recording
res = cb.bench_all(mesh, nbytes=%d, reps=2)
np.savez(f"{out}/ref.npz", *outputs)
with open(f"{out}/ref.json", "w") as f:
    json.dump({"device_ids": [[d.id for d in row] for row in mesh.devices],
               "results": [dataclasses.asdict(r) for r in res]}, f)
""" % (SHAPE, AXES, NBYTES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 8 ranks and the reference's 8 devices, once."""
    out = tmp_path_factory.mktemp("collectives")
    ref = subprocess.run([sys.executable, "-c", REF_SNIPPET, str(out)],
                         capture_output=True, text=True, env=_clean_env(),
                         timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]

    class Sink(list):
        def write(self, s):
            self.append(s)

        def flush(self):
            pass
    sink = Sink()
    rc = dist.launch_local([sys.executable, "-c", PORT_WORKER, str(out)],
                           processes=8, env=_clean_env(), timeout=300,
                           stream_to=sink, device="cpu")
    assert rc == 0, "".join(sink)[-4000:]
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(8)]
    outs = [np.load(out / f"rank{r}.npz") for r in range(8)]
    ref_out = np.load(out / "ref.npz")
    ref = json.loads((out / "ref.json").read_text())
    n_cases = len(ref["results"])
    return dict(
        ranks=ranks, ref=ref,
        outs=[[o[f"arr_{i}"] for i in range(n_cases)] for o in outs],
        ref_outs=[ref_out[f"arr_{i}"] for i in range(n_cases)])


def _global_output(runs, case: int):
    """The port's global output of one (axis, op) case, assembled from the
    ranks as the reference's out_specs lay it out; every rank that holds
    the same part holds the same values."""
    res = runs["ranks"][0]["results"][case]
    axis, n = res["axis"], res["group_size"]
    parts = {}
    for r, info in enumerate(runs["ranks"]):
        key = 0 if res["op"] in REPLICATED else info["coords"][axis]
        got = runs["outs"][r][case]
        if key in parts:
            np.testing.assert_array_equal(got, parts[key])
        parts[key] = got
    if res["op"] in REPLICATED:
        return parts[0]
    return np.concatenate([parts[i] for i in range(n)], axis=0)


def test_ring_factor_matches_the_reference():
    for op in cb.OPS:
        for n in range(1, 9):
            assert cb._ring_factor(op, n) == ref_cb._ring_factor(op, n)


def test_mesh_lays_ranks_out_as_the_reference_lays_devices(runs):
    """Row-major: the rank at (data d, model m) is the device the
    reference's mesh holds at [d, m]; each axis group is that line."""
    ids = runs["ref"]["device_ids"]
    for r, info in enumerate(runs["ranks"]):
        d, m = info["coords"]["data"], info["coords"]["model"]
        assert ids[d][m] == r
        assert info["ranks"]["data"] == [ids[i][m] for i in range(2)]
        assert info["ranks"]["model"] == [ids[d][j] for j in range(4)]


def test_every_case_of_the_reference_runs(runs):
    ref = [(r["axis"], r["op"]) for r in runs["ref"]["results"]]
    assert ref == [(a, op) for a in AXES for op in cb.OPS]
    for info in runs["ranks"]:
        assert [(r["axis"], r["op"]) for r in info["results"]] == ref


@pytest.mark.parametrize("case", range(10),
                         ids=[f"{a}-{op}" for a in AXES for op in cb.OPS])
def test_collective_values_match_the_reference(runs, case):
    want = runs["ref_outs"][case]
    got = _global_output(runs, case)
    n = runs["ref"]["results"][case]["group_size"]
    assert got.shape == want.shape and got.dtype == want.dtype
    # n float32 ulps: the n-term sums are added in the libraries' orders
    assert np.all(np.abs(got - want) <= n * np.spacing(np.abs(want))), case


@pytest.mark.parametrize("case", range(10),
                         ids=[f"{a}-{op}" for a in AXES for op in cb.OPS])
def test_collective_accounting_matches_the_reference(runs, case):
    want = runs["ref"]["results"][case]
    for info in runs["ranks"]:
        got = info["results"][case]
        for key in ("op", "axis", "group_size", "nbytes"):
            assert got[key] == want[key], key
        # every rank reports the slowest rank's time
        assert got == runs["ranks"][0]["results"][case]


@pytest.mark.parametrize("case", range(10),
                         ids=[f"{a}-{op}" for a in AXES for op in cb.OPS])
def test_bandwidths_follow_the_time_and_the_ring_model(runs, case):
    r = runs["ranks"][0]["results"][case]
    assert r["mean_s"] > 0 and r["std_s"] >= 0
    algo = r["nbytes"] / r["mean_s"] / 1e9
    link = algo * cb._ring_factor(r["op"], r["group_size"])
    assert r["algo_gbps"] == pytest.approx(algo, rel=1e-12)
    assert r["link_gbps"] == pytest.approx(link, rel=1e-12)


def test_collective_result_keeps_the_reference_fields():
    assert [f.name for f in dataclasses.fields(cb.CollectiveResult)] == \
        [f.name for f in dataclasses.fields(ref_cb.CollectiveResult)]


@pytest.fixture
def one_rank_world(monkeypatch):
    for k in ENV_ALL + (CPU_DEVICES_ENV,):
        monkeypatch.delenv(k, raising=False)
    dist.initialize(f"127.0.0.1:{dist.pick_free_port()}", 1, 0, "cpu")
    yield
    dist._shutdown()


def test_make_mesh_refuses_an_axis_outside_the_rules(one_rank_world):
    with pytest.raises(ValueError, match="pod"):
        mesh_mod.make_mesh((1,), ("expert",), device="cpu")
    mesh = mesh_mod.make_mesh((1, 1), AXES, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.axis_names == AXES and mesh.coords == {"data": 0, "model": 0}


@pytest.mark.parametrize("multi_pod,size", [(False, 256), (True, 512)])
def test_production_mesh_names_the_world_it_needs(one_rank_world, multi_pod,
                                                  size):
    with pytest.raises(ValueError, match=f"needs {size} processes"):
        mesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_make_mesh_needs_a_world(monkeypatch):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised"):
        mesh_mod.make_mesh((1, 1), AXES, device="cpu")


def test_size_one_axis_ops_on_a_one_rank_world(one_rank_world):
    """Every op on a one-rank axis (the one-GPU case on the card): the
    output is the input's, ppermute a copy to itself; bench_all measures
    nothing there."""
    mesh = mesh_mod.make_mesh((1, 1), AXES, device="cpu")
    for op in cb.OPS:
        fn, arg, payload = cb.collective_case(mesh, "model", op, NBYTES)
        x = arg.clone()
        got = fn(arg)
        assert torch.equal(got.reshape(-1), x.reshape(-1)), op
        assert payload == NBYTES
        r = cb.bench_collective(mesh, "model", op, NBYTES, reps=2)
        assert r.group_size == 1 and r.link_gbps == 0.0 and r.algo_gbps > 0
    assert cb.bench_all(mesh, nbytes=NBYTES, reps=2) == []


def test_run_entry_runs_the_collectives_on_the_cpu(monkeypatch, capsys):
    """``benchmarks_torch.run --only collectives --device cpu``: 8 gloo
    processes on the 2x4 mesh, one row per op and axis."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for k in ENV_ALL + (CPU_DEVICES_ENV, "XLA_FLAGS"):
        monkeypatch.delenv(k, raising=False)
    assert run_mod.main(["--only", "collectives", "--device", "cpu"]) == 0
    rows = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("collectives/")]
    assert [r.split(",")[0] for r in rows] == \
        [f"collectives/{op}/{a}{n}" for a, n in zip(AXES, SHAPE)
         for op in cb.OPS]
    for r in rows:
        name, us, derived = r.split(",")
        assert float(us) > 0 and derived.startswith("algo=")


def test_one_position_mesh_measures_nothing():
    r = subprocess.run([sys.executable, "-m",
                        "benchmarks_torch.collective_bench_main", "--mesh",
                        "1x1", "--device", "cpu", "--quick"], cwd=ROOT,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "no axis of the (1, 1) mesh has two devices" in r.stdout
    assert "collectives/" not in r.stdout


def test_mesh_flag_is_checked():
    assert cbm.parse_mesh("2x4") == (2, 4)
    for bad in ("8", "0x4", "axb"):
        with pytest.raises(Exception, match="--mesh"):
            cbm.parse_mesh(bad)


def test_without_a_gpu_the_entry_raises_naming_the_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cbm.main(mesh=(1, 1))


@pytest.mark.parametrize("case", range(10),
                         ids=[f"{a}-{op}" for a in AXES for op in cb.OPS])
def test_plain_output_is_the_reference_value(runs, case):
    """``plain_output`` (what the checks on the card hold the library's
    result to), assembled over the axis, is the reference's output to
    within its n-term rounding."""
    res = runs["ref"]["results"][case]
    n, op = res["group_size"], res["op"]
    x = cb.global_input(n, NBYTES, device="cpu")
    got = (cb.plain_output(op, x, 0) if op in REPLICATED else
           torch.cat([cb.plain_output(op, x, i) for i in range(n)])).numpy()
    want = runs["ref_outs"][case]
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= n * np.spacing(np.abs(want)))
