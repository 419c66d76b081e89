"""The port's multi-process layer against the reference's, case for case with
``tests/test_bench_distributed.py``: single-process parity of the
``distributed`` backend with ``sharded`` / ``torch`` and the reference's
``xla`` / ``sharded`` / ``distributed``, env-var autodetection (torchrun's
names as the fallback), the local launcher end to end (2 coordinated
processes x 2 logical CPU devices on gloo), gathered-result semantics
(straggler merge, process meta, one trace pid a rank), schema round trips,
and the v1..v5 goldens.

Multi-process tests spawn subprocesses; the 2x2 launch is shared by a module
fixture, and the reference's ``sharded`` accounting at devices 4 comes from
one subprocess on 4 forced host devices.  Workers get one thread each
(``OMP_NUM_THREADS=1``), so that the processes' thread pools never contend
for the same cores while other tests run beside them."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.bench import BenchResult as RefResult
from repro.bench import BenchSpec as RefSpec
from repro.bench import Runner as RefRunner
from repro.bench import distributed as ref_dist
from repro_torch import convert
from repro_torch.bench import (BenchPoint, BenchResult, BenchSpec,
                               BenchSpecError, Runner, mix_names)
from repro_torch.bench import cli
from repro_torch.bench import distributed as dist
from repro_torch.core.device import CPU_DEVICES_ENV

SRC = str(Path(__file__).resolve().parents[1] / "src")
DATA = Path(__file__).parent / "data"
TINY = dict(sizes=(16 * 2**10,), reps=2, warmup=1, passes=1)
ENV_ALL = (dist.ENV_COORDINATOR + dist.ENV_NUM_PROCESSES
           + dist.ENV_PROCESS_ID)


def _clean_env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    for k in ("XLA_FLAGS", CPU_DEVICES_ENV) + ENV_ALL:
        env.pop(k, None)
    env.update(extra)
    return env


@pytest.fixture
def no_launch_env(monkeypatch):
    for k in ENV_ALL + (CPU_DEVICES_ENV,):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# single process (in process): the backend is sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["load_sum", "triad", "rw_2to1"])
def test_distributed_accounting_parity_vs_sharded_and_torch(name):
    """Accounting is registry-sourced, so torch == sharded == distributed,
    and == the reference's xla / sharded / distributed, by construction."""
    assert mix_names("distributed") == mix_names("sharded") == \
        mix_names("torch")
    acct = {}
    for backend in ("torch", "sharded", "distributed"):
        spec = BenchSpec(mixes=(name,), backend=backend, **TINY)
        (pt,) = Runner(device="cpu").run(spec).points
        assert pt.gbps > 0 and pt.mean_s > 0, (name, backend)
        acct[backend] = (pt.bytes_per_call, pt.flops_per_call)
    for backend in ("xla", "sharded", "distributed"):
        (pt,) = RefRunner().run(RefSpec(mixes=(name,), backend=backend,
                                        **TINY)).points
        acct["ref_" + backend] = (pt.bytes_per_call, pt.flops_per_call)
    assert len(set(acct.values())) == 1, (name, acct)


def test_distributed_knob_rules_match_the_oracles(no_launch_env):
    with pytest.raises(BenchSpecError):
        BenchSpec(mixes=("load_only",), backend="distributed", **TINY)
    with pytest.raises(BenchSpecError):
        Runner(device="cpu").run(BenchSpec(mixes=("copy",),
                                           backend="distributed", streams=2,
                                           **TINY))
    with pytest.raises(BenchSpecError, match="devices=2"):
        Runner(device="cpu").run(BenchSpec(mixes=("load_sum",),
                                           backend="distributed", devices=2,
                                           **TINY))   # 1 logical device here


def test_gather_result_is_identity_single_process():
    res = Runner(device="cpu").run(BenchSpec(mixes=("load_sum",),
                                             backend="distributed", **TINY))
    assert dist.gather_result(res) is res
    assert res.machine["process_count"] == 1
    assert res.machine["process_index"] == 0
    assert res.machine["local_device_count"] >= 1


def test_one_process_launch_starts_a_group(no_launch_env):
    """The launcher's one-process case: a one-rank process group (gloo
    here, NCCL on the card) whose all_reduce ends every rep; the result is
    sharded's."""
    no_launch_env.setenv("REPRO_COORDINATOR",
                         f"127.0.0.1:{dist.pick_free_port()}")
    no_launch_env.setenv("REPRO_NUM_PROCESSES", "1")
    from repro_torch.bench.backends import get_backend
    from repro_torch.bench.mixes import get_mix
    from repro_torch.core.buffers import working_set
    try:
        assert dist.ensure_initialized("cpu") is True
        assert dist.is_initialized() and dist.process_count() == 1
        assert dist.ensure_initialized("cpu") is True       # once
        spec = BenchSpec(mixes=("load_sum",), backend="distributed",
                         sizes=(64 * 2**10,), passes=2)
        x = working_set(64 * 2**10, device="cpu")
        got = get_backend("distributed").build(spec, get_mix("load_sum"),
                                               x.clone(), 2)()
        want = get_backend("sharded").build(spec.replace(backend="sharded"),
                                            get_mix("load_sum"), x.clone(),
                                            2)()
        assert float(got) == float(want)
        res = Runner(device="cpu").run(spec.replace(reps=2, warmup=1))
        assert dist.gather_result(res) is res
        assert res.machine["process_count"] == 1
        assert dist.covering_device_counts(device="cpu") == (1,)
    finally:
        dist._shutdown()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# coordination plumbing (no process group needed)
# ---------------------------------------------------------------------------

def test_env_info_and_env_active(no_launch_env):
    monkeypatch = no_launch_env
    assert dist.env_info() == (None, None, None)
    assert not dist.env_active()
    monkeypatch.setenv("REPRO_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")
    monkeypatch.setenv("REPRO_PROCESS_ID", "1")
    assert dist.env_info() == ("127.0.0.1:1234", 2, 1)
    assert dist.env_active()
    # the reference reads the same REPRO_* triple
    assert ref_dist.env_info() == dist.env_info()
    # torchrun's names are honored as the fallback
    for k in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
              "REPRO_PROCESS_ID"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    assert dist.env_info() == (None, None, None)    # no port: no address
    monkeypatch.setenv("MASTER_PORT", "9")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert dist.env_info() == ("10.0.0.1:9", 4, 3)


def test_ensure_initialized_noop_outside_launch(no_launch_env):
    monkeypatch = no_launch_env
    assert dist.ensure_initialized("cpu") is False
    assert dist.process_count() == 1 and dist.process_index() == 0
    assert dist.is_primary()
    # nproc set but no process id: a loud error beats a silent hang
    monkeypatch.setenv("REPRO_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="process id"):
        dist.ensure_initialized("cpu")


def test_launch_local_validates_args(tmp_path):
    with pytest.raises(ValueError, match="processes"):
        dist.launch_local(["true"], processes=0, device="cpu")
    with pytest.raises(ValueError, match="devices_per_process"):
        dist.launch_local(["true"], processes=1, devices_per_process=0,
                          device="cpu")
    # more GPUs than are visible: refused before anything is spawned
    marker = tmp_path / "spawned"
    cmd = [sys.executable, "-c", f"open({str(marker)!r}, 'w')"]
    with pytest.raises(BenchSpecError, match="needs 2 GPUs; 1 visible"):
        dist.launch_local(cmd, processes=2, device="cuda",
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
    with pytest.raises(BenchSpecError, match="pass --device cpu"):
        dist.launch_local(cmd, processes=1, device="cuda",
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert not marker.exists()
    # the CLI reports it as a spec error (exit 2), spawning nothing
    assert cli.main(["launch", "--processes", "2", "--mixes", "load_sum",
                     "--sizes", "16K", "--no-ledger"]) == 2
    assert cli.main(["launch", "--spec", "s.json", "--device", "cpu"]) == 2


def test_launch_local_gives_each_process_its_devices(capsys):
    """CUDA: disjoint CUDA_VISIBLE_DEVICES slices; CPU: the logical device
    count.  The children only print their environment."""
    show = [sys.executable, "-c",
            "import os; print('devs', os.environ.get('CUDA_VISIBLE_DEVICES'),"
            f" os.environ.get({CPU_DEVICES_ENV!r}),"
            " os.environ['REPRO_PROCESS_ID'], os.environ['REPRO_COORDINATOR'"
            "].startswith('127.0.0.1:'))"]
    rc = dist.launch_local(show, processes=2, devices_per_process=2,
                           device="cuda", timeout=60, stream_to=sys.stdout,
                           env=dict(_clean_env(),
                                    CUDA_VISIBLE_DEVICES="3,5,7,9"))
    lines = sorted(l for l in capsys.readouterr().out.splitlines()
                   if " devs " in l)
    assert rc == 0 and lines == ["[p0] devs 3,5 None 0 True",
                                 "[p1] devs 7,9 None 1 True"]
    rc = dist.launch_local(show, processes=2, devices_per_process=3,
                           device="cpu", timeout=60, stream_to=sys.stdout,
                           env=_clean_env())
    lines = sorted(l for l in capsys.readouterr().out.splitlines()
                   if " devs " in l)
    assert rc == 0 and lines == ["[p0] devs None 3 0 True",
                                 "[p1] devs None 3 1 True"]


def test_launch_local_propagates_worker_failure():
    before = dist.metrics.REGISTRY.snapshot()["counters"].get(
        "straggler_kills", 0)
    rc = dist.launch_local(
        [sys.executable, "-c",
         "import os, sys, time\n"
         "if os.environ['REPRO_PROCESS_ID'] == '0': sys.exit(3)\n"
         "time.sleep(60)"],
        processes=2, timeout=60, stream_to=open(os.devnull, "w"),
        device="cpu")
    assert rc == 3
    # the sleeping peer was killed, not waited for
    assert dist.metrics.REGISTRY.snapshot()["counters"][
        "straggler_kills"] == before + 1


# ---------------------------------------------------------------------------
# 2-process launcher end to end (subprocesses; one shared run)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    """One 2-process x 2-device launcher run on gloo: CLI `launch` ->
    workers run the distributed backend over the 4-device global mesh ->
    process 0 writes the gathered result and the merged trace."""
    tmp = tmp_path_factory.mktemp("dist")
    out, tr = tmp / "gathered.json", tmp / "trace.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", "launch",
         "--processes", "2", "--devices-per-process", "2", "--device", "cpu",
         "--timeout", "300", "--out", str(out), "--trace", str(tr),
         "--no-ledger", "--mixes", "load_sum,copy", "--sizes", "1M",
         "--reps", "2"],
        capture_output=True, text=True, env=_clean_env(), timeout=360)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return (json.loads(out.read_text()), r.stdout + r.stderr,
            json.loads(tr.read_text()))


@pytest.fixture(scope="module")
def ref_sharded4():
    """The reference's `sharded` accounting at devices 4 (4 forced host
    devices, one subprocess)."""
    snippet = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
from repro.bench import BenchSpec, Runner
res = Runner().run(BenchSpec(mixes=("load_sum", "copy"), sizes=(2**20,),
                             backend="sharded", devices=4, reps=2))
print(json.dumps([[p.mix, p.nbytes, p.passes, p.bytes_per_call,
                   p.flops_per_call] for p in res.points]))
"""
    r = subprocess.run([sys.executable, "-c", snippet], capture_output=True,
                       text=True, env=_clean_env(), timeout=560)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_launcher_gathers_one_result_on_process0(gathered):
    d, log, _ = gathered
    assert d["schema_version"] == 6
    assert d["machine"]["process_count"] == 2
    assert d["machine"]["process_index"] == 0
    assert d["machine"]["local_device_counts"] == [2, 2]
    assert d["machine"]["device_count"] == 4
    # all points on the full global mesh, positive throughput
    assert [p["mix"] for p in d["points"]] == ["load_sum", "copy"]
    assert all(p["devices"] == 4 and p["gbps"] > 0 and
               p["backend"] == "distributed" for p in d["points"])
    # per-process timing rows kept for skew inspection; the merged point is
    # the straggler: its mean is the max across processes
    rows = d["meta"]["per_process_mean_s"]
    assert len(rows) == 2 and len(rows[0]) == len(d["points"])
    for i, p in enumerate(d["points"]):
        assert p["mean_s"] == pytest.approx(max(r[i] for r in rows))
        assert p["gbps"] == pytest.approx(
            p["bytes_per_call"] / p["mean_s"] / 1e9)
    # non-primary processes report instead of writing
    assert "[p1] # process 1/2 done" in log
    assert "[p0] # saved 2 points" in log


def test_gathered_result_matches_sharded_accounting(gathered, ref_sharded4,
                                                    monkeypatch):
    """A 2-process gathered run's per-point bytes/flops equals `sharded` at
    the same global device count (4), mix for mix — the port's in process
    on 4 logical CPU devices and the reference's on 4 host devices."""
    d, _, _ = gathered
    monkeypatch.setenv(CPU_DEVICES_ENV, "4")
    res = Runner(device="cpu").run(BenchSpec(
        mixes=("load_sum", "copy"), sizes=(2**20,), backend="sharded",
        devices=4, reps=2))
    sharded = [[p.mix, p.nbytes, p.passes, p.bytes_per_call,
                p.flops_per_call] for p in res.points]
    distributed = [[p["mix"], p["nbytes"], p["passes"], p["bytes_per_call"],
                    p["flops_per_call"]] for p in d["points"]]
    assert sharded == distributed == ref_sharded4


def test_gathered_result_roundtrips_as_v6(gathered):
    d, _, _ = gathered
    res = BenchResult.from_dict(d)
    assert res.schema_version == 6
    assert all(isinstance(p, BenchPoint) for p in res.points)
    # by_size resolves the requested size (1M here survives rounding intact)
    assert len(res.by_size(2**20)) == 2
    back = BenchResult.from_dict(json.loads(res.to_json()))
    assert back.points == res.points and back.machine == res.machine
    assert back.machine["local_device_counts"] == [2, 2]
    # ... and the reference loads it as its own distributed result
    ref = RefResult.from_dict(convert.result_to_reference(d))
    assert ref.machine["process_count"] == 2
    assert [p.backend for p in ref.points] == ["distributed"] * 2


def test_gathered_trace_has_one_pid_per_rank(gathered):
    _, log, doc = gathered
    events = doc["traceEvents"]
    assert {e["pid"] for e in events} == {0, 1}
    for rank in (0, 1):
        names = {e["name"] for e in events if e["pid"] == rank}
        assert {"runner.run", "timing.rep", "backend.dispatch",
                "mesh.place"} <= names, (rank, names)
    place = [e["args"] for e in events if e["name"] == "mesh.place"]
    assert all(a["mesh_shape"] == [4] and a["devices"] == ["cpu", "cpu"]
               for a in place)
    assert "[p0] # saved trace" in log


def test_distributed_mesh_covers_every_process_or_raises():
    """devices < processes must fail loudly (a process with no shard has
    nothing to time), and the round-robin device order spreads intermediate
    counts one per process."""
    snippet = r"""
from repro_torch.bench import distributed as dist
assert dist.ensure_initialized("cpu")
from repro_torch.bench import BenchSpec, BenchSpecError, Runner
from repro_torch.bench.backends import get_backend
assert dist.process_count() == 2
assert dist.local_device_counts("cpu") == [2, 2]
assert get_backend("distributed")._global_pool("cpu") == \
    [(0, 0), (1, 0), (0, 1), (1, 1)]
assert dist.covering_device_counts(device="cpu") == (2, 4)
me = dist.process_index()
assert get_backend("distributed")._layout(2, "cpu") == {me: __import__(
    "torch").device("cpu")}
try:
    Runner(device="cpu").run(BenchSpec(
        mixes=("load_sum",), backend="distributed", devices=1,
        sizes=(16 * 2**10,), reps=2, warmup=1, passes=1))
except BenchSpecError as e:
    assert "no mesh shard" in str(e), e
else:
    raise AssertionError("devices=1 with 2 processes should be rejected")
# devices=2: one device per process via round-robin -> runs fine
res = Runner(device="cpu").run(BenchSpec(
    mixes=("load_sum", "triad"), backend="distributed", devices=2,
    sizes=(16 * 2**10,), reps=2, warmup=1, passes=1))
res = dist.gather_result(res)
assert [p.devices for p in res.points] == [2, 2]
assert all(p.gbps > 0 for p in res.points)
print("COVERAGE_OK")
"""
    rc = dist.launch_local([sys.executable, "-c", snippet], processes=2,
                           devices_per_process=2, timeout=300,
                           stream_to=sys.stderr, env=_clean_env(),
                           device="cpu")
    assert rc == 0


# ---------------------------------------------------------------------------
# golden back-compat: v1/v2 files keep loading next to v3..v5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fname,ver", [("result_v1.json", 1),
                                       ("result_v2.json", 2)])
def test_pre_v3_goldens_still_load_with_defaults(fname, ver):
    doc = json.loads((DATA / fname).read_text())
    res = BenchResult.from_dict(convert.result_from_reference(doc))
    assert res.schema_version == ver
    assert all(p.nbytes_requested is None for p in res.points)
    # pre-v3 points only resolve by real size; no crash on requested lookup
    assert res.by_size(res.points[0].nbytes)
    d = json.loads(res.to_json())
    assert d["schema_version"] == ver
    ref = RefResult.from_dict(doc)
    assert [p.devices for p in res.points] == [p.devices for p in ref.points]


def test_v3_golden_records_process_topology():
    doc = json.loads((DATA / "result_v3.json").read_text())
    res = BenchResult.from_dict(convert.result_from_reference(doc))
    assert res.schema_version == 3
    assert res.machine["process_count"] == 2
    assert res.machine["local_device_counts"] == [2, 2]
    assert all(p.devices == 4 and p.nbytes_requested for p in res.points)
    assert len(res.meta["per_process_mean_s"]) == 2
    # the spec of a distributed run is one this package runs now
    assert BenchSpec.from_dict(res.spec).backend == "distributed"


@pytest.mark.parametrize("ver", [1, 2, 3, 4, 5])
def test_golden_machine_topology_like_the_reference(ver):
    doc = json.loads((DATA / f"result_v{ver}.json").read_text())
    ref = RefResult.from_dict(doc)
    mine = BenchResult.from_dict(convert.result_from_reference(doc))
    for key in ("process_count", "process_index", "local_device_count",
                "local_device_counts", "device_count"):
        assert mine.machine.get(key) == ref.machine.get(key), key
    assert [p.backend for p in mine.points] == \
        [convert.BACKEND_FROM_REFERENCE.get(p.backend, p.backend)
         for p in ref.points]
