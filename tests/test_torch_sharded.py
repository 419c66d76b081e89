"""The port's ``sharded`` backend against the reference's, case for case with
``tests/test_bench_sharded.py``: accounting parity with ``torch`` and with
the reference's ``xla`` / ``sharded``, the devices knob through spec and
result round trips, the weak-scaling curve on 8 logical CPU devices, the
case cache across device counts — and the returned scalar of every mix, in
process at devices 1 and against one reference subprocess on 4 forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), plus the
loaded composite (devices 2, load 1) and ``scaling_curve``.

The port's logical CPU devices come from ``REPRO_TORCH_CPU_DEVICES``
(unset: one, as the reference sees one host device here).

Tolerance of a returned scalar: each shard's case is the torch oracle over
its block of rows, so each of the k shards may differ from the reference by
the oracle's own bound (``tests/test_torch_oracles.py``,
``tests/test_torch_rw.py``): for the sums (load_sum, fma_k) ``n * 1.3e-7 *
passes * depth`` at the shard's n elements, floor 1e-4; for the element
checksums (copy, triad, mxu) ``1e-6 |v| + 1e-6``; for rw ``1e-6 |v| + (R-1)
ulp (passes + W unroll)``; the chase exactly (its walk returns to 0) — taken
at the whole result's magnitude ``|v|`` for every shard, and the k scalars
are summed in another order than the reference's, which adds ``k * eps *
|v|`` (float32 eps).  Accounting is exact."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.bench import BenchSpec as RefSpec
from repro.bench import BenchSpecError as RefSpecError
from repro.bench import Runner as RefRunner
from repro.bench import mix_names as ref_mix_names
from repro.bench.backends import get_backend as ref_backend
from repro.bench.mixes import get_mix as ref_get_mix
from repro.core import buffers as ref_buffers
from repro_torch import convert
from repro_torch.bench import (BenchResult, BenchSpec, BenchSpecError, Runner,
                               mix_names)
from repro_torch.bench import cli
from repro_torch.bench.backends import MeshBuffer, get_backend
from repro_torch.bench.mixes import get_mix
from repro_torch.core import buffers
from repro_torch.core.device import CPU_DEVICES_ENV
from repro_torch.obs import trace

SRC = str(Path(__file__).resolve().parents[1] / "src")
TINY = dict(sizes=(16 * 2**10,), reps=2, warmup=1, passes=1)
#: the returned-scalar cases: a 64 KiB working set (128 rows, 32 a shard at
#: devices 4), 2 passes
NBYTES, PASSES = 64 * 2**10, 2
#: scaling_curve's bytes per device, both packages
PER_DEV = 64 * 2**10
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def cpu_devices(monkeypatch):
    """Set how many logical CPU devices the port's pool holds."""
    def set_count(n: int):
        monkeypatch.setenv(CPU_DEVICES_ENV, str(n))
    monkeypatch.delenv(CPU_DEVICES_ENV, raising=False)
    return set_count


def _oracle_tol(mix: str, n: int, value: float) -> float:
    """The torch oracle's bound for one shard of n elements (module note)."""
    if mix == "latency_chase":
        return 0.0
    if mix in ("copy", "triad", "mxu"):
        return 1e-6 * abs(value) + 1e-6
    if mix.startswith("rw_"):
        reads, writes = get_mix(mix).rw
        ulp = float(np.spacing(np.float32(4.0)))   # |v| < 4 on working_set
        return 1e-6 * abs(value) + (reads - 1) * ulp * (PASSES + writes)
    depth = int(mix.split("_")[1]) if mix.startswith("fma_") else 1
    return max(n * 1.3e-7 * PASSES * depth, 1e-4)


def _mesh_tol(mix: str, k: int, n: int, value: float) -> float:
    return k * _oracle_tol(mix, n // k, value) + k * EPS * abs(value)


def _pair(nbytes=NBYTES):
    xj = ref_buffers.working_set(nbytes)
    return xj, convert.tensor_from_reference(np.asarray(xj))


def _port_scalar(name: str, k: int, load: int = 0) -> float:
    spec = BenchSpec(mixes=(name,), sizes=(NBYTES,), backend="sharded",
                     devices=k, passes=PASSES, load=load)
    return float(get_backend("sharded").build(spec, get_mix(name),
                                              _pair()[1], PASSES)())


# ---------------------------------------------------------------------------
# the reference on 4 forced host devices: one subprocess for the module
# ---------------------------------------------------------------------------

REF_SNIPPET = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
from repro.bench import BenchSpec, Runner
from repro.bench.backends import get_backend
from repro.bench.mixes import get_mix, mix_names
from repro.core.buffers import working_set
from repro.core.scaling import scaling_curve

NBYTES, PASSES, PER_DEV = %d, %d, %d


def scalar(name, k, load=0):
    spec = BenchSpec(mixes=(name,), sizes=(NBYTES,), backend="sharded",
                     devices=k, passes=PASSES, load=load)
    fn = get_backend("sharded").build(spec, get_mix(name),
                                      working_set(NBYTES), PASSES)
    return float(fn())


(p,) = Runner().run(BenchSpec(mixes=("latency_chase",), sizes=(NBYTES,),
                              backend="sharded", devices=2, load=1,
                              passes=PASSES, reps=1, warmup=0)).points
out = {"scalars": {m: scalar(m, 4) for m in mix_names("sharded")},
       "composite": scalar("latency_chase", 2, load=1),
       "composite_acct": [p.nbytes, p.passes, p.bytes_per_call,
                          p.flops_per_call],
       "scaling": [[p.devices, p.mix, p.nbytes_total, p.speedup]
                   for p in scaling_curve(PER_DEV, device_counts=[1, 2],
                                          passes=2, reps=2)]}
print(json.dumps(out))
""" % (NBYTES, PASSES, PER_DEV)


@pytest.fixture(scope="module")
def ref4():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SNIPPET],
                       capture_output=True, text=True, env=env, timeout=560)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# single device (in process): parity, validation, round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", mix_names("torch"))
def test_sharded_accounting_parity_vs_torch_and_the_reference(name):
    """Every torch-runnable mix runs sharded at devices=1 with bytes/flops
    identical to torch and to the reference's xla and sharded (all read the
    shared registry)."""
    acct = {}
    for backend in ("torch", "sharded"):
        (pt,) = Runner(device="cpu").run(
            BenchSpec(mixes=(name,), backend=backend, **TINY)).points
        assert pt.gbps > 0 and pt.mean_s > 0, (name, backend)
        acct[backend] = (pt.nbytes, pt.passes, pt.bytes_per_call,
                         pt.flops_per_call)
    for backend in ("xla", "sharded"):
        (pt,) = RefRunner().run(
            RefSpec(mixes=(name,), backend=backend, **TINY)).points
        acct["ref_" + backend] = (pt.nbytes, pt.passes, pt.bytes_per_call,
                                  pt.flops_per_call)
    assert len(set(acct.values())) == 1, (name, acct)


def test_sharded_supports_exactly_the_torch_mixes():
    assert mix_names("sharded") == mix_names("torch") == \
        ref_mix_names("sharded")
    with pytest.raises(BenchSpecError):    # load_only is cuda-only
        BenchSpec(mixes=("load_only",), backend="sharded", **TINY)
    with pytest.raises(RefSpecError):      # ... as it is pallas-only there
        RefSpec(mixes=("load_only",), backend="sharded", **TINY)


def test_sharded_rejects_more_devices_than_visible(cpu_devices):
    """One logical CPU device unless the environment asks for more, as the
    reference sees one host device here; the error names the fix."""
    spec = BenchSpec(mixes=("load_sum",), backend="sharded", devices=2, **TINY)
    with pytest.raises(BenchSpecError, match="devices=2") as e:
        Runner(device="cpu").run(spec)
    assert CPU_DEVICES_ENV in str(e.value)
    with pytest.raises(RefSpecError, match="devices=2"):
        RefRunner().run(RefSpec(mixes=("load_sum",), backend="sharded",
                                devices=2, **TINY))
    cpu_devices(2)
    (pt,) = Runner(device="cpu").run(spec).points
    assert pt.devices == 2


def test_sharded_knob_rules_match_the_reference(cpu_devices):
    """The per-shard cases are the oracles, so the oracle knob rules hold —
    in both packages, with the loaded composite's devices == load + 1."""
    cpu_devices(4)
    bad = [dict(mixes=("copy",), streams=2),
           dict(mixes=("load_sum",), streams=2, block_rows=8),
           dict(mixes=("latency_chase",), load=1, devices=3)]
    for kw in bad:
        with pytest.raises(BenchSpecError):
            Runner(device="cpu").run(BenchSpec(backend="sharded",
                                               **{**TINY, **kw}))
        with pytest.raises(RefSpecError):
            RefRunner().run(RefSpec(backend="sharded", **{**TINY, **kw}))
    with pytest.raises(BenchSpecError, match="need devices == load"):
        Runner(device="cpu").run(BenchSpec(
            mixes=("latency_chase",), backend="sharded", load=1, devices=3,
            **TINY))
    # a shape rule names the shard, in the reference's words (devices 1)
    for kw in (dict(mixes=("load_sum",), block_rows=24),
               dict(mixes=("load_sum",), interleave=3)):
        with pytest.raises(BenchSpecError) as mine:
            Runner(device="cpu").run(BenchSpec(backend="sharded",
                                               **{**TINY, **kw}))
        with pytest.raises(RefSpecError) as ref:
            RefRunner().run(RefSpec(backend="sharded", **{**TINY, **kw}))
        assert str(mine.value) == str(ref.value)
        assert "the per-device shard on sharded" in str(mine.value)


def test_sharded_point_carries_devices_and_roundtrips(tmp_path):
    spec = BenchSpec(mixes=("load_sum",), backend="sharded", devices=1, **TINY)
    res = Runner(device="cpu").run(spec)
    (pt,) = res.points
    assert pt.devices == 1 and pt.backend == "sharded"
    path = tmp_path / "res.json"
    res.to_json(path)
    back = BenchResult.from_json(path)
    assert back.points == res.points
    assert back.spec["devices"] == 1
    # ... and the reference loads it as its own sharded result
    from repro.bench import BenchResult as RefResult
    ref = RefResult.from_dict(convert.result_to_reference(
        json.loads(path.read_text())))
    assert ref.points[0].backend == "sharded" and ref.spec["devices"] == 1


def test_sharded_without_the_cpu_flag_raises_and_names_it():
    """No CUDA device here: the default device raises; no silent CPU mesh."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["run", "--backend", "sharded", "--sizes", "16K",
                  "--no-ledger"])


# ---------------------------------------------------------------------------
# the mesh: shard by shard, where each shard lives
# ---------------------------------------------------------------------------

def test_working_set_is_made_shard_by_shard(cpu_devices):
    cpu_devices(4)
    spec = BenchSpec(mixes=("load_sum",), backend="sharded", devices=4,
                     sizes=(NBYTES,))
    tr = trace.configure(enabled=True, clear=True)
    try:
        x = get_backend("sharded").working_set(spec, NBYTES, torch.float32,
                                               torch.device("cpu"))
        events = tr.events()
    finally:
        trace.configure(enabled=False, clear=True)
    whole = buffers.working_set(NBYTES, device="cpu")
    assert isinstance(x, MeshBuffer) and x.shape == tuple(whole.shape)
    assert sorted(x.shards) == [0, 1, 2, 3]
    r = whole.shape[0] // 4
    for i, t in x.shards.items():
        assert torch.equal(t, whole[i * r:(i + 1) * r])
    (place,) = [e for e in events if e["name"] == "mesh.place"]
    assert place["args"]["mesh_shape"] == [4]
    assert place["args"]["devices"] == ["cpu"] * 4
    with pytest.raises(BenchSpecError, match="does not divide"):
        get_backend("sharded").working_set(
            spec.replace(devices=3), NBYTES, torch.float32, "cpu")


def test_dispatch_event_records_the_mesh(cpu_devices, tmp_path):
    cpu_devices(2)
    out = tmp_path / "trace.json"
    assert cli.main(["run", "--device", "cpu", "--backend", "sharded",
                     "--devices", "2", "--mixes", "load_sum,latency_chase",
                     "--sizes", "16K", "--reps", "2", "--no-ledger",
                     "--trace", str(out), "--out",
                     str(tmp_path / "r.json")]) == 0
    trace.configure(enabled=False)
    events = json.loads(out.read_text())["traceEvents"]
    dispatch = [e["args"] for e in events if e["name"] == "backend.dispatch"]
    assert [(d["mix"], d["mesh_shape"], d["composite"]) for d in dispatch] \
        == [("load_sum", [2], False), ("latency_chase", [2], False)]


# ---------------------------------------------------------------------------
# the returned scalar against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", mix_names("torch"))
def test_returned_scalar_at_devices_1_matches_the_reference(name):
    xj, _ = _pair()
    spec = RefSpec(mixes=(name,), sizes=(NBYTES,), backend="sharded",
                   devices=1, passes=PASSES)
    want = float(ref_backend("sharded").build(spec, ref_get_mix(name), xj,
                                               PASSES)())
    got = _port_scalar(name, 1)
    n = xj.size
    assert abs(got - want) <= _mesh_tol(name, 1, n, want), (got, want)


@pytest.mark.parametrize("name", mix_names("torch"))
def test_returned_scalar_at_devices_4_matches_the_reference(name, ref4,
                                                            cpu_devices):
    cpu_devices(4)
    want = ref4["scalars"][name]
    got = _port_scalar(name, 4)
    n = NBYTES // 4
    assert abs(got - want) <= _mesh_tol(name, 4, n, want), (got, want)


def test_loaded_composite_matches_the_reference(ref4, cpu_devices):
    """devices 2, load 1: shard 0 walks its cycle (0 at the end of every
    pass), shard 1 runs 16 load_sum sweeps a pass over its block."""
    cpu_devices(2)
    want = ref4["composite"]
    got = _port_scalar("latency_chase", 2, load=1)
    tol = 2 * max((NBYTES // 8) * 1.3e-7 * PASSES * 16, 1e-4) \
        + 2 * EPS * abs(want)
    assert abs(got - want) <= tol, (got, want)
    # the accounting of the composite: the probe over shard 0's half, 16
    # sweeps of the generator's half a pass
    (p,) = Runner(device="cpu").run(BenchSpec(
        mixes=("latency_chase",), sizes=(NBYTES,), backend="sharded",
        devices=2, load=1, passes=PASSES, reps=1, warmup=0)).points
    assert [p.nbytes, p.passes, p.bytes_per_call, p.flops_per_call] == \
        ref4["composite_acct"]
    assert p.bytes_per_call == (NBYTES / 2) * (1 + 16) * PASSES
    assert p.latency_ns > 0 and p.gen_gbps > 0


def test_scaling_curve_matches_the_reference(ref4, cpu_devices):
    from repro_torch.core.scaling import ScalingPoint, scaling_curve
    cpu_devices(2)
    pts = scaling_curve(PER_DEV, device_counts=[1, 2], passes=2, reps=2,
                        runner=Runner(device="cpu"))
    assert all(isinstance(p, ScalingPoint) for p in pts)
    assert [[p.devices, p.mix, p.nbytes_total] for p in pts] == \
        [row[:3] for row in ref4["scaling"]]
    assert pts[0].speedup == ref4["scaling"][0][3] == 1.0
    assert all(p.gbps > 0 and p.speedup > 0 for p in pts)
    # default counts: the ladder values the pool covers
    assert [p.devices for p in scaling_curve(
        PER_DEV, passes=1, reps=1, runner=Runner(device="cpu"))] == [1, 2]


# ---------------------------------------------------------------------------
# 8 logical CPU devices (in process; the reference forces 8 host devices in
# a subprocess)
# ---------------------------------------------------------------------------

def test_sharded_scaling_8dev(cpu_devices):
    cpu_devices(8)
    per_dev = 256 * 2**10
    runner = Runner(device="cpu")
    specs = [BenchSpec(mixes=("load_sum",), sizes=(per_dev * k,),
                       backend="sharded", devices=k, passes=2, reps=2,
                       warmup=1)
             for k in (1, 2, 4, 8)]
    res = runner.run_many(specs)

    # one point per device count, each stamped with its knob
    assert [p.devices for p in res.points] == [1, 2, 4, 8], res.points
    assert all(p.gbps > 0 for p in res.points)
    assert res.meta["sizes"] == [per_dev * k for k in (1, 2, 4, 8)]
    assert res.machine["device_count"] == 8

    # speedup curve shape: anchored at 1.0 on devices=1, finite and positive
    rels = res.baseline_relative(group_key=lambda p: p.mix)
    assert abs(rels[0][1] - 1.0) < 1e-9, rels[0]
    assert all(r > 0 for _, r in rels), rels
    assert [p.devices for p, _ in rels] == sorted(p.devices for p, _ in rels)

    # devices knob round-trips through the serialized result
    back = BenchResult.from_dict(json.loads(res.to_json()))
    assert [p.devices for p in back.points] == [1, 2, 4, 8]
    assert [s["devices"] for s in back.spec["many"]] == [1, 2, 4, 8]

    # the case cache: re-running the sweep builds nothing anew
    misses = runner.cache_misses
    rerun = runner.run_many(specs)
    assert runner.cache_misses == misses, (runner.cache_misses, misses)
    assert runner.cache_hits >= len(specs)
    obs = rerun.meta["obs"]
    assert obs["counters"]["cache_hits"] >= len(specs), obs
    assert obs["counters"].get("cache_misses", 0) == 0, obs
    assert obs["runner"] == {"cache_hits": runner.cache_hits,
                             "cache_misses": runner.cache_misses}, obs

    # the scaling view rides the same backend (no measurement loop of its
    # own)
    from repro_torch.core.scaling import scaling_curve
    pts = scaling_curve(per_dev, device_counts=[1, 2], passes=2, reps=2,
                        runner=runner)
    assert [p.devices for p in pts] == [1, 2] and pts[0].speedup == 1.0


# ---------------------------------------------------------------------------
# pass-major enqueue: every shard's pass p before any shard's pass p + 1
# ---------------------------------------------------------------------------

def _shard_after_shard(spec, name: str, x) -> torch.Tensor:
    """The scalar as the mesh computed it before its enqueue went
    pass-major: each shard's whole oracle in turn (in the composite the
    siblings' load_sum sweeps first, then the probe's walk), the scalars
    summed in shard order on the first shard's device."""
    from repro_torch.bench.backends import _mix_operands, _oracle_case
    from repro_torch.bench.mixes import GEN_SWEEPS_PER_PASS
    from repro_torch.core import instruction_mix as im
    backend, mix, k = get_backend("sharded"), get_mix(name), spec.devices
    buf = backend.prepare_buffer(spec, x)
    held = sorted(buf.shards)
    if mix.chase:
        perm, *gen = _mix_operands(
            mix, buf, place=lambda a: backend._split(a, k, x.device),
            load=spec.load, parts=k)
        out = {i: im.k_load_sum(gen[0].shards[i], PASSES * GEN_SWEEPS_PER_PASS)
               for i in held if i and spec.load}
        for i in held:
            if i == 0 or not spec.load:
                out[i] = im.k_chase(perm.shards[i], PASSES)
    else:
        one = _oracle_case(spec, mix, x.shape[0] // k, PASSES, "sharded")
        out = {i: im.drain(one(*_mix_operands(mix, buf.shards[i])))
               for i in held}
    total = out[held[0]]
    for i in held[1:]:
        total = total + out[i].to(total.device)
    return total


@pytest.mark.parametrize("name,load", [(m, 0) for m in mix_names("torch")]
                         + [("latency_chase", 3)])
def test_pass_major_scalars_equal_shard_after_shard_bit_for_bit(
        name, load, cpu_devices):
    """On 4 logical CPU devices the returned scalar of every mix (and of
    the loaded composite, devices 4, load 3) is the shard-after-shard
    order's, bit for bit: each shard's oracle runs the same operations on
    its own buffers, only their interleaving across shards changed."""
    cpu_devices(4)
    spec = BenchSpec(mixes=(name,), sizes=(NBYTES,), backend="sharded",
                     devices=4, passes=PASSES, load=load)
    got = get_backend("sharded").build(spec, get_mix(name), _pair()[1],
                                       PASSES)()
    want = _shard_after_shard(spec, name, _pair()[1])
    assert got.dtype == want.dtype == torch.float32
    assert got.view(torch.int32).item() == want.view(torch.int32).item(), \
        (float(got), float(want))


@pytest.mark.parametrize("name,loop", [("load_sum", "_pass_loop"),
                                       ("copy", "_rotating_pass_loop"),
                                       ("rw_2to1", "_rotating_pass_loop"),
                                       ("latency_chase", "_pass_loop")])
def test_mesh_dispatch_order_is_pass_major(name, loop, cpu_devices,
                                           monkeypatch):
    """Every pass each shard's oracle enqueues is recorded (shard, pass):
    on 4 logical CPU devices, 3 passes, the order is pass 0 of shards 0-3,
    then pass 1 of shards 0-3, then pass 2 — never a shard's next pass
    before every shard has had this one."""
    from repro_torch.core import instruction_mix as im
    cpu_devices(4)
    passes, order, loops = 3, [], {}
    original = getattr(im, loop)

    def recorded(step, passes, unroll, *init):
        me = object()

        def rec(i, *carry):
            order.append((loops.setdefault(me, len(loops)), i))
            return step(i, *carry)
        return (yield from original(rec, passes, unroll, *init))
    monkeypatch.setattr(im, loop, recorded)
    spec = BenchSpec(mixes=(name,), sizes=(NBYTES,), backend="sharded",
                     devices=4, passes=passes)
    get_backend("sharded").build(spec, get_mix(name), _pair()[1], passes)()
    assert order == [(s, p) for p in range(passes) for s in range(4)]


def test_the_plain_and_the_stepped_oracle_are_one():
    """``k(...)`` runs ``k.steps(...)`` to its end: one value, and the
    generator yields once a pass."""
    from repro_torch.core import instruction_mix as im
    x = _pair()[1]
    steps = im.k_copy.steps(x, 4, 2)
    assert sum(1 for _ in steps) == 4
    assert float(im.drain(im.k_load_sum.steps(x, 3))) == \
        float(im.k_load_sum(x, 3))
