"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``), on the CPU.

- ``analytic_bytes`` equals the reference's for all 10 architectures x 4
  shapes x both production meshes' (tp, dp) x cache bytes 1 and 2 x train
  passes 2 and 3, at relative 1e-12 (the same arithmetic in the same
  order: bit for bit in practice);
- ``RooflineTerms`` (the ring model, ``dominant``, ``summary``) and
  ``_breakdown`` equal the reference's on the same ``CollectiveOp`` lists
  and constants;
- ``machine_constants`` equals the reference's on matching specs, and
  fitted-model-like objects;
- the defaults are the H100's data-sheet constants (989 TFLOP/s bf16,
  3.35 TB/s HBM3, NVLink 4's 450 GB/s a direction): no TPU v5e constant is
  reachable from the port;
- ``analyze`` over a record of counts.
"""
import itertools
import random
from pathlib import Path
from types import SimpleNamespace

import pytest

import repro.core.machine_model as j_mm
import repro.roofline.analyze as j_an
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.roofline.model_bytes import analytic_bytes as j_bytes
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.core import machine_model as mm
from repro_torch.roofline import analyze as an
from repro_torch.roofline.model_bytes import analytic_bytes

ROOT = Path(__file__).resolve().parents[1]
#: (n_devices, tp, dp) of the production meshes: (16, 16) and (2, 16, 16)
MESHES = [(256, 16, 16), (512, 16, 32)]
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_bytes_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    n = 0
    for shape, (nd, tp, dp), cache, passes in itertools.product(
            SHAPES, MESHES, (1, 2), (2, 3)):
        got = analytic_bytes(cfg, SHAPES[shape], nd, tp=tp, dp=dp,
                             cache_bytes_per_elem=cache, train_passes=passes)
        want = j_bytes(jcfg, J_SHAPES[shape], nd, tp=tp, dp=dp,
                       cache_bytes_per_elem=cache, train_passes=passes)
        assert got == pytest.approx(want, rel=1e-12), (shape, nd, cache)
        assert got > 0
        n += 1
    assert n == 4 * 2 * 2 * 2


def _ops(seed: int):
    rng = random.Random(seed)
    return [(k, rng.randrange(1, 1 << 30), rng.choice((1, 2, 4, 16, 32)))
            for k in (rng.choice(KINDS) for _ in range(rng.randrange(0, 40)))]


@pytest.mark.parametrize("seed", range(6))
def test_roofline_terms_equal_the_reference(seed):
    ops = _ops(seed)
    consts = dict(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)
    rng = random.Random(100 + seed)
    flops, hbm = rng.uniform(0, 1e16), rng.uniform(0, 1e12)
    t = an.RooflineTerms(flops, hbm, [an.CollectiveOp(*o) for o in ops],
                         **consts)
    j = j_an.RooflineTerms(flops, hbm, [j_an.CollectiveOp(*o) for o in ops],
                           **consts)
    assert t.t_collective == j.t_collective
    assert t.dominant == j.dominant
    assert t.summary() == j.summary()
    assert an._breakdown(t.collectives) == j_an._breakdown(j.collectives)


def test_defaults_are_the_h100s():
    t = an.RooflineTerms(flops=989e12, hbm_bytes=3.35e12, collectives=[
        an.CollectiveOp("all-reduce", 450_000_000_000, 4)])
    assert (t.peak_flops, t.hbm_bw, t.ici_bw) == (989e12, 3.35e12, 450e9)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(1.0)
    assert t.t_collective == pytest.approx(2 * 3 / 4)
    assert an.HBM_BYTES == mm.H100_SXM.levels[-1].size_bytes == 80 * 2**30
    assert mm.H100_SXM.link_bw is None        # Table 1 reads the data sheet
    # no v5e constant anywhere in the port
    v5e = (j_an.PEAK_FLOPS_BF16, j_an.HBM_BW, j_an.ICI_BW)
    assert not set(v5e) & {an.PEAK_FLOPS_BF16, an.HBM_BW, an.LINK_BW}
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for lit in ("197e12", "819e9", " 50e9", "16 * 2**30"):
            assert lit not in text, (path, lit)


def _j_spec(spec):
    return j_mm.HardwareSpec(
        name=spec.name, peak_flops=spec.peak_flops,
        levels=tuple(j_mm.MemLevel(lv.name, lv.size_bytes, lv.read_bw)
                     for lv in spec.levels),
        link_bw=spec.link_bw)


@pytest.mark.parametrize("machine", [
    mm.H100_SXM, mm.HardwareSpec("x", None, (mm.MemLevel("DRAM", None,
                                                          None),)),
    mm.HardwareSpec("y", 1e15, (mm.MemLevel("HBM", None, 2e12),), 9e11),
    SimpleNamespace(name="fitted", peak_flops=None, hbm_bw=3.1e12,
                    link_bw=None),
    SimpleNamespace(name="fitted2", peak_flops=7e14, hbm_bw=None,
                    levels=(), link_bw=4e11),
    None])
def test_machine_constants_equal_the_reference(machine):
    jm = (_j_spec(machine) if isinstance(machine, mm.HardwareSpec)
          else machine)
    assert an.machine_constants(machine) == j_an.machine_constants(jm)


def test_machine_constants_by_name_and_fitted_model():
    assert an.machine_constants("nvidia-h100-sxm") == {
        "peak_flops": 989e12, "hbm_bw": 3.35e12}
    from repro_torch.characterize.fit import FittedMachineModel, LevelFit
    fitted = FittedMachineModel(levels=(LevelFit(
        "DRAM", None, None, {"load_sum": {"gbps": 3000.0, "ci": None,
                                          "n": 1}}),))
    assert an.machine_constants(fitted) == {"hbm_bw": 3e12}


def test_analyze_a_record_of_counts():
    ops = [an.CollectiveOp("all-gather", 1000, 16),
           an.CollectiveOp("all-reduce", 500, 16)]
    rec = an.analyze({"flops": 2e12, "hbm_bytes": 1e9, "collectives": ops,
                      "peak_device_bytes": 123}, model_flops=1e12,
                     machine="nvidia-h100-sxm")
    want = an.RooflineTerms(2e12, 1e9, ops).summary()
    assert {k: rec[k] for k in want} == want
    assert rec["useful_flop_ratio"] == 0.5
    assert rec["peak_device_bytes"] == 123
    assert rec["collective_breakdown"] == {
        "all-gather": {"count": 1, "bytes": 1000},
        "all-reduce": {"count": 1, "bytes": 500}}
    assert rec["machine_model"] == "nvidia-h100-sxm"
    assert an.analyze({"flops": 0, "hbm_bytes": 0})["dominant"] == "compute"


# ---------------------------------------------------------------------------
# a dry run of a reduced cell against the reference's probe
# ---------------------------------------------------------------------------

#: the port's FLOP count (matrix products, ``FlopCounterMode``) over XLA's
#: (which adds the elementwise work): measured 0.989 (train) and 0.954
#: (prefill) for reduced granite-3-2b, batch 8 x 64, on (1, 2, 2); at this
#: size the decode step is 0.53 (its elementwise share is large, and it is
#: not held)
PROBE_RATIO = (0.8, 1.25)
PROBE_KINDS = ("train", "prefill")

REF_PROBE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro.configs import ShapeConfig, get_arch, reduced
from repro.distributed.sharding import ShardCtx
from repro.launch import probe
from repro.launch.mesh import make_mesh
from repro.models.variant import VARIANTS, apply_rules
out = {}
for kind in %r:
    cfg = reduced(get_arch("granite-3-2b"))
    ctx = apply_rules(ShardCtx(make_mesh((1, 2, 2), ("pod", "data",
                                                      "model"))),
                      VARIANTS["baseline"])
    total = probe._zero()
    for name, mult, cost in probe.probe_parts(
            cfg, ShapeConfig("t", 64, 8, kind), ctx, VARIANTS["baseline"]):
        total = probe._add(total, cost, mult)
    out[kind] = total["flops"]
print(json.dumps(out))
"""

PORT_PROBE = r"""
import json
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.launch import dryrun, probe
from repro_torch.models.variant import VARIANTS
v = VARIANTS["baseline"]
ctx, rank = dryrun.fake_ctx((1, 2, 2), ("pod", "data", "model"), v)
out = {}
for kind in %r:
    cfg = reduced(get_arch("granite-3-2b"))
    shape = ShapeConfig("t", 64, 8, kind)
    parts = probe.probe_parts(cfg, shape, ctx, v)
    out[kind] = {"composed": sum(m * c["flops"] for _, m, c in parts),
                 "counted": sum(m * c["flops"] for _, m, c in parts
                                if not c.get("analytic")),
                 "whole": dryrun.trace(cfg, shape, ctx, v,
                                       memory=False)["flops"],
                 "rank": rank}
print(json.dumps(out))
"""


def _run(code: str, *args) -> dict:
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code, *args],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def probes():
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as ex:
        ref = ex.submit(_run, REF_PROBE % (PROBE_KINDS,))
        port = ex.submit(_run, PORT_PROBE % (PROBE_KINDS,))
        return ref.result(), port.result()


@pytest.mark.parametrize("kind", PROBE_KINDS)
def test_dry_run_against_the_reference_probe(probes, kind):
    """Reduced granite-3-2b, batch 8 x 64 on (1, 2, 2) in a fake world of
    4 (the rank of the last ``model`` coordinate): the port's parts
    composed (with the reference's analytic optimizer) over the
    reference's ``probe_parts`` on 4 forced host devices within
    PROBE_RATIO, and the port's counted parts equal to its whole step."""
    ref, port = probes
    p = port[kind]
    ratio = p["composed"] / ref[kind]
    assert PROBE_RATIO[0] <= ratio <= PROBE_RATIO[1], ratio
    assert p["counted"] == p["whole"]
    assert p["rank"] == 1


# ---------------------------------------------------------------------------
# the collective log against every torch.distributed call, gloo
# ---------------------------------------------------------------------------

CENSUS = r"""
import json, sys
import torch
import torch.distributed as tdist
from repro_torch.bench import distributed as dist
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry
from repro_torch.models.common import init_params
from repro_torch.optim import adamw
from repro_torch.train import step as step_mod

out, shapes = sys.argv[1], %r
dist.ensure_initialized("cpu")
rank = dist.process_index()
census = []


def wrap(name, kind, result):
    orig = getattr(tdist, name)

    def call(*a, **k):
        group = k.get("group")
        census.append((kind, result(*a), group))
        return orig(*a, **k)
    setattr(tdist, name, call)


wrap("all_gather", "all-gather",
     lambda parts, t: sum(p.numel() * p.element_size() for p in parts))
wrap("all_reduce", "all-reduce", lambda t: t.numel() * t.element_size())
for name in ("reduce_scatter_single", "reduce_scatter_tensor"):
    if hasattr(tdist, name):
        wrap(name, "reduce-scatter",
             lambda o, i: o.numel() * o.element_size())
cfg = reduced(get_arch("granite-3-2b"))
rep = {}
for shape in shapes:
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"), device="cpu")
    ctx = sh.ShardCtx(mesh)
    params = registry.shard_params(cfg, init_params(
        registry.build(cfg).param_specs(), torch.Generator().manual_seed(0)),
        ctx)
    batch = registry.make_batch(cfg, (8 // mesh.shape["data"], 32),
                                torch.Generator().manual_seed(1))
    step = step_mod.make_train_step(cfg, ctx, adamw.AdamWConfig(lr=1e-3))
    census.clear()
    with ctx.recording() as log:
        step(params, adamw.init_state(params), batch)
    axis_of = {id(g): a for a, g in mesh.groups.items()}
    rep["x".join(map(str, shape))] = {
        "log": sorted(list(entry) for entry in log),
        "census": sorted([kind, nbytes, mesh.shape[axis_of[id(g)]],
                          axis_of[id(g)]] for kind, nbytes, g in census)}
with open(f"{out}/census{rank}.json", "w") as f:
    json.dump(rep, f)
"""
CENSUS_MESHES = [(1, 2, 2), (1, 1, 4)]


@pytest.fixture(scope="module")
def census(tmp_path_factory):
    import json
    import sys
    from repro_torch.bench import distributed as dist
    import _train_mesh as tm
    out = tmp_path_factory.mktemp("census")
    sink = tm._Sink()
    rc = dist.launch_local([sys.executable, "-c", CENSUS % (CENSUS_MESHES,),
                            str(out)], processes=4, env=tm.env(),
                           timeout=600, stream_to=sink, device="cpu")
    assert rc == 0, sink.text()[-4000:]
    return [json.loads((out / f"census{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("shape", CENSUS_MESHES)
def test_collective_log_equals_the_census(census, shape):
    """A train step of reduced granite-3-2b on a gloo world of 4: the log
    ``ShardCtx.recording`` keeps equals every ``torch.distributed``
    collective the step calls, forward and backward (all-gathers counted
    by the gathered tensor, reduce-scatters by the rank's block,
    all-reduces by their operand), axis and group size included."""
    tag = "x".join(map(str, shape))
    for rep in census:
        log, calls = rep[tag]["log"], rep[tag]["census"]
        assert log == calls
        kinds = {c[0] for c in calls}
        assert kinds == {"all-gather", "reduce-scatter", "all-reduce"}
        axes = {c[3] for c in calls}
        assert axes == {a for a, n in zip(("pod", "data", "model"), shape)
                        if n > 1}
