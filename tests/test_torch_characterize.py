"""``repro_torch.characterize`` and ``core/{machine_model,analysis,sweep,
autotune}`` against the JAX reference, side by side on the CPU.

Detection is plain float64 numpy in both packages: on the reference's
synthetic 2/3/4-level staircases (clean and at 2-6 % noise, ten seeds each)
``Detection.to_dict()`` must be EQUAL, not close.  The adaptive driver and
the whole ``characterize`` pipeline run over one duck-typed synthetic
runner (the reference test's), so both packages see the same numbers: the
sizes each round measures, the round history and the fitted model must be
equal too, apart from the backend's name (``torch`` <-> ``xla``).  Fitted
and legacy model JSON crosses both ways; the report renders the same text;
the CLI's ``characterize`` / ``history`` / ``diff`` keep the reference's
exit codes and headings.  Measured sizes stay <= 128 KiB, but for the
``--smoke`` preset, which is the reference's (16 KiB .. 64 MiB).
"""
import ast
import json
import types
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.bench.cli import main as ref_cli_main
from repro.bench.result import BenchResult as RefResult
from repro.characterize import adaptive_sweep as ref_adaptive_sweep
from repro.characterize import characterize as ref_characterize
from repro.characterize import detect as ref_detect
from repro.characterize import fit as ref_fit
from repro.characterize import report as ref_report
from repro.core import analysis as ref_analysis
from repro.core import autotune as ref_autotune
from repro.core import machine_model as ref_mm
from repro.obs import ledger as ref_ledger
from repro_torch import convert
from repro_torch.bench import BenchResult, Runner, cli
from repro_torch.characterize import (FittedMachineModel, adaptive_sweep,
                                      characterize, crosscheck_prior,
                                      detect_levels, probe_sizes,
                                      render_markdown)
from repro_torch.characterize import detect as port_detect
from repro_torch.characterize import report as port_report
from repro_torch.core import analysis as port_analysis
from repro_torch.core import autotune as port_autotune
from repro_torch.core import machine_model as port_mm
from repro_torch.core import sweep as port_sweep
from repro_torch.obs import ledger as port_ledger

ROOT = Path(__file__).resolve().parents[1]
DATA = Path(__file__).parent / "data"
KiB, MiB = 2**10, 2**20

# ---------------------------------------------------------------------------
# synthetic machines (the reference test's) — ground truth for both packages
# ---------------------------------------------------------------------------

TWO_LEVEL = [(256 * KiB, 80.0), (None, 10.0)]
THREE_LEVEL = [(32 * KiB, 120.0), (1 * MiB, 60.0), (None, 12.0)]
FOUR_LEVEL = [(32 * KiB, 150.0), (512 * KiB, 90.0), (8 * MiB, 40.0),
              (None, 9.0)]
TRUTHS = {"2level": TWO_LEVEL, "3level": THREE_LEVEL, "4level": FOUR_LEVEL}


def staircase(levels):
    def bw(size):
        for cap, g in levels:
            if cap is None or size <= cap:
                return g
        return levels[-1][1]
    return bw


def sample_curve(levels, lo=8 * KiB, hi=128 * MiB, n=48, noise=0.0, seed=0):
    bw = staircase(levels)
    sizes = np.unique(np.geomspace(lo, hi, n).astype(np.int64))
    rng = np.random.default_rng(seed)
    g = np.array([bw(s) for s in sizes])
    if noise:
        g = g * (1.0 + rng.normal(0.0, noise, size=len(g)))
    return sizes, g


class _Pt:
    def __init__(self, nbytes, mix, gbps):
        self.nbytes, self.mix, self.gbps = nbytes, mix, gbps


class _Res:
    def __init__(self):
        self.points, self.meta = [], {}


class SyntheticRunner:
    """Duck-typed Runner over a synthetic staircase machine (the reference
    test's): the same spec sizes give the same noise in either package."""
    PENALTY = {"load_sum": 1.0, "copy": 0.9, "fma_8": 0.7, "fma_32": 0.4}

    def __init__(self, levels=THREE_LEVEL, noise=0.02, seed=0, device=None):
        self.bw = staircase(levels)
        self.noise, self.seed = noise, seed
        self.sizes_run: list[int] = []
        if device is not None:
            self.device = device

    def run(self, spec):
        rng = np.random.default_rng(self.seed + hash(spec.sizes) % 2**16)
        res = _Res()
        for nb in spec.sizes:
            self.sizes_run.append(nb)
            for m in spec.mixes:
                g = self.bw(nb) * self.PENALTY.get(m, 0.5) \
                    * (1.0 + rng.normal(0.0, self.noise))
                res.points.append(_Pt(nb, m, g))
        res.meta["sizes"] = list(spec.sizes)
        return res


def _prior(mm):
    return mm.HardwareSpec("prior", None, (mm.MemLevel("L1d", 32 * KiB, None),
                                           mm.MemLevel("DRAM", None, None)))


def _without_backend(d: dict) -> dict:
    d = json.loads(json.dumps(d))
    d["provenance"].pop("backend", None)
    return d


# ---------------------------------------------------------------------------
# detect: identical on every fixture and seed
# ---------------------------------------------------------------------------

CURVES = [(name, 0.0, 0) for name in TRUTHS] + [
    (name, noise, seed) for name in TRUTHS for noise in (0.02, 0.04, 0.06)
    for seed in range(10)]


@pytest.mark.parametrize("name,noise,seed", CURVES,
                         ids=[f"{n}-{x}-s{s}" for n, x, s in CURVES])
def test_detect_levels_identical_to_the_reference(name, noise, seed):
    sizes, g = sample_curve(TRUTHS[name], noise=noise, seed=seed)
    ours = detect_levels(sizes, g, mix="load_sum")
    theirs = ref_detect.detect_levels(sizes, g, mix="load_sum")
    assert ours.to_dict() == theirs.to_dict()
    if noise <= 0.02:      # the reference recovers these level counts
        assert ours.n_levels == len(TRUTHS[name])
    for res in (0.1, 0.5):
        assert [asdict(b) for b in ours.unresolved(res)] == \
            [asdict(b) for b in theirs.unresolved(res)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_detect_small_and_single_level_curves_identical(n):
    for levels in (TWO_LEVEL, [(None, 42.0)]):
        sizes, g = sample_curve(levels, n=n, noise=0.03, seed=n)
        assert detect_levels(sizes, g).to_dict() == \
            ref_detect.detect_levels(sizes, g).to_dict()


def test_detect_rejects_what_the_reference_rejects():
    for sizes, g in (([], []), ([1024, 2048], [10.0]),
                     ([1024, 2048], [10.0, 0.0])):
        with pytest.raises(ValueError):
            ref_detect.detect_levels(sizes, g)
        with pytest.raises(ValueError):
            detect_levels(sizes, g)


def test_detect_from_result_on_a_result_carried_over():
    sizes, g = sample_curve(THREE_LEVEL, noise=0.03, seed=7)
    pts = []
    for s, v in zip(sizes, g):
        for mix, pen in (("copy", 0.9), ("load_sum", 1.0)):
            pts.append(dict(nbytes=int(s), mix=mix, dtype="float32",
                            backend="xla", passes=1, streams=1,
                            block_rows=None, reps=2,
                            bytes_per_call=float(s), flops_per_call=0.0,
                            mean_s=1e-3, std_s=0.0, min_s=1e-3,
                            gbps=float(v * pen), gflops=0.0))
    ref = RefResult.from_dict({"schema_version": 6, "points": pts})
    port = BenchResult.from_dict(convert.result_from_reference(ref.to_dict()))
    for mix in (None, "load_sum"):
        assert port_detect.detect_from_result(port, mix=mix).to_dict() == \
            ref_detect.detect_from_result(ref, mix=mix).to_dict()


# ---------------------------------------------------------------------------
# significant_step: one function, shared by the detector and the ledger
# ---------------------------------------------------------------------------

def test_significant_step_lives_in_detect_only():
    src = ROOT / "src" / "repro_torch"
    defs = [p.relative_to(src).as_posix() for p in src.rglob("*.py")
            for node in ast.walk(ast.parse(p.read_text()))
            if isinstance(node, ast.FunctionDef)
            and node.name == "significant_step"]
    assert defs == ["characterize/detect.py"]
    assert not hasattr(port_ledger, "significant_step")
    rng = np.random.default_rng(5)
    for _ in range(200):
        m1, m2 = rng.normal(0.0, 0.3, 2)
        n1, n2 = (int(v) for v in rng.integers(0, 8, 2))
        kw = dict(sigma=float(rng.uniform(0, 0.2)),
                  z=float(rng.uniform(1, 4)),
                  min_drop=float(rng.uniform(0.01, 0.3)))
        assert port_detect.significant_step(m1, n1, m2, n2, **kw) == \
            ref_detect.significant_step(m1, n1, m2, n2, **kw)


def _golden_variants():
    """The golden ledger record and edits of it: a 1.5x drop at pinned
    sigma, the reverse, a 3 % wobble, a drop under huge sigma, a zero
    cell, and moved cells."""
    base = json.loads((DATA / "ledger_golden.json").read_text())
    pinned = json.loads(json.dumps(base))
    for c in pinned["curves"]:
        c["log_sigma"] = 0.02
    slower = json.loads(json.dumps(pinned))
    for c in slower["curves"]:
        c["gbps"] /= 1.5
    wobble = json.loads(json.dumps(base))
    for c in wobble["curves"]:
        c["gbps"] *= 0.97
    noisy = json.loads(json.dumps(base))
    for c in noisy["curves"]:
        c["gbps"] /= 1.10
        c["log_sigma"] = 1.0
    zero = json.loads(json.dumps(base))
    zero["curves"][0]["gbps"] = 0.0
    moved = json.loads(json.dumps(base))
    cell = moved["curves"].pop()
    moved["curves"].append(dict(cell, nbytes=cell["nbytes"] * 2))
    return [(base, base, {}), (pinned, slower, {}), (slower, pinned, {}),
            (base, wobble, {"tolerance": 0.05}),
            (base, noisy, {"tolerance": 0.01}), (base, zero, {}),
            (base, moved, {}), (base, slower, {"z": 1.0})]


@pytest.mark.parametrize("case", range(8))
def test_diff_records_on_the_golden_record_matches_the_reference(case):
    base, cur, kw = _golden_variants()[case]
    ours = port_ledger.diff_records(base, cur, **kw)
    theirs = ref_ledger.diff_records(base, cur, **kw)
    assert json.dumps(ours.to_dict(), sort_keys=True) == \
        json.dumps(theirs.to_dict(), sort_keys=True)
    assert ours.table() == theirs.table()
    assert ours.exit_code() == theirs.exit_code()
    assert ours.identical == theirs.identical
    if case == 1:
        assert ours.exit_code() == 2


# ---------------------------------------------------------------------------
# adaptive sweep and the whole pipeline over one synthetic runner
# ---------------------------------------------------------------------------

SWEEPS = [
    ("3level", dict(lo=16 * KiB, hi=64 * MiB, resolution=0.10,
                    coarse_per_decade=3, max_rounds=8)),
    ("2level", dict(lo=16 * KiB, hi=64 * MiB, resolution=0.10,
                    coarse_per_decade=3)),
    ("4level", dict(lo=8 * KiB, hi=128 * MiB, resolution=0.05,
                    coarse_per_decade=4, max_rounds=6)),
    ("floor", dict(lo=8 * KiB, hi=256 * KiB, resolution=0.001,
                   coarse_per_decade=8, max_rounds=12)),
]
FLOOR = [(12 * KiB, 90.0), (None, 20.0)]


def _truth(name):
    return FLOOR if name == "floor" else TRUTHS[name]


@pytest.mark.parametrize("name,kw", SWEEPS, ids=[s[0] for s in SWEEPS])
def test_adaptive_sweep_measures_what_the_reference_measures(name, kw):
    ours_r = SyntheticRunner(_truth(name), noise=0.02)
    theirs_r = SyntheticRunner(_truth(name), noise=0.02)
    ours = adaptive_sweep("load_sum", runner=ours_r, **kw)
    theirs = ref_adaptive_sweep("load_sum", runner=theirs_r, **kw)
    assert ours_r.sizes_run == theirs_r.sizes_run
    assert ours.history == theirs.history
    assert ours.summary() == theirs.summary()
    assert ours.detection.to_dict() == theirs.detection.to_dict()
    assert ours.result.meta == theirs.result.meta
    assert ours.converged


def test_adaptive_sweep_rejects_zero_rounds():
    with pytest.raises(ValueError, match="max_rounds"):
        adaptive_sweep("load_sum", runner=SyntheticRunner(), max_rounds=0)


def _both_characterize(levels=THREE_LEVEL, prior=True, **kw):
    ours = characterize(runner=SyntheticRunner(levels), register=False,
                        prior=_prior(port_mm) if prior else None,
                        lo=16 * KiB, hi=64 * MiB, **kw)
    theirs = ref_characterize(runner=SyntheticRunner(levels), register=False,
                              prior=_prior(ref_mm) if prior else None,
                              lo=16 * KiB, hi=64 * MiB, **kw)
    return ours, theirs


@pytest.mark.parametrize("levels,prior", [(THREE_LEVEL, True),
                                          (FOUR_LEVEL, True),
                                          (TWO_LEVEL, False)],
                         ids=["3level", "4level", "2level-host-prior"])
def test_characterize_fits_the_model_the_reference_fits(levels, prior):
    (model, sweep), (ref_model, ref_sweep) = _both_characterize(levels, prior)
    assert model.provenance["backend"] == "torch"
    assert ref_model.provenance["backend"] == "xla"
    assert _without_backend(model.to_dict()) == \
        _without_backend(ref_model.to_dict())
    assert model.name == "host-cpu-fitted"
    assert sweep.summary() == ref_sweep.summary()
    assert model.hbm_bw == ref_model.hbm_bw
    assert model.innermost_capacity == ref_model.innermost_capacity
    assert probe_sizes(sweep.detection) == \
        ref_fit.probe_sizes(ref_sweep.detection)
    assert [asdict(l) for l in model.to_hardware_spec().levels] == \
        [asdict(l) for l in ref_model.to_hardware_spec().levels]
    legacy, ref_legacy = model.to_machine_model(), ref_model.to_machine_model()
    assert asdict(legacy) == asdict(ref_legacy)
    for doc in ("fujitsu-a64fx", "ampere-altra-q80-30"):
        assert model.compare_to(port_mm.get_spec(doc)) == \
            ref_model.compare_to(ref_mm.get_spec(doc))
    mixes = ("load_sum", "copy", "fma_8", "fma_32")
    assert all(set(l.bandwidth) == set(mixes) for l in model.levels) \
        or levels is TWO_LEVEL
    assert model.sysfs_prior == ref_model.sysfs_prior


def test_characterize_secondary_mix_path_and_empty_band_match():
    """The reference test's empty-band machine: detected L1 below 2x the
    grid floor keeps its detection cell; the probe skips it."""
    kw = dict(mixes=("load_sum", "copy"), register=False,
              lo=16 * KiB, hi=16 * MiB)
    levels = [(28 * KiB, 100.0), (None, 10.0)]
    model, sweep = characterize(
        runner=SyntheticRunner(levels, noise=0.0),
        prior=port_mm.HardwareSpec("p", None,
                                   (port_mm.MemLevel("DRAM", None, None),)),
        **kw)
    ref_model, _ = ref_characterize(
        runner=SyntheticRunner(levels, noise=0.0),
        prior=ref_mm.HardwareSpec("p", None,
                                  (ref_mm.MemLevel("DRAM", None, None),)),
        **kw)
    assert _without_backend(model.to_dict()) == \
        _without_backend(ref_model.to_dict())
    assert model.levels[0].bandwidth["load_sum"]["gbps"] == \
        pytest.approx(100.0, rel=0.1)


def test_crosscheck_prior_matches_the_reference():
    sizes, g = sample_curve(TWO_LEVEL, noise=0.01)
    levels = (("L1d", 256 * KiB), ("L2", 16 * MiB), ("DRAM", None))
    ours = crosscheck_prior(detect_levels(sizes, g), port_mm.HardwareSpec(
        "prior", None, tuple(port_mm.MemLevel(n, s, None) for n, s in levels)))
    theirs = ref_fit.crosscheck_prior(
        ref_detect.detect_levels(sizes, g), ref_mm.HardwareSpec(
            "prior", None, tuple(ref_mm.MemLevel(n, s, None)
                                 for n, s in levels)))
    assert ours == theirs
    by = {c["prior"]: c for c in ours["checks"]}
    assert by["L1d"]["within_bracket"] and not by["L2"]["within_bracket"]


def test_fitted_model_registers_in_the_port_registry():
    (model, _), _ = _both_characterize()
    model.name = "synthetic-3level-port"
    spec = model.register()
    assert port_mm.get_spec("synthetic-3level-port") is spec
    assert spec.levels[0].size_bytes == model.levels[0].capacity_bytes
    assert spec.peak_flops is None
    assert "synthetic-3level-port" not in ref_mm.available_specs()


# ---------------------------------------------------------------------------
# JSON across packages, the report
# ---------------------------------------------------------------------------

def test_fitted_model_json_crosses_both_ways(tmp_path):
    (model, _), (ref_model, _) = _both_characterize()
    model.to_json(tmp_path / "port.json")
    ref_model.to_json(tmp_path / "ref.json")
    a = ref_fit.FittedMachineModel.from_json(tmp_path / "port.json")
    b = FittedMachineModel.from_json(tmp_path / "ref.json")
    assert a.to_dict() == model.to_dict()
    assert b.to_dict() == ref_model.to_dict()
    assert FittedMachineModel.from_json(tmp_path / "port.json").levels \
        == model.levels
    d = json.loads((tmp_path / "port.json").read_text())
    assert d["schema_version"] == 3
    d["schema_version"] = 99
    with pytest.raises(ValueError, match="newer"):
        FittedMachineModel.from_dict(d)


def test_legacy_machine_model_json_loads_in_the_port(tmp_path):
    back = port_mm.MachineModel.from_json(DATA / "machine_model_v1.json")
    ref = ref_mm.MachineModel.from_json(DATA / "machine_model_v1.json")
    assert back.model_schema_version == 1
    assert asdict(back) == asdict(ref)
    assert back.hardware["levels"][0] == ("L1", 32768, None)
    m = port_mm.MachineModel(hardware={"name": "x",
                                       "levels": [("L1", 32768, None),
                                                  ("DRAM", None, None)]},
                             level_bw={"L1": {"load_sum": 9.0}},
                             ridge_flops_per_byte=2.0,
                             mix_penalty={"L1": {"load_sum": 1.0}})
    m.to_json(tmp_path / "m.json")
    assert ref_mm.MachineModel.from_json(tmp_path / "m.json").hardware == \
        m.hardware
    assert port_mm.MachineModel.from_json(tmp_path / "m.json") == m
    with pytest.raises(ValueError, match="newer"):
        port_mm.MachineModel.from_dict({"hardware": {},
                                        "model_schema_version": 3})


@pytest.mark.parametrize("doc", [None, "fujitsu-a64fx", "ampere-altra-q80-30",
                                 "marvell-thunderx2"])
def test_render_markdown_and_json_equal_for_the_same_model(doc, tmp_path):
    (model, sweep), (ref_model, ref_sweep) = _both_characterize()
    ours = FittedMachineModel.from_dict(ref_model.to_dict())
    documented = port_mm.get_spec(doc) if doc else None
    ref_doc = ref_mm.get_spec(doc) if doc else None
    md = render_markdown(ours, sweep, documented)
    assert md == ref_report.render_markdown(ref_model, ref_sweep, ref_doc)
    assert port_report.render_json(ours, sweep, documented) == \
        ref_report.render_json(ref_model, ref_sweep, ref_doc)
    for needle in ("Detected hierarchy", "Sweep economics",
                   "sysfs prior cross-check"):
        assert needle in md
    assert ("Table-1 deltas" in md) == (doc is not None)
    port_report.write_report(ours, tmp_path / "r.md", sweep, documented)
    port_report.write_report(ours, tmp_path / "r.json", sweep, documented)
    assert (tmp_path / "r.md").read_text() == md
    assert json.loads((tmp_path / "r.json").read_text())["model"] == \
        ours.to_dict()


# ---------------------------------------------------------------------------
# machine_model: registry, sysfs, the device prior
# ---------------------------------------------------------------------------

def test_registry_is_the_references_with_the_h100_for_the_tpu():
    for ref_spec in (ref_mm.A64FX, ref_mm.ALTRA, ref_mm.THUNDERX2):
        assert asdict(port_mm.get_spec(ref_spec.name)) == asdict(ref_spec)
    assert "tpu-v5e" in ref_mm.available_specs()
    assert "tpu-v5e" not in port_mm.available_specs()
    h100 = port_mm.get_spec("nvidia-h100-sxm")
    assert h100.peak_flops == 989e12
    assert [(l.name, l.size_bytes, l.read_bw) for l in h100.levels] == [
        ("L1", 132 * 256 * KiB, None), ("L2", 50 * MiB, None),
        ("DRAM", 80 * 2**30, 3.35e12)]
    assert "data sheet" in h100.notes
    assert port_mm.get_spec("host").levels[-1].name == "DRAM"
    with pytest.raises(KeyError, match="unknown machine spec"):
        port_mm.get_spec("tpu-v5e")
    with pytest.raises(ValueError, match="already registered"):
        port_mm.register_spec(port_mm.A64FX)
    assert port_mm.ALTRA.peak_flops is None and \
        port_mm.detect_host().peak_flops is None


@pytest.mark.parametrize("text", ["64K", "64k", "64KiB", "64 kB", "8M",
                                  "1MiB", "65536", "2g", "64X", "lots", ""])
def test_parse_cache_size_zoo(text):
    try:
        want = ref_mm.parse_cache_size(text)
    except ValueError:
        with pytest.raises(ValueError):
            port_mm.parse_cache_size(text)
        return
    assert port_mm.parse_cache_size(text) == want


def _write_cache_index(base, idx, level, typ, size):
    d = base / f"index{idx}"
    d.mkdir(parents=True)
    (d / "level").write_text(level)
    (d / "type").write_text(typ)
    (d / "size").write_text(size)


def test_detect_host_on_the_same_fake_sysfs(tmp_path):
    base = tmp_path / "cache"
    _write_cache_index(base, 0, "1", "Data", "32KiB")
    _write_cache_index(base, 1, "1", "Instruction", "32K")
    _write_cache_index(base, 2, "2", "Unified", "1024k")
    _write_cache_index(base, 3, "2", "Unified", "1024K")
    _write_cache_index(base, 4, "3", "Unified", "garbage")
    for where in (base, tmp_path / "nonexistent"):
        assert asdict(port_mm.detect_host(where)) == \
            asdict(ref_mm.detect_host(where))
    assert [(l.name, l.size_bytes) for l in port_mm.detect_host(base).levels] \
        == [("L1", 32 * KiB), ("L2", MiB), ("DRAM", None)]


H100_PROPS = types.SimpleNamespace(
    name="NVIDIA H100 80GB HBM3", L2_cache_size=50 * MiB,
    total_memory=85_520_809_984, multi_processor_count=132)


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA device as far as ``detect_device`` can tell, on the CPU."""
    from repro_torch.core import device
    monkeypatch.setattr(device, "resolve_device",
                        lambda d=None: torch.device("cuda" if d is None
                                                    else d))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: H100_PROPS)


def test_detect_device_reads_the_cards_properties(fake_card):
    spec = port_mm.detect_device()
    assert spec.name == "nvidia-h100-80gb-hbm3"
    assert [(l.name, l.size_bytes) for l in spec.levels] == \
        [("L2", 50 * MiB), ("DRAM", 85_520_809_984)]
    assert spec.peak_flops is None and "132 SMs" in spec.notes
    with pytest.raises(ValueError, match="detect_host"):
        port_mm.detect_device("cpu")


def test_detect_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_mm.detect_device()


def test_characterize_on_a_card_takes_the_cards_prior(fake_card):
    runner = SyntheticRunner(TWO_LEVEL, device=torch.device("cuda"))
    model, _ = characterize(runner=runner, backend="cuda", register=False,
                            lo=16 * KiB, hi=64 * MiB)
    assert model.name == "nvidia-h100-80gb-hbm3-fitted"
    assert model.provenance["backend"] == "cuda"
    assert model.sysfs_prior["prior_name"] == "nvidia-h100-80gb-hbm3"
    assert [c["prior"] for c in model.sysfs_prior["checks"]] == ["L2", "DRAM"]
    # a CPU runner keeps the host's sysfs prior and the reference's name
    cpu = SyntheticRunner(TWO_LEVEL, device=torch.device("cpu"))
    model, _ = characterize(runner=cpu, backend="cuda", register=False,
                            lo=16 * KiB, hi=64 * MiB)
    assert model.name == "host-cpu-fitted"
    assert model.sysfs_prior["prior_name"] == "host-cpu"


# ---------------------------------------------------------------------------
# analysis, sweep, autotune
# ---------------------------------------------------------------------------

def _seeded_result(seed: int = 3) -> dict:
    """A reference result dict with load_sum, copy and an fma ladder at
    five sizes, GB/s drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    pts = []
    for nb in (16 * KiB, 32 * KiB, 256 * KiB, 2 * MiB, 32 * MiB):
        base = 100.0 if nb <= 64 * KiB else 40.0 if nb <= 4 * MiB else 10.0
        for mix, rel in (("load_sum", 1.0), ("copy", 0.8), ("fma_1", 0.98),
                         ("fma_4", 0.93), ("fma_16", 0.6), ("fma_64", 0.2)):
            g = base * rel * float(1.0 + rng.normal(0.0, 0.02))
            pts.append(dict(nbytes=nb, mix=mix, dtype="float32",
                            backend="xla", passes=4, streams=1,
                            block_rows=None, reps=3, bytes_per_call=4.0 * nb,
                            flops_per_call=0.0, mean_s=1e-3, std_s=0.0,
                            min_s=1e-3, gbps=g, gflops=0.0))
    return {"schema_version": 6, "points": pts, "meta": {"dtype": "float32"}}


@pytest.mark.parametrize("source", ["result_v5", "seeded"])
def test_analysis_on_a_result_carried_over(source):
    d = (json.loads((DATA / "result_v5.json").read_text())
         if source == "result_v5" else _seeded_result())
    ref = RefResult.from_dict(d)
    port = BenchResult.from_dict(convert.result_from_reference(d))
    hw_levels = (("L1", 64 * KiB, 1e9), ("L2", 8 * MiB, None),
                 ("DRAM", None, None))
    hw = port_mm.HardwareSpec("doc", None, tuple(port_mm.MemLevel(*l)
                                                 for l in hw_levels))
    ref_hw = ref_mm.HardwareSpec("doc", None, tuple(ref_mm.MemLevel(*l)
                                                    for l in hw_levels))
    for band in ((4 * KiB, 32 * KiB), (128 * KiB, 4 * MiB), (0, 2**40)):
        for thr in (0.5, 0.9, 0.95):
            assert port_analysis.ridge_depth(port, band, thr) == \
                ref_analysis.ridge_depth(ref, band, thr)
    ours = port_analysis.build_machine_model(port, hw)
    theirs = ref_analysis.build_machine_model(ref, ref_hw)
    assert asdict(ours) == asdict(theirs)
    lbw = port_analysis.attribute_levels(port, hw)
    assert lbw == ref_analysis.attribute_levels(ref, ref_hw)
    pen = port_analysis.mix_penalties(lbw)
    assert pen == ref_analysis.mix_penalties(lbw)
    assert port_analysis.format_table(lbw, pen) == \
        ref_analysis.format_table(lbw, pen)
    if source == "seeded":
        assert port_analysis.ridge_depth(port, (4 * KiB, 32 * KiB)) == 16
        assert ours.ridge_flops_per_byte == 8.0


def test_run_sweep_on_the_cpu_keeps_the_legacy_schema(tmp_path):
    res = port_sweep.run_sweep(sizes=[16 * KiB, 64 * KiB],
                               mix_names=["load_sum", "copy"], reps=2,
                               target_bytes=1e6, device="cpu")
    assert [(p.mix, p.nbytes, p.dtype) for p in res.points] == [
        ("load_sum", 16 * KiB, "float32"), ("copy", 16 * KiB, "float32"),
        ("load_sum", 64 * KiB, "float32"), ("copy", 64 * KiB, "float32")]
    assert [p.passes for p in res.points] == [61, 61, 15, 15]
    assert all(p.gbps > 0 for p in res.points)
    res.to_json(tmp_path / "s.json")
    back = port_sweep.SweepResult.from_json(tmp_path / "s.json")
    assert back == res
    from repro.core.sweep import SweepResult as RefSweep
    assert [asdict(p) for p in RefSweep.from_json(tmp_path / "s.json").points] \
        == [asdict(p) for p in res.points]
    assert port_analysis.attribute_levels(res, port_mm.A64FX)


def test_model_block_rows_for_fitted_documented_and_json(tmp_path):
    (model, _), (ref_model, _) = _both_characterize()
    model.to_json(tmp_path / "fitted.json")
    for ours, theirs in ((model, ref_model), (port_mm.A64FX, ref_mm.A64FX),
                         (port_mm.THUNDERX2, ref_mm.THUNDERX2),
                         (str(tmp_path / "fitted.json"),
                          str(tmp_path / "fitted.json")),
                         (None, None)):
        assert port_autotune.model_block_rows(ours) == \
            ref_autotune.model_block_rows(theirs)
        assert port_autotune.choose_block_rows(2**20, model=ours) == \
            ref_autotune.choose_block_rows(2**20, model=theirs)
    assert port_autotune.model_block_rows(model) == 32
    assert port_autotune.model_block_rows(port_mm.H100_SXM) == 512
    cache = tmp_path / "tune.json"
    cache.write_text(json.dumps({"best_rows": 64, "best_unroll": 4}))
    assert port_autotune.choose_block_rows(2**20, cache_path=cache,
                                           model=model) == 64
    assert port_autotune.choose_unroll(cache) == 4
    assert port_autotune.choose_block_rows(2**20) == 128
    assert port_autotune.choose_unroll(tmp_path / "none.json") == 1


def test_sweep_block_shapes_runs_the_cuda_backend_and_defers_the_audit():
    """The name is kept from when the two audit branches were deferred;
    since the port of the audit they run, on the CPU runner as the
    reference's do, and record ``unroll_audit`` / ``ecm``."""
    runner = Runner(device="cpu")
    tune = port_autotune.sweep_block_shapes(64 * KiB, runner=runner, reps=2)
    assert tune.dtype == "float32" and tune.mix == "load_sum"
    assert sorted(tune.table) == [8, 16, 32, 64, 128]
    assert tune.best_rows in tune.table and tune.best_unroll == 1
    assert tune.unroll_audit is None and tune.ecm is None
    tuned = port_autotune.sweep_block_shapes(64 * KiB, runner=runner, reps=1,
                                             tune_unroll=True)
    assert sorted(tuned.unroll_table) == list(port_autotune.CANDIDATE_UNROLLS)
    assert tuned.unroll_audit == {u: None
                                  for u in port_autotune.CANDIDATE_UNROLLS}
    assert tuned.best_unroll in tuned.unroll_table
    (model, _), _ = _both_characterize()
    pruned = port_autotune.sweep_block_shapes(64 * KiB, runner=runner,
                                              reps=1, model=model, ecm_keep=2)
    assert sorted(pruned.table) == pruned.ecm["kept"]
    assert len(pruned.ecm["kept"]) == 2 and pruned.ecm["pruned"]
    assert set(pruned.ecm["predicted_gbps"]) == {8, 16, 32, 64, 128}


# ---------------------------------------------------------------------------
# the CLI: characterize, history, diff
# ---------------------------------------------------------------------------

def test_cli_characterize_smoke_on_the_torch_backend(tmp_path, capsys):
    out, report = tmp_path / "fitted.json", tmp_path / "report.md"
    argv = ["characterize", "--smoke", "--backend", "torch", "--device",
            "cpu", "--max-rounds", "1", "--resolution", "0.5", "--out",
            str(out), "--report", str(report), "--compare", "fujitsu-a64fx",
            "--history-root", str(tmp_path / "hist")]
    assert cli.main(argv) == 0
    d = json.loads(out.read_text())
    assert d["schema_version"] == 3 and d["levels"]
    assert d["provenance"]["backend"] == "torch"
    ref_fit.FittedMachineModel.from_json(out)          # loads in the reference
    text = capsys.readouterr().out
    for needle in ("Detected hierarchy", "Table-1 deltas",
                   "# saved fitted model (schema v3", "# ledger +="):
        assert needle in text
    assert "Detected hierarchy" in report.read_text()
    [rec] = port_ledger.read_ledger(tmp_path / "hist")
    assert rec["cmd"] == "characterize" and rec["backend"] == "torch"
    assert cli.main(argv) == 2                          # refuses to overwrite
    assert "refusing to overwrite" in capsys.readouterr().err


def test_characterize_on_the_cuda_backend_runs_the_plain_versions_on_cpu():
    runner = Runner(device="cpu")
    model, sweep = characterize(("copy", "load_sum"), primary="copy",
                                runner=runner, backend="cuda",
                                register=False, lo=16 * KiB, hi=128 * KiB,
                                coarse_per_decade=3, max_rounds=1, reps=2,
                                target_bytes=1e6)
    assert sweep.rounds == 1
    assert {p.backend for p in sweep.result.points} == {"cuda"}
    assert {p.mix for p in sweep.result.points} >= {"copy"}
    assert all(p.nbytes <= 128 * KiB and p.gbps > 0
               for p in sweep.result.points)
    assert model.provenance["backend"] == "cuda"
    assert model.name == "host-cpu-fitted"
    assert FittedMachineModel.from_dict(model.to_dict()).to_dict() == \
        model.to_dict()


def test_cli_characterize_default_device_raises_and_names_the_flag():
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["characterize", "--smoke", "--no-ledger"])


def _norm(text: str, *roots) -> str:
    for r in roots:
        text = text.replace(str(r), "ROOT")
    return text


def test_cli_history_and_diff_exit_codes_match_the_reference(tmp_path,
                                                              capsys):
    golden = DATA / "ledger_golden.json"
    rec = json.loads(golden.read_text())
    for c in rec["curves"]:
        c["log_sigma"] = 0.02
    cur = tmp_path / "cur.json"
    cur.write_text(json.dumps(rec))
    fast = json.loads(json.dumps(rec))
    for c in fast["curves"]:
        c["gbps"] *= 2.0
    fastp = tmp_path / "fast.json"
    fastp.write_text(json.dumps(fast))
    ours_root, ref_root = tmp_path / "ours", tmp_path / "ref"
    steps = [["history"], ["history", "--add", str(golden)],
             ["history", "--json"],
             ["diff", "--baseline", "-1"], ["diff", "--baseline", "latest",
                                            "--json"],
             ["diff", "--baseline", str(fastp), "--current", str(cur)],
             ["diff", "--baseline", "zzzz"]]
    codes = []
    for argv in steps:
        rc = cli.main(argv + ["--history-root", str(ours_root)])
        ours = capsys.readouterr()
        ref_rc = ref_cli_main(argv + ["--history-root", str(ref_root)])
        theirs = capsys.readouterr()
        assert rc == ref_rc, argv
        assert _norm(ours.out, ours_root) == _norm(theirs.out, ref_root)
        assert _norm(ours.err, ours_root) == _norm(theirs.err, ref_root)
        codes.append(rc)
    assert codes == [0, 0, 0, 0, 0, 2, 2]


class _Captured(Exception):
    pass


@pytest.mark.parametrize("preset", [["--smoke"], ["--full"], []],
                         ids=["smoke", "full", "default"])
def test_cli_characterize_presets_are_the_references(preset, monkeypatch):
    import repro.characterize as ref_pkg
    import repro_torch.characterize as port_pkg
    seen = {}

    def fake(key):
        def run(mixes, primary, **kw):
            seen[key] = dict(kw, mixes=mixes, primary=primary)
            raise _Captured
        return run

    monkeypatch.setattr(ref_pkg, "characterize", fake("ref"))
    monkeypatch.setattr(port_pkg, "characterize", fake("port"))
    argv = ["characterize", *preset, "--resolution", "0.2", "--no-ledger"]
    with pytest.raises(_Captured):
        ref_cli_main(argv)
    with pytest.raises(_Captured):
        cli.main(argv + ["--device", "cpu"])
    ours, theirs = seen["port"], seen["ref"]
    assert ours.pop("backend") == "cuda" and theirs.pop("backend") == "xla"
    assert isinstance(ours.pop("runner"), Runner)
    assert ours == theirs
