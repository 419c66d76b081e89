"""The port's accounting audit (``repro_torch.audit``) against the reference's
(``repro.audit``) where the two meet, and on its own where they cannot.

Held equal to the reference: the declared bytes and flops of every mix under
every knob of the default grid, the formula lint's verdicts, the
``CaseAudit`` / ``AuditReport`` schema, the knob grid, the rw sampling, and
the ECM arithmetic (``ecm_predict``, ``validate_ecm``, ``predict_block_rows``
to 1e-12 relative, on the same profile numbers and the same fitted model).

On the port alone: the live ``torch`` audit of the whole registry is clean
here (meta tensors); the deviceless audit over the committed SASS goldens
(``tests/data_torch/sass``, written on an H100 by ``audit --write-goldens``)
exits 0; a corrupted declaration fails by name on both backends; the pinned
broken SASS (``tests/data_torch/sass/dce``: the copy kernel's pass-loop
loads replaced by NOPs) fails ``dce``; the live cuda audit raises, naming
``cuobjdump``, where the toolkit is missing; and the autotuner's two audit
branches run on a CPU runner."""
import dataclasses
import json
import math
import types
from pathlib import Path

import pytest

from repro.audit import ecm as ref_ecm
from repro.audit import verify as ref_verify
from repro.bench import mixes as ref_mixes
from repro.characterize.fit import FittedMachineModel as RefModel
from repro.characterize.fit import LevelFit as RefLevel
from repro.istream.analyze import InstructionProfile as RefProfile
from repro_torch.audit import ecm, verify
from repro_torch.bench import cli
from repro_torch.bench import mixes as port_mixes
from repro_torch.characterize.fit import FittedMachineModel, LevelFit
from repro_torch.core import autotune
from repro_torch.istream.analyze import InstructionProfile, json_record
from repro_torch.istream.extract import parse_sass
from repro_torch.kernels.membench import membench as mb

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "data_torch" / "sass"
SHAPE = (64, 128)
N = SHAPE[0] * SHAPE[1]
PASSES = 4
MIXES = port_mixes.mix_names()
GRID = verify.default_knob_grid()


# ---------------------------------------------------------------------------
# the reference's declarations, schema and grids
# ---------------------------------------------------------------------------

def test_the_registries_and_grids_are_the_references():
    assert MIXES == ref_mixes.mix_names()
    assert verify.default_knob_grid() == ref_verify.default_knob_grid()
    assert verify.default_knob_grid(True) == ref_verify.default_knob_grid(True)
    assert verify.SMOKE_MIXES == ref_verify.SMOKE_MIXES
    assert (verify.RTOL, verify.ATOL_ELEMS_PER_SWEEP, verify.DCE_FRACTION) \
        == (ref_verify.RTOL, ref_verify.ATOL_ELEMS_PER_SWEEP,
            ref_verify.DCE_FRACTION)
    for k, seed in ((3, 0), (5, 7), (12, 3)):
        assert verify.random_rw_pairs(k, seed) == \
            ref_verify.random_rw_pairs(k, seed)


@pytest.mark.parametrize("knobs", GRID, ids=[str(k) for k in GRID])
@pytest.mark.parametrize("mix", MIXES)
def test_declared_bytes_and_flops_equal_the_reference(mix, knobs):
    zero = {"loads": 0.0, "stores": 0.0, "arith": 0.0, "move": 0.0}
    ours = verify.audit_counts(port_mixes.get_mix(mix), "torch", SHAPE,
                               "float32", PASSES, zero, "eager", PASSES,
                               knobs=knobs)
    theirs = ref_verify.audit_counts(ref_mixes.get_mix(mix), "xla", SHAPE,
                                     "float32", PASSES, zero, "while",
                                     PASSES, knobs=knobs)
    assert ours.declared == theirs.declared


def _corruptions(name):
    m = port_mixes.get_mix(name)
    return [m, dataclasses.replace(m, reads_per_elem=m.reads_per_elem + 1),
            dataclasses.replace(m, flops_per_elem=m.flops_per_elem + 3),
            dataclasses.replace(m, writes_per_elem=m.writes_per_elem + 1)]


@pytest.mark.parametrize("mix", MIXES + ["rw_5to3", "fma_3"])
def test_lint_mix_gives_the_references_verdicts(mix):
    for ours in _corruptions(mix):
        theirs = dataclasses.replace(
            ref_mixes.get_mix(mix), reads_per_elem=ours.reads_per_elem,
            writes_per_elem=ours.writes_per_elem,
            flops_per_elem=ours.flops_per_elem)
        assert verify.lint_mix(ours) == ref_verify.lint_mix(theirs)


def test_case_audit_and_report_have_the_reference_keys():
    zero = {"loads": 0.0, "stores": 0.0, "arith": 0.0}
    ours = verify.audit_counts(port_mixes.get_mix("copy"), "torch", SHAPE,
                               "float32", PASSES, zero, "eager", PASSES)
    theirs = ref_verify.audit_counts(ref_mixes.get_mix("copy"), "xla", SHAPE,
                                     "float32", PASSES, zero, "while",
                                     PASSES)
    assert set(ours.to_dict()) == set(theirs.to_dict())
    assert [c.name for c in ours.checks] == [c.name for c in theirs.checks]
    assert {c.name for c in ours.failures} == {"dce"} \
        == {c.name for c in theirs.failures}
    rep, ref_rep = verify.AuditReport(cases=[ours]), \
        ref_verify.AuditReport(cases=[theirs])
    assert set(rep.to_dict()) == set(ref_rep.to_dict())
    assert set(rep.to_dict()["summary"]) == set(ref_rep.to_dict()["summary"])
    assert rep.exit_code() == verify.EXIT_VIOLATION == ref_verify.EXIT_VIOLATION
    assert verify.EXIT_OK == ref_verify.EXIT_OK == 0
    assert json.loads(rep.to_json())["cases"][0]["ok"] is False


# ---------------------------------------------------------------------------
# expectations and waivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mix", ["load_sum", "copy", "triad", "rw_3to1",
                                 "fma_8", "mxu", "latency_chase"])
def test_expected_counts_move_with_the_declaration(backend, mix):
    m = port_mixes.get_mix(mix)
    base = verify.expected_counts(m, backend, N)
    for field_, key in (("reads_per_elem", "loads"),
                        ("flops_per_elem", "arith")):
        bad = dataclasses.replace(m, **{field_: getattr(m, field_) + 1})
        moved = verify.expected_counts(bad, backend, N)[key] - base[key]
        assert moved >= N / 2, (field_, key, moved)


def test_waivers_name_their_reason_and_count():
    from repro_torch.obs import metrics
    for mix in MIXES:
        m = port_mixes.get_mix(mix)
        for backend in m.backends:
            assert verify.waiver_reason(m, backend, {}) is None
            for knobs in GRID:
                assert verify.waiver_reason(m, "cuda", knobs) is None
    reason = verify.waiver_reason(port_mixes.get_mix("copy"), "torch",
                                  {"interleave": 2})
    assert "interleave" in reason
    before = metrics.REGISTRY.snapshot()["counters"].get("audit_waivers", 0)
    audit = verify.audit_counts(port_mixes.get_mix("copy"), "torch", SHAPE,
                                "float32", PASSES, {}, "eager", PASSES,
                                knobs={"interleave": 2})
    assert audit.waived and audit.ok and audit.waived_reason == reason
    assert metrics.REGISTRY.snapshot()["counters"]["audit_waivers"] \
        == before + 1


# ---------------------------------------------------------------------------
# the live torch audit and the deviceless cuda audit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def torch_report():
    return verify.audit_registry(backends=("torch",))


def test_live_torch_audit_of_the_registry_is_clean(torch_report):
    assert torch_report.ok, torch_report.table()
    assert not torch_report.skipped
    assert {c.mix for c in torch_report.cases} == \
        set(port_mixes.mix_names("torch"))
    assert {c.where() for c in torch_report.waived} == {
        c.where() for c in torch_report.cases
        if c.knobs.get("interleave", 1) > 1}
    chase = [c for c in torch_report.cases if c.mix == "latency_chase"]
    assert chase and not any(c.waived for c in chase)


@pytest.fixture(scope="module")
def golden_report():
    return verify.audit_goldens(GOLDENS)


def test_goldens_audit_clean_and_cover_the_golden_set(golden_report):
    assert golden_report.ok, golden_report.table()
    assert golden_report.meta["source"] == "goldens"
    manifest = json.loads((GOLDENS / "manifest.json").read_text())
    want = {(m, b, u, dt) for m, b, u, p, k, dt, stem
            in verify.golden_cases()}
    got = {(c["mix"], c["backend"], c.get("unroll", 1), c["dtype"])
           for c in manifest["cases"]}
    assert got == want
    assert {c.backend for c in golden_report.cases} == {"torch", "cuda"}
    for case in golden_report.cases:
        names = [ch.name for ch in case.checks]
        assert {"loads", "stores", "arith", "loop", "trips"} <= set(names)
        if case.backend == "cuda":
            assert "launch" in names


def test_golden_launch_records_are_membench_s():
    manifest = json.loads((GOLDENS / "manifest.json").read_text())
    machine = (manifest["sms"], manifest["l2"])
    sass = {p.stem: set(parse_sass(p.read_text()))
            for p in GOLDENS.glob("*.sass")}
    for case in manifest["cases"]:
        if case["backend"] != "cuda":
            continue
        knobs = dict(case.get("knobs") or {}, unroll=case.get("unroll", 1))
        rec = mb.launch_record(case["mix"], case["dtype"], SHAPE, knobs,
                               case.get("passes", PASSES), *machine)
        assert json.loads(json.dumps(json_record(rec))) == case["launches"]
        for r in rec:
            assert r["kernel"] in sass[r["source"]], r["kernel"]


def test_cli_audit_goldens_exits_0_and_counts_waivers(capsys):
    assert cli.main(["audit", "--goldens", str(GOLDENS)]) == 0
    out = capsys.readouterr().out
    n = len(json.loads((GOLDENS / "manifest.json").read_text())["cases"])
    assert f"# {n} cases: {n} ok, 0 waived, 0 violations, 0 skipped" in out


def test_cli_audit_torch_json(capsys, tmp_path):
    out = tmp_path / "a.json"
    assert cli.main(["audit", "--backend", "torch", "--smoke", "--json",
                     "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["summary"]["violations"] == 0
    assert {c["mix"] for c in doc["cases"]} == set(verify.SMOKE_MIXES)
    assert json.loads(capsys.readouterr().out.split("# saved")[0]) == doc


def _corrupt(monkeypatch, name, **fields):
    bad = dataclasses.replace(port_mixes.get_mix(name), **fields)
    monkeypatch.setitem(port_mixes._REGISTRY, name, bad)


@pytest.mark.parametrize("where", ["torch", "goldens"])
def test_corrupted_declaration_fails_by_name(where, monkeypatch, capsys):
    _corrupt(monkeypatch, "copy", reads_per_elem=2.0)
    argv = (["audit", "--backend", "torch", "--mixes", "copy"]
            if where == "torch" else ["audit", "--goldens", str(GOLDENS)])
    assert cli.main(argv) == verify.EXIT_VIOLATION
    err = capsys.readouterr().err
    backends = ("torch",) if where == "torch" else ("torch", "cuda")
    for b in backends:
        assert f"error: accounting violation at {b}/copy" in err
        assert "loads: observed" in err


def test_pinned_broken_sass_fails_dce_by_name(capsys):
    report = verify.audit_goldens(GOLDENS / "dce")
    assert not report.ok
    (case,) = report.violations
    assert case.where() == "cuda/load_sum"
    assert [c.name for c in case.failures] == ["dce"]
    assert cli.main(["audit", "--goldens", str(GOLDENS / "dce")]) == \
        verify.EXIT_VIOLATION
    assert "accounting violation at cuda/load_sum: dce: timed work " \
        "eliminated" in capsys.readouterr().err
    # the fixture is the golden load_sum kernel with its loads (LDG) taken
    # out, and nothing else: same addresses, the fold kernel unchanged
    fixed = parse_sass((GOLDENS / "acc.cu.sass").read_text())
    broken = parse_sass((GOLDENS / "dce" / "acc.cu.sass").read_text())
    kernel = json.loads((GOLDENS / "dce" / "manifest.json").read_text()
                        )["cases"][0]["launches"][0]["kernel"]
    diff = [(a, b) for a, b in zip(fixed[kernel], broken[kernel]) if a != b]
    assert diff and all(" LDG" in a and " NOP " in b for a, b in diff)
    assert len(broken[kernel]) == len(fixed[kernel])
    assert all(broken[k] == fixed[k] for k in broken if k != kernel)


def test_live_cuda_audit_without_cuobjdump_raises_naming_it(monkeypatch,
                                                            tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuobjdump"):
        cli.main(["audit", "--backend", "cuda", "--mixes", "copy"])


# ---------------------------------------------------------------------------
# ECM: the reference's arithmetic
# ---------------------------------------------------------------------------

def _models(rate=1e9, l1_gbps=100.0, dram_gbps=10.0, l1_cap=100_000):
    out = []
    for model, level in ((FittedMachineModel, LevelFit), (RefModel, RefLevel)):
        out.append(model(
            name="synthetic",
            levels=(level(name="L1", capacity_bytes=l1_cap, capacity_ci=None,
                          bandwidth={"load_sum": {"gbps": l1_gbps,
                                                  "ci": None, "n": 1},
                                     "copy": {"gbps": 0.7 * l1_gbps,
                                              "ci": None, "n": 1}}),
                    level(name="DRAM", capacity_bytes=None, capacity_ci=None,
                          bandwidth={"load_sum": {"gbps": dram_gbps,
                                                  "ci": None, "n": 1}})),
            issue={"rate_elems_per_s": rate}))
    return out


def _profiles(mix, nbytes, loads, stores, arith, unroll=1):
    kw = dict(mix=mix, shape=(nbytes // 512, 128), dtype="float32",
              nbytes=nbytes, unroll=unroll, interleave=1,
              per_iter={"loads": loads, "stores": stores, "arith": arith,
                        "move": 0.0},
              critical_path=1.0, trips=PASSES, passes=PASSES, loop="loop")
    return (InstructionProfile(backend="cuda", **kw),
            RefProfile(backend="pallas", **kw))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


ECM_CASES = [("load_sum", 32768, 8192.0, 0.0, 8192.0, 1, 1e9),
             ("copy", 32768, 8192.0, 8192.0, 0.0, 2, 1e13),
             ("load_sum", 262144, 65536.0, 0.0, 65536.0, 1, 1e13),
             ("copy", 1 << 20, 262144.0, 262144.0, 9.0, 4, 3e10)]


@pytest.mark.parametrize("mix,nbytes,loads,stores,arith,unroll,rate",
                         ECM_CASES)
def test_ecm_predict_and_validate_agree_with_the_reference(
        mix, nbytes, loads, stores, arith, unroll, rate):
    ours_m, ref_m = _models(rate=rate)
    ours_p, ref_p = _profiles(mix, nbytes, loads, stores, arith, unroll)
    a, b = ecm.ecm_predict(ours_p, ours_m), ref_ecm.ecm_predict(ref_p, ref_m)
    for key in ("t_core_s", "t_data_s", "t_pred_s", "gbps"):
        assert _rel(getattr(a, key), getattr(b, key)) <= 1e-12, key
    assert a.bound == b.bound and set(a.level_times) == set(b.level_times)
    for k in a.level_times:
        assert _rel(a.level_times[k], b.level_times[k]) <= 1e-12
    assert set(a.to_dict()) == set(b.to_dict())
    point = types.SimpleNamespace(mix=mix, backend="cuda", nbytes=nbytes,
                                  passes=PASSES, mean_s=3.7e-5, unroll=unroll,
                                  block_rows=None, gbps=12.5)
    va = ecm.validate_ecm([(point, ours_p), (point, None)], ours_m)
    vb = ref_ecm.validate_ecm([(point, ref_p), (point, None)], ref_m)
    assert va["n"] == vb["n"] == 1
    for key in ("median_abs_rel_err", "max_abs_rel_err"):
        assert _rel(va[key], vb[key]) <= 1e-12
    assert _rel(va["rows"][0]["predicted_s"],
                vb["rows"][0]["predicted_s"]) <= 1e-12


@pytest.mark.parametrize("rate", [1e9, 1e11, 1e13])
@pytest.mark.parametrize("mix", ["load_sum", "copy", "triad"])
def test_predict_block_rows_agrees_with_the_reference(mix, rate):
    ours_m, ref_m = _models(rate=rate)
    cands = (8, 16, 32, 64, 128)
    a = ecm.predict_block_rows(1 << 16, ours_m, cands, mix=mix)
    b = ref_ecm.predict_block_rows(1 << 16, ref_m, cands, mix=mix)
    assert a.keys() == b.keys()
    assert all(_rel(a[r], b[r]) <= 1e-12 for r in a)
    assert ecm.ecm_filter_rows(1 << 16, ours_m, cands, keep=2, mix=mix) \
        == ref_ecm.ecm_filter_rows(1 << 16, ref_m, cands, keep=2, mix=mix)


def test_issue_ceiling_is_sms_x_4_x_clock():
    assert ecm.issue_ceiling(132, 1980.0) == 132 * 4 * 1980e6


# ---------------------------------------------------------------------------
# core.autotune: the two branches that need the audit
# ---------------------------------------------------------------------------

class _FakeRunner:
    """Deterministic 'timing': throughput peaked at block_rows=64 (the
    reference test's runner)."""

    def __init__(self):
        self.timed_rows = []

    def run(self, spec):
        rows = spec.block_rows or 128
        self.timed_rows.append(rows)
        gbps = 100.0 - abs(math.log2(rows) - 6.0) * 10.0
        return types.SimpleNamespace(
            points=[types.SimpleNamespace(gbps=gbps)])


def test_autotune_ecm_prefilter_matches_exhaustive():
    from repro.core import autotune as ref_autotune
    model, ref_model = _models(rate=1e9)
    exhaustive = autotune.sweep_block_shapes(N * 4, runner=_FakeRunner())
    runner = _FakeRunner()
    pruned = autotune.sweep_block_shapes(N * 4, model=model, ecm_keep=3,
                                         runner=runner)
    ref = ref_autotune.sweep_block_shapes(N * 4, model=ref_model, ecm_keep=3,
                                          runner=_FakeRunner())
    assert pruned.best_rows == exhaustive.best_rows == ref.best_rows == 64
    assert pruned.ecm["kept"] == ref.ecm["kept"]
    assert pruned.ecm["pruned"] == ref.ecm["pruned"] != []
    assert set(pruned.ecm["kept"]) == set(runner.timed_rows)
    assert all(_rel(pruned.ecm["predicted_gbps"][r],
                    ref.ecm["predicted_gbps"][r]) <= 1e-12
               for r in ref.ecm["predicted_gbps"])


def test_autotune_unroll_objective_records_the_audit(monkeypatch):
    class Unroll(_FakeRunner):
        def run(self, spec):
            u = spec.unroll or 1
            return types.SimpleNamespace(points=[types.SimpleNamespace(
                gbps=100.0 / (1.0 + 0.02 * (u - 1)) * (3 if u == 8 else 1))])
    tune = autotune.sweep_block_shapes(N * 4, mix="copy", tune_unroll=True,
                                       runner=Unroll())
    assert tune.unroll_audit == {u: None for u in autotune.CANDIDATE_UNROLLS}
    assert tune.best_unroll == 8
    monkeypatch.setattr(verify, "waiver_reason",
                        lambda mix, backend, knobs=None:
                        "test waiver" if (knobs or {}).get("unroll") == 8
                        else None)
    tune = autotune.sweep_block_shapes(N * 4, mix="copy", tune_unroll=True,
                                       runner=Unroll())
    assert tune.unroll_audit[8] == "test waiver" and tune.best_unroll == 1
