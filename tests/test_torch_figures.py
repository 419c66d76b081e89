"""The paper's figure scripts, Table 1 and the suite runner of the port
(``benchmarks_torch/``) against the reference's (``benchmarks/``), script by
script: the declared specs equal under ``convert.spec_from_reference``
(``xla`` <-> ``torch``), and a run at <= 128 KiB (sizes patched the same way
in both packages) emits the same row names (backend names mapped) and the
same accounting — nbytes, passes, bytes and flops a call.  Timings are never
compared: both sides run on this host's CPU (``device="cpu"``,
``backend="torch"``).  The twins of ``tests/test_bench_rw.py``'s fig5
tests are here too; fig3 and fig6 (the instruction-profile figures) are in
``test_torch_figures_istream.py``, fig4 and the launcher script in
``test_torch_figures_mesh.py``."""
import inspect
import json
import re
import sys

import pytest

import benchmarks.fig1_addressing as ref_fig1
import benchmarks.fig2_hierarchy as ref_fig2
import benchmarks.fig5_rw_ratio as ref_fig5
import benchmarks.fig6_istream as ref_fig6
import benchmarks.fig7_loaded_latency as ref_fig7
import benchmarks.run as ref_run
import benchmarks.table1_machine as ref_table1
import benchmarks_torch.fig1_addressing as fig1
import benchmarks_torch.fig2_hierarchy as fig2
import benchmarks_torch.fig5_rw_ratio as fig5
import benchmarks_torch.fig6_istream as fig6
import benchmarks_torch.fig7_loaded_latency as fig7
import benchmarks_torch.run as run
import benchmarks_torch.table1_machine as table1
import repro.bench
import repro.bench.cli as ref_cli
import repro_torch.bench.cli as cli
from _figures import (CPU, ROOT, SMALL, Stop, accounting, map_rows,
                      recording, row_names, same_specs)
from repro.bench import BenchResult as RefResult
from repro_torch import convert
from repro_torch.bench import BenchResult


@pytest.fixture
def art(monkeypatch, tmp_path):
    """Every script's artifact directory in a temporary one, both
    packages."""
    for mod in (ref_fig2, ref_fig5, ref_fig6, ref_fig7, ref_table1):
        monkeypatch.setattr(mod, "ART", tmp_path / "ref")
    for mod in (fig2, fig5, fig6, fig7):
        monkeypatch.setattr(mod, "ART", tmp_path / "torch")
    return tmp_path


# ---------------------------------------------------------------------------
# one script, two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quick", [True, False])
def test_fig1_declares_the_reference_specs(monkeypatch, quick):
    log = []
    monkeypatch.setattr(ref_fig1, "Runner",
                        recording(repro.bench.Runner, log, Stop()))
    with pytest.raises(Stop):
        ref_fig1.main(quick=quick)
    same_specs(log, fig1.specs(quick, backend="torch"))
    assert fig1.STREAM_COUNTS == ref_fig1.STREAM_COUNTS


def test_fig1_small_run_matches_the_reference(monkeypatch, capsys):
    for mod in (ref_fig1, fig1):
        monkeypatch.setattr(mod, "hierarchy_grid", lambda **kw: SMALL)
    ref = ref_fig1.main(quick=True)
    ref_out = capsys.readouterr().out
    port = fig1.main(quick=True, **CPU)
    out = capsys.readouterr().out
    assert row_names(out) == row_names(ref_out)
    assert len(row_names(out)) == 8
    assert accounting(port.points) == accounting(ref.points)
    assert "rel=1.000" in out


@pytest.mark.parametrize("quick", [True, False])
def test_fig2_declares_the_reference_spec(quick):
    same_specs([ref_fig2.spec_for(quick)], [fig2.spec_for(quick, "torch")])


def test_fig2_small_run_matches_the_reference(monkeypatch, capsys, art):
    for mod in (ref_fig2, fig2):
        monkeypatch.setattr(mod, "hierarchy_grid", lambda **kw: SMALL)
    ref_fig2.main(quick=True)
    ref_out = capsys.readouterr().out
    port = fig2.main(quick=True, **CPU)
    out = capsys.readouterr().out
    assert row_names(out) == row_names(ref_out)
    assert len(row_names(out)) == 6
    ref = RefResult.from_json(art / "ref" / "fig2_sweep.json")
    assert accounting(port.points) == accounting(ref.points)
    # the port's files under artifacts/torch, the level model the host's
    saved = BenchResult.from_json(art / "torch" / "fig2_sweep.json")
    assert accounting(saved.points) == accounting(port.points)
    model = json.loads((art / "torch" / "machine_model_cpu.json").read_text())
    ref_model = json.loads((art / "ref" / "machine_model_host.json")
                           .read_text())
    assert model["hardware"]["name"] == "host-cpu"
    assert {k: sorted(v) for k, v in model["level_bw"].items()} == \
        {k: sorted(v) for k, v in ref_model["level_bw"].items()}


def test_fig2_writes_under_artifacts_torch():
    assert fig2.ART == ROOT / "artifacts" / "torch"
    assert fig2.model_path("cuda").name == "machine_model_cuda.json"
    for mod in (fig5, fig6, fig7):
        assert mod.ART == fig2.ART


@pytest.mark.parametrize("quick,smoke", [(True, False), (False, False),
                                         (False, True)])
def test_fig5_declares_the_reference_spec(quick, smoke):
    same_specs([ref_fig5.spec_for(quick, smoke)],
                [fig5.spec_for(quick, smoke, "torch", "cpu")])
    assert fig5.RATIOS == ref_fig5.RATIOS


def test_fig5_small_run_matches_the_reference(monkeypatch, capsys, art):
    for mod in (ref_fig5, fig5):
        monkeypatch.setattr(mod, "quick_sizes", lambda levels: SMALL)
    ref_fig5.main(quick=True)
    ref_out = capsys.readouterr().out
    fig5.main(quick=True, **CPU)
    out = capsys.readouterr().out
    assert row_names(out) == row_names(ref_out)
    assert len(row_names(out)) == 10
    ref = RefResult.from_json(art / "ref" / "fig5_rw_ratio.json")
    port = BenchResult.from_json(art / "torch" / "fig5_rw_ratio.json")
    assert accounting(port.points) == accounting(ref.points)
    assert out.split("\n\n")[1].splitlines()[0] == \
        ref_out.split("\n\n")[1].splitlines()[0]         # the table header


def test_fig5_quick_sizes_sit_inside_attribution_bands():
    """Twin of ``test_bench_rw.py::test_fig5_quick_sizes_sit_inside_
    attribution_bands``, plus the card's levels (``detect_device``'s L2 and
    device memory): every quick size attributes to exactly one level."""
    from repro_torch.bench.result import level_band
    from repro_torch.core.machine_model import MemLevel
    card = (MemLevel("L2", 50 * 2**20, None),
            MemLevel("DRAM", 80 * 2**30, None))
    levels = (MemLevel("L1", 32 * 2**10, None),
              MemLevel("L2", 256 * 2**10, None),
              MemLevel("L3", 8 * 2**20, None),
              MemLevel("DRAM", None, None))
    sizes = fig5.quick_sizes(levels)
    assert sizes == ref_fig5.quick_sizes(levels)
    assert len(sizes) == len(levels)
    prev = 2 * 2**10
    for lvl, size in zip(levels, sizes):
        lo, hi = level_band(lvl.size_bytes, prev)
        assert lo < size < hi, (lvl.name, size, lo, hi)
        if lvl.size_bytes:
            prev = lvl.size_bytes
    # cacheless topology still yields a multi-size sweep
    assert len(fig5.quick_sizes((MemLevel("DRAM", None, None),))) >= 3
    # a big last-level cache must not push the DRAM size below its band
    # floor (the capped-size regression): 2x the floor is always in-band
    big = (MemLevel("L3", 64 * 2**20, None), MemLevel("DRAM", None, None))
    dram_lo, _ = level_band(None, big[0].size_bytes)
    assert fig5.quick_sizes(big)[-1] > dram_lo
    # the card: one size inside the L2's band, one above it, and the two
    # sizes a cacheless detection adds
    on_card = fig5.quick_sizes(card)
    l2_lo, l2_hi = level_band(card[0].size_bytes, 2 * 2**10)
    assert any(l2_lo < s < l2_hi for s in on_card)
    assert max(on_card) > 2 * card[0].size_bytes and len(on_card) == 4


def test_fig5_smoke_emits_ratio_table(capsys):
    """Twin of ``test_bench_rw.py::test_fig5_smoke_emits_ratio_table``."""
    summary = fig5.main(smoke=True, **CPU)
    cap = capsys.readouterr()
    assert "fig5/rw_2to1/" in cap.out
    assert "R:W" in cap.out and "1:1" in cap.out and "3:1" in cap.out
    assert set(summary) == {"all"}
    assert {"rw_1to1", "rw_2to1", "rw_3to1"} <= set(summary["all"])


@pytest.mark.parametrize("quick,smoke", [(True, False), (False, False),
                                         (False, True)])
def test_fig6_and_fig7_declare_the_reference_grids(quick, smoke):
    assert fig6.grid(quick, smoke) == ref_fig6.grid(quick, smoke)
    assert fig7.grid(quick, smoke) == ref_fig7.grid(quick, smoke)


def test_fig7_small_run_matches_the_reference(monkeypatch, capsys, art):
    small = dict(sizes=SMALL[:1], loads=(0, 1), reps=1)
    for mod in (ref_fig7, fig7):
        monkeypatch.setattr(mod, "grid", lambda quick, smoke: dict(small))
    ref = ref_fig7.main(quick=True, backend="xla")
    ref_out = capsys.readouterr().out
    port = fig7.main(quick=True, **CPU)
    out = capsys.readouterr().out
    assert row_names(out) == map_rows(row_names(ref_out))
    assert len(row_names(out)) == 2
    assert accounting(port.points) == accounting(ref.points)
    assert all(p.latency_ns > 0 for p in port.points)


def test_fig7_defaults_to_the_kernels():
    assert inspect.signature(fig7.main).parameters["backend"].default \
        == "cuda" == convert.BACKEND_FROM_REFERENCE["pallas"]


def test_table1_prints_the_card_the_papers_systems_and_the_host(capsys,
                                                                art):
    from repro_torch.core.machine_model import H100_SXM
    (art / "torch").mkdir()
    (art / "torch" / "machine_model_cpu.json").write_text(json.dumps(
        {"hardware": {}, "level_bw": {"DRAM": {"load_sum": 12.5}}}))
    table1.main(device="cpu")
    out = capsys.readouterr().out
    names = re.findall(r"^## (.+)$", out, re.M)
    assert names == [H100_SXM.name, "fujitsu-a64fx", "ampere-altra-q80-30",
                     "marvell-thunderx2", "host-cpu"]
    assert "tpu" not in out.lower()
    assert "measured(best mix): 12.5 GB/s" in out
    ref_table1.main()
    assert row_names(capsys.readouterr().out) == row_names(out) \
        == ["table1/systems"]


# ---------------------------------------------------------------------------
# the suite runner and the launcher script
# ---------------------------------------------------------------------------

def test_run_bench_and_table1_match_the_reference(monkeypatch, capsys,
                                                  tmp_path, art):
    """``--only bench,table1``: the bench entry's rows and saved accounting
    equal the reference's (its quick preset patched to <= 64 KiB in both
    CLIs), table1 its row."""
    def small_quick(original):
        return lambda backend, **kw: original(backend=backend,
                                              **dict(kw, sizes=SMALL))
    monkeypatch.setattr(ref_cli, "quick_spec", small_quick(ref_cli.quick_spec))
    monkeypatch.setattr(cli, "quick_spec", small_quick(cli.quick_spec))
    for mod, name in ((ref_run, "ref"), (run, "torch")):
        (tmp_path / name).mkdir()
        monkeypatch.setattr(mod, "ROOT", tmp_path / name)
    monkeypatch.setattr(sys, "argv", ["run", "--only", "bench,table1"])
    ref_run.main()
    ref_out = capsys.readouterr().out
    assert run.main(["--only", "bench,table1", "--device", "cpu",
                     "--backend", "torch"]) == 0
    out = capsys.readouterr().out
    assert row_names(out) == map_rows(row_names(ref_out))
    assert len(row_names(out)) == 7
    ref = RefResult.from_json(tmp_path / "ref" / "artifacts" /
                              "bench_quick.json")
    port = BenchResult.from_json(tmp_path / "torch" / "artifacts" / "torch" /
                                 "bench_quick.json")
    assert accounting(port.points) == accounting(ref.points)


def test_run_keeps_the_reference_entries():
    """The entries the reference's ``run.py`` asks ``want`` about, in its
    order, each asked about here too: every entry is ported (``roofline``
    since the dry run: ``tests/test_torch_dryrun.py``)."""
    ref = re.findall(r'want\("(\w+)"\)', inspect.getsource(ref_run))
    assert sorted(run.ENTRIES) == sorted(ref)
    port = re.findall(r'want\("(\w+)"\)', inspect.getsource(run))
    assert sorted(port) == sorted(ref)
    assert not hasattr(run, "NOT_PORTED")


@pytest.mark.parametrize("entry", ["roofline"])
def test_run_entries_not_ported_exit_nonzero(capsys, entry, tmp_path,
                                             monkeypatch):
    """``roofline`` renders the dry run's records; a record of a failed
    cell (``status: error``) makes the entry exit non-zero, a skipped one
    does not."""
    from benchmarks_torch import roofline_table
    monkeypatch.setattr(roofline_table, "ART", tmp_path / "dryrun")
    monkeypatch.setattr(roofline_table, "PROBE", tmp_path / "probe")
    (tmp_path / "dryrun").mkdir()
    skipped = {"arch": "a", "shape": "s", "multi_pod": False,
               "status": "skipped", "reason": "r"}
    (tmp_path / "dryrun" / "a__s__pod1__baseline.json").write_text(
        json.dumps(skipped))
    assert run.main(["--only", entry, "--device", "cpu"]) == 0
    assert "| a | s | 16x16 | - | - | - | skipped |" in \
        capsys.readouterr().out
    (tmp_path / "dryrun" / "b__s__pod1__baseline.json").write_text(
        json.dumps(dict(skipped, arch="b", status="error", error="E")))
    assert run.main(["--only", entry, "--device", "cpu"]) == 1
    assert "| b | s | 16x16 | ERROR: E |" in capsys.readouterr().out


def test_run_rejects_an_unknown_entry(capsys):
    with pytest.raises(SystemExit):
        run.main(["--only", "fig9", "--device", "cpu"])
    assert "unknown entries" in capsys.readouterr().err


def test_scripts_without_a_gpu_raise_naming_the_flag():
    """The default device is cuda: with none present, no script runs on
    the CPU by itself."""
    for call in (lambda: fig1.main(quick=True),
                 lambda: fig2.main(quick=True),
                 lambda: fig7.main(smoke=True),
                 lambda: table1.main()):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()
