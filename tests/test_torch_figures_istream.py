"""fig3 (block shapes, the ECM self-calibration, the kernel path) and fig6
(the issue-bound classification) of the port against the reference's, as
``test_torch_figures.py`` holds the other figures: the declared specs, and a
run at <= 128 KiB with the same row names and accounting.  Both read
instruction profiles (the port's from the aten trace on ``torch``), which
makes them the slowest of the figure tests."""
import functools
import inspect

import pytest

import benchmarks.fig3_blockshape as ref_fig3
import benchmarks.fig6_istream as ref_fig6
import benchmarks_torch.fig3_blockshape as fig3
import benchmarks_torch.fig6_istream as fig6
import repro.bench
import repro_torch.bench
from _figures import (CPU, SMALL, accounting, map_rows, recording, row_names,
                      same_specs)
from repro.istream import run_istream as ref_run_istream
from repro_torch import convert
from repro_torch.bench import BenchSpecError


@pytest.mark.parametrize("quick", [True, False])
def test_fig3_declares_the_reference_specs(monkeypatch, quick):
    """Every measured block shape's spec, then the kernel path's first."""
    ref_log, log = [], []
    monkeypatch.setattr(ref_fig3, "Runner", recording(
        repro.bench.Runner, ref_log, repro.bench.BenchSpecError("seen")))
    monkeypatch.setattr(fig3, "Runner", recording(
        repro_torch.bench.Runner, log, BenchSpecError("seen")))
    with pytest.raises(repro.bench.BenchSpecError):
        ref_fig3.main(quick=quick)
    with pytest.raises(BenchSpecError):
        fig3.main(quick=quick, **CPU)
    n = len(fig3.rows_for(quick))
    assert len(log) == len(ref_log) == n + 1
    same_specs(ref_log[:n], log[:n])
    # the kernel path: the reference's pallas spec is the port's cuda one
    assert log[n].to_dict() == convert.spec_from_reference(
        ref_log[n].to_dict())
    assert log[n].backend == "cuda" and log[n].sizes == (64 * 2**10,)


def _shrinking(base, results: list):
    """A Runner whose fig3 sweep runs at 64 KiB instead of 4 MiB (the
    kernel path is 64 KiB already)."""
    class Shrinking(base):
        def run(self, spec, *a, **kw):
            if spec.sizes == (4 * 2**20,):
                spec = spec.replace(sizes=(64 * 2**10,))
            res = super().run(spec, *a, **kw)
            results.append(res)
            return res
    return Shrinking


def test_fig3_small_run_matches_the_reference(monkeypatch, capsys):
    ref_res, res = [], []
    monkeypatch.setattr(ref_fig3, "Runner",
                        _shrinking(repro.bench.Runner, ref_res))
    monkeypatch.setattr(fig3, "Runner",
                        _shrinking(repro_torch.bench.Runner, res))
    ref_fig3.main(quick=True)
    ref_out = capsys.readouterr().out
    fig3.main(quick=True, **CPU)
    out = capsys.readouterr().out
    # the sweep rows and the ECM rows, in order; no profile failed
    assert row_names(out) == row_names(ref_out)
    assert len(row_names(out)) == 8
    assert "# ecm: profile extraction failed" not in out
    assert "# ecm predicted-vs-measured over 4 block shapes" in out
    assert "verified vs oracle (the wrappers' plain versions on the CPU)" \
        in out
    assert [accounting(r.points) for r in res] == \
        [accounting(r.points) for r in ref_res]



def test_fig6_sweeps_the_counterparts_of_the_reference_backends():
    ref_default = inspect.signature(ref_run_istream).parameters[
        "backends"].default
    assert fig6.BACKENDS == tuple(convert.BACKEND_FROM_REFERENCE[b]
                                  for b in ref_default)


def test_fig6_small_run_matches_the_reference(monkeypatch, capsys,
                                             tmp_path):
    small = dict(sizes=SMALL[:1], unrolls=(1, 2), interleaves=(1, 2),
                 reps=1)
    for mod in (ref_fig6, fig6):
        monkeypatch.setattr(mod, "grid", lambda quick, smoke: dict(small))
    monkeypatch.setattr(ref_fig6, "ART", tmp_path / "ref")
    monkeypatch.setattr(fig6, "ART", tmp_path / "torch")
    monkeypatch.setattr(ref_fig6, "run_istream",
                        functools.partial(ref_run_istream,
                                          backends=("xla",)))
    ref = ref_fig6.main(quick=True, out=None)
    ref_out = capsys.readouterr().out
    port = fig6.main(quick=True, backend="torch", device="cpu")
    out = capsys.readouterr().out
    assert row_names(out) == map_rows(row_names(ref_out))
    assert len(row_names(out)) == 8
    key = lambda p: (p.mix, p.unroll, p.interleave)  # noqa: E731
    assert accounting(sorted(port.result.points, key=key)) == \
        accounting(sorted(ref.result.points, key=key))
    # every point classified, as the reference's
    assert all(p.istream and p.istream["label"] != "unclassified"
               for p in port.result.points)
