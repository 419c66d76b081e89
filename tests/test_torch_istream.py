"""The port's instruction-stream microscope (``repro_torch.istream``) against
the reference's (``repro.istream``) where the two meet, and on the SASS the
hand-written kernels compile to (the goldens of ``tests/data_torch/sass``,
``cuobjdump -sass`` of the libraries as an H100 build wrote them).

Held equal to the reference: the synthetic classifier self-test, the labels
and margins ``classify_points`` gives the same points and profile numbers,
``bounds`` and ``fit_issue_rate``.  On the port alone: the SASS reader
(loops, their counter strides, the chase's dependent-load chain), the
emulator's counts of a launch (the chase walks exactly its tile, a copy
moves exactly its buffer, predicated tails included), the torch trace on
meta tensors, ``run_istream`` and the ``istream`` command on the CPU, and
``membench.rw_launch_plan`` against ``csrc/rw.cu``'s constants."""
import dataclasses
import json
import re
from pathlib import Path

import pytest

from repro.bench.result import BenchPoint as RefPoint
from repro.bench.result import BenchResult as RefResult
from repro.istream import analyze as ref_analyze
from repro.istream import classify as ref_classify
from repro_torch.bench import BenchSpec, Runner, cli
from repro_torch.bench.result import BenchPoint, BenchResult
from repro_torch.istream import analyze, classify
from repro_torch.istream.emulate import emulator_for, pack_params
from repro_torch.istream.extract import (decode, kernel_loops,
                                         loads_in_loops, parse_sass,
                                         prune_sass, sass_ops)
from repro_torch.kernels.membench import membench as mb

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "data_torch" / "sass"
H100 = (132, 50 * 2**20)
CHASE = "_ZN2mb12chase_kernelEPKiPfiiii"


@pytest.fixture(scope="module")
def sass():
    return {p.stem: parse_sass(p.read_text()) for p in GOLDENS.glob("*.sass")}


# ---------------------------------------------------------------------------
# classification: the reference's rule
# ---------------------------------------------------------------------------

def test_synthetic_check_labels_equal_the_reference():
    ours, theirs = classify.synthetic_check(), ref_classify.synthetic_check()
    assert ours["ok"] and theirs["ok"]
    assert ours["labels"] == theirs["labels"]
    assert ours["census"] == theirs["census"]
    assert ours["issue_rate"] == pytest.approx(theirs["issue_rate"],
                                               rel=1e-12)


POINTS = [(32768, "fma", 8 * 32768, 1e-3, 0.26, 8e3, 8e3, 5e6),
          (32768, "load_sum", 8 * 32768, 6.55e-6, 40.0, 8e3, 0.0, 8e3),
          (1 << 20, "copy", 8 << 20, 2e-4, 41.9, 2.6e5, 2.6e5, 1e3),
          (1 << 28, "copy", 8 << 28, 1e-1, 21.5, 6e7, 6e7, 1e3),
          (1 << 16, "triad", 24 << 16, 3e-5, 52.4, 3.2e4, 1.6e4, 3.2e4)]


def _both(backend_ours, backend_ref):
    out = []
    for point_cls, result_cls, prof_cls, backend in (
            (BenchPoint, BenchResult, analyze.InstructionProfile,
             backend_ours),
            (RefPoint, RefResult, ref_analyze.InstructionProfile,
             backend_ref)):
        points, profiles = [], {}
        for nbytes, mix, bpc, mean_s, gbps, loads, stores, arith in POINTS:
            points.append(point_cls(
                nbytes=nbytes, mix=mix, dtype="float32", backend=backend,
                passes=8, streams=1, block_rows=None, reps=3,
                bytes_per_call=bpc, flops_per_call=0.0, mean_s=mean_s,
                std_s=0.0, min_s=mean_s, gbps=gbps, gflops=0.0))
            if mix != "load_sum":
                profiles[(backend, mix, 1, 1, nbytes)] = prof_cls(
                    mix=mix, backend=backend, shape=(nbytes // 512, 128),
                    dtype="float32", nbytes=nbytes, unroll=1, interleave=1,
                    per_iter={"loads": loads, "stores": stores,
                              "arith": arith, "move": 0.0},
                    critical_path=4.0, trips=8, passes=8, loop="loop")
        out.append((result_cls(points=points), profiles))
    return out


@pytest.mark.parametrize("rate", [None, 3e9, 4e11])
def test_classify_points_labels_equal_the_reference(rate):
    (ours, op), (theirs, tp) = _both("torch", "xla")
    a = classify.classify_points(ours, op, issue_rate=rate)
    b = ref_classify.classify_points(theirs, tp, issue_rate=rate)
    for p, q in zip(a.points, b.points):
        assert (p.istream is None) == (q.istream is None)
        if p.istream is None:
            continue
        assert p.istream["label"] == q.istream["label"]
        assert p.istream["traffic"] == q.istream["traffic"]
        for key in ("margin", "issue_time_s", "mem_time_s"):
            assert p.istream[key] == pytest.approx(q.istream[key], rel=1e-12)
    assert a.meta["istream"]["labels"] == b.meta["istream"]["labels"]
    assert a.meta["istream"]["issue_rate_elems_per_s"] == pytest.approx(
        b.meta["istream"]["issue_rate_elems_per_s"], rel=1e-12)
    assert "| label |" in classify.render_fig6(a)


def test_issue_rates_are_fitted_per_backend():
    (ours, op), _ = _both("cuda", "pallas")
    (torch_res, tp), _ = _both("torch", "xla")
    merged = BenchResult(points=ours.points + torch_res.points)
    fast = {k: dataclasses.replace(v, per_iter=dict(v.per_iter, issue=1e3))
            for k, v in op.items()}
    out = classify.classify_points(merged, {**fast, **tp})
    rates = out.meta["istream"]["issue_rates"]
    assert set(rates) == {"cuda", "torch"} and rates["cuda"] != rates["torch"]
    assert out.meta["istream"]["issue_rate_elems_per_s"] is None


def test_bounds_and_fit_issue_rate_equal_the_reference():
    (ours, op), (theirs, tp) = _both("torch", "xla")
    for key in op:
        ref_key = ("xla",) + key[1:]
        a = analyze.bounds(op[key], issue_width=4.0)
        b = ref_analyze.bounds(tp[ref_key], issue_width=4.0)
        assert a["bound"] == b["bound"]
        assert a["throughput_bound"] == pytest.approx(b["throughput_bound"])
    pairs = [(p, op.get(analyze.point_join_key(p))) for p in ours.points]
    ref_pairs = [(p, tp.get(ref_analyze.point_join_key(p)))
                 for p in theirs.points]
    assert analyze.fit_issue_rate(pairs) == pytest.approx(
        ref_analyze.fit_issue_rate(ref_pairs), rel=1e-12)


# ---------------------------------------------------------------------------
# the SASS reader
# ---------------------------------------------------------------------------

def test_sass_reader_finds_the_chase_loops_and_chain(sass):
    lines = sass["chase.cu"][CHASE]
    ops = sass_ops(lines)
    assert ops[0][0] == 0 and all(op.isupper() for _, op, _ in ops)
    assert loads_in_loops(ops) >= 16
    loops = kernel_loops(lines)
    outer = [lp for lp in loops if lp.parent is None]
    inner = [lp for lp in loops if lp.parent is not None]
    assert len(outer) == 1 and outer[0].stride == 1     # the tile walk
    # nvcc unrolled the dependent walk: a 16-step trip and a 4-step one,
    # each load's address from the one before (one level a step)
    assert sorted(lp.stride for lp in inner) == [4, 16]
    for lp in inner:
        assert lp.load_chain == lp.stride
        assert lp.per_trip["loads"] == 4 * lp.stride


def test_prune_sass_round_trips(sass):
    text = (GOLDENS / "chase.cu.sass").read_text()
    assert parse_sass(prune_sass(text, {CHASE})) == \
        {CHASE: sass["chase.cu"][CHASE]}
    assert decode(sass["chase.cu"][CHASE])[0].addr == 0


# ---------------------------------------------------------------------------
# the emulator: counts of one launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tiles,tile_elems,streams",
                         [(1, 8192, 1), (4, 1027, 2), (3, 100, 1)])
def test_emulated_chase_walks_exactly_its_tiles(sass, n_tiles, tile_elems,
                                                streams):
    emu = emulator_for(CHASE, sass["chase.cu"][CHASE])
    for accumulate in (0, 1):
        c = emu.run(1, 1, pack_params([("ptr", 1 << 40), ("ptr", 2 << 40),
                                       ("i32", n_tiles),
                                       ("i32", tile_elems),
                                       ("i32", streams),
                                       ("i32", accumulate)]))
        assert c.load_bytes == 4 * (n_tiles * tile_elems + accumulate)
        assert c.store_bytes == 4
        assert c.load_chain == tile_elems


@pytest.mark.parametrize("dtype,rows", [("float32", 64), ("bfloat16", 8),
                                        ("bfloat16", 24)])
@pytest.mark.parametrize("passes", [1, 3])
def test_emulated_copy_moves_exactly_its_buffer(sass, dtype, rows, passes):
    """bfloat16 at 8 and 24 rows ends in a partial block (128 of a block's
    256 vectors): the predicated tail moves what it must, not a lane more."""
    size = 4 if dtype == "float32" else 2
    rec = mb.launch_record("copy", dtype, (rows, 128), {}, passes, *H100)
    counts = analyze.sass_counts(rec, sass, size)
    n = rows * 128
    assert counts["loads"] == counts["stores"] == passes * n
    assert counts["arith"] == 0 and counts["issue"] > 0


def test_rw_launch_plan_is_rw_cu_s():
    text = (mb.CSRC / "rw.cu").read_text()
    vecs = re.search(r"kRwVecs\[kMaxStreams \+ 1\] = \{([^}]*)\}", text)
    assert tuple(int(v) for v in vecs.group(1).split(",")) == mb.RW_VECS
    assert int(re.search(r"kRwCtas = (\d+)", text).group(1)) == mb.RW_CTAS
    for n_tiles, sms in ((1, 132), (16, 132), (10_000, 132), (7, 2)):
        plan = mb.rw_launch_plan(n_tiles, 128, 4, 1, 2, sms)
        assert plan["grid"] == min(n_tiles, mb.CTAS_PER_SM * sms)
        assert plan["units"] == 128 * 128 * 4 // 16 and plan["vecs"] == 2


# ---------------------------------------------------------------------------
# the torch side and run_istream
# ---------------------------------------------------------------------------

def test_torch_trace_runs_on_meta_and_is_linear():
    spec = BenchSpec(mixes=("triad",), sizes=(32768,), backend="torch",
                     passes=4, reps=2, warmup=0)
    ops = analyze.torch_trace(spec, "triad", (64, 128), "float32", 4)
    assert ops and all(isinstance(o[0], str) for o in ops)
    assert analyze.parse_trace(analyze.format_trace(ops)) == ops
    cache = analyze.ProfileCache()
    prof = analyze.analyze_case(spec, "triad", (64, 128), "float32", 4,
                                cache=cache)
    assert prof.per_iter["linear"] and prof.trips == 4 and prof.loop == "eager"
    n = 64 * 128
    assert prof.per_iter["stores"] == pytest.approx(4 * n, abs=8)
    again = analyze.analyze_case(spec, "triad", (64, 128), "float32", 8,
                                 cache=cache)
    assert cache.hits == 1 and again.passes == 8 and again.trips == 8


def test_the_chase_walk_is_its_critical_path():
    spec = BenchSpec(mixes=("latency_chase",), sizes=(32768,),
                     backend="torch", passes=4, reps=2, warmup=0)
    prof = analyze.analyze_case(spec, "latency_chase", (64, 128), "float32", 4)
    assert prof.critical_path == 64 * 128
    assert prof.per_iter["loads"] == pytest.approx(64 * 128, abs=4)


def test_run_istream_on_the_cpu_both_backends(sass):
    report = classify.run_istream(
        backends=("torch", "cuda"), mixes=("copy",), sizes=(1 << 16,),
        unrolls=(1, 2), interleaves=(1,), reps=1,
        runner=Runner(device="cpu"), sass=sass, machine=H100)
    pts = report.result.points
    assert len(pts) == 4 and all(p.istream for p in pts)
    assert {p.istream["traffic"] for p in pts} == {"audited"}
    assert set(report.result.meta["istream"]["issue_rates"]) == \
        {"torch", "cuda"}
    for key, prof in report.profiles.items():
        assert prof.per_iter["loads"] / prof.unroll == pytest.approx(
            (1 << 16) / 4, abs=8), key
    assert "warp instructions/s" in report.table


def test_cli_istream_smoke_torch(tmp_path, capsys):
    out = tmp_path / "i.json"
    assert cli.main(["istream", "--smoke", "--backend", "torch", "--device",
                     "cpu", "--sizes", "16K", "--reps", "1", "--out",
                     str(out), "--no-ledger"]) == 0
    text = capsys.readouterr().out
    assert "# synthetic check:" in text and "| backend | mix |" in text
    doc = json.loads(out.read_text())
    assert len(doc["points"]) == 8
    assert all(p["istream"]["label"] in ("bandwidth-bound", "issue-bound")
               for p in doc["points"])


def test_cli_istream_cuda_needs_the_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuobjdump"):
        cli.main(["istream", "--smoke", "--backend", "cuda", "--device",
                  "cpu", "--sizes", "16K", "--no-ledger"])
