"""The slice as a whole: one spec through the reference's Runner and the
port's (``pallas`` <-> ``cuda``, ``xla`` <-> ``torch``), spec / result JSON
crossing both ways, the compiled-case cache, validation wording, the CLI and
the explicit device.  Everything runs with ``device="cpu"`` at <= 128 KiB.

What is compared exactly: ``nbytes``, ``passes``, ``bytes_per_call`` and
``flops_per_call`` per point (they come from the shared registry formulas and
the same pass-picking rule, so they are equal, not close).  Times are never
compared: both sides run on this host's CPU and neither is the card's."""
import json
from pathlib import Path

import pytest
import torch

from repro.bench import BenchResult as RefResult
from repro.bench import BenchSpec as RefSpec
from repro.bench import BenchSpecError as RefSpecError
from repro.bench import Runner as RefRunner
from repro_torch import convert
from repro_torch.bench import (BenchResult, BenchSpec, BenchSpecError, Runner,
                               quick_spec)
from repro_torch.bench import cli
from repro_torch.bench.result import SCHEMA_VERSION, BenchPoint
from repro_torch.bench.runner import pick_passes
from repro_torch.core import timing

DATA = Path(__file__).parent / "data"
TINY = dict(sizes=(16 * 2**10, 64 * 2**10), reps=2, warmup=1,
            target_bytes=2e5)
ACCOUNTING = ("nbytes", "nbytes_requested", "mix", "dtype", "passes",
              "bytes_per_call", "flops_per_call", "streams", "block_rows",
              "unroll", "interleave", "reps", "devices", "load")


def _both(ref_backend: str, **kw):
    """The same spec through both Runners -> (reference points, port points)."""
    ref = RefRunner().run(RefSpec(backend=ref_backend, **kw))
    port_spec = BenchSpec.from_dict(convert.spec_from_reference(
        RefSpec(backend=ref_backend, **kw).to_dict()))
    port = Runner(device="cpu").run(port_spec)
    return ref, port


# ---------------------------------------------------------------------------
# one spec, two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref_backend,kw", [
    ("pallas", dict(mixes=("load_only", "load_sum", "fma_8", "mxu", "copy",
                           "triad"))),
    ("pallas", dict(mixes=("load_sum", "copy"), dtype="bfloat16",
                    block_rows=16, streams=2, unroll=2)),
    ("pallas", dict(mixes=("load_sum", "copy"), interleave=2, passes=4,
                    unroll=4)),
    ("xla", dict(mixes=("load_sum", "fma_8", "mxu", "copy", "triad"))),
    ("xla", dict(mixes=("load_sum",), streams=4, unroll=2)),
    ("xla", dict(mixes=("load_sum", "copy"), interleave=4,
                 dtype="bfloat16")),
])
def test_same_spec_same_accounting(ref_backend, kw):
    ref, port = _both(ref_backend, **{**TINY, **kw})
    assert len(port.points) == len(ref.points) == \
        len(kw["mixes"]) * len(TINY["sizes"])
    want = convert.BACKEND_FROM_REFERENCE[ref_backend]
    for p, q in zip(port.points, ref.points):
        assert p.backend == want and q.backend == ref_backend
        for f in ACCOUNTING:
            assert getattr(p, f) == getattr(q, f), (f, p.mix, p.nbytes)
        assert p.mean_s > 0 and p.gbps > 0 and len(p.rep_times_s) == p.reps
    assert port.schema_version == ref.schema_version == SCHEMA_VERSION == 6
    assert port.machine["device_platform"] == "cpu"
    assert port.machine["torch"] == torch.__version__
    # the keys the run ledger reads are there on both sides
    for key in ("hostname", "arch", "device_platform", "device_kind",
                "device_count", "process_count"):
        assert key in port.machine and key in ref.machine


def test_pick_passes_is_the_reference_rule():
    from repro.bench.runner import pick_passes as ref_pick
    for nbytes, target in ((1024, 1e6), (10**9, 1e6), (2**21, 2e8),
                           (2**31, 2e8), (3, 1.0)):
        assert pick_passes(nbytes, target) == ref_pick(nbytes, target)
    # auto-picked passes round UP to whole unrolled bodies on both sides
    kw = dict(mixes=("load_sum",), sizes=(16 * 2**10,), reps=1, warmup=0,
              target_bytes=16 * 2**10 * 5, unroll=4)
    (p,) = Runner(device="cpu").run(BenchSpec(backend="cuda", **kw)).points
    (q,) = RefRunner().run(RefSpec(backend="pallas", **kw)).points
    assert p.passes == q.passes == 8


# ---------------------------------------------------------------------------
# spec and result JSON cross both ways
# ---------------------------------------------------------------------------

def test_spec_json_crosses_both_ways(tmp_path):
    ref = RefSpec(mixes=("load_sum", "fma_4"), sizes=(2**14, 2**17),
                  backend="pallas", block_rows=32, streams=2, reps=3,
                  unroll=2, tags=("unit",))
    port = BenchSpec.from_dict(convert.spec_from_reference(ref.to_dict()))
    assert port.backend == "cuda"
    assert set(port.to_dict()) == set(ref.to_dict())
    d_ref, d_port = ref.to_dict(), port.to_dict()
    assert {k: v for k, v in d_port.items() if k != "backend"} == \
        {k: v for k, v in d_ref.items() if k != "backend"}
    back = RefSpec.from_dict(convert.spec_to_reference(port.to_dict()))
    assert back == ref
    # through files too
    port.to_json(tmp_path / "s.json")
    again = BenchSpec.from_json(tmp_path / "s.json")
    assert again == port
    # defaults agree field by field (the default backend is each package's
    # plain one)
    a, b = RefSpec().to_dict(), BenchSpec().to_dict()
    assert a.pop("backend") == "xla" and b.pop("backend") == "torch"
    assert a == b


def test_result_json_crosses_both_ways(tmp_path):
    ref, port = _both("pallas", mixes=("load_sum", "copy"), **TINY)
    # port -> reference
    loaded = RefResult.from_dict(convert.result_to_reference(port.to_dict()))
    assert [p.backend for p in loaded.points] == ["pallas"] * 4
    assert loaded.spec["backend"] == "pallas"
    assert [(p.mix, p.nbytes, p.passes, p.mean_s) for p in loaded.points] == \
        [(p.mix, p.nbytes, p.passes, p.mean_s) for p in port.points]
    # reference -> port, through a file
    path = tmp_path / "ref.json"
    ref.to_json(path)
    mine = BenchResult.from_dict(
        convert.result_from_reference(json.loads(path.read_text())))
    assert [p.backend for p in mine.points] == ["cuda"] * 4
    assert mine.spec["backend"] == "cuda"
    assert BenchSpec.from_dict(mine.spec).backend == "cuda"
    assert mine.machine == ref.machine and mine.meta == ref.to_dict()["meta"]
    for p, q in zip(mine.points, ref.points):
        assert (p.nbytes, p.passes, p.bytes_per_call, p.gbps,
                p.rep_times_s) == (q.nbytes, q.passes, q.bytes_per_call,
                                   q.gbps, q.rep_times_s)
    # and a port result round-trips through its own JSON
    port.to_json(tmp_path / "port.json")
    assert BenchResult.from_json(tmp_path / "port.json").points == port.points


@pytest.mark.parametrize("ver", [1, 2, 3, 4, 5])
def test_golden_results_load_like_the_reference(ver):
    """The reference's golden result files (schema v1..v5) load in the port
    with the same defaults for the fields they predate."""
    doc = json.loads((DATA / f"result_v{ver}.json").read_text())
    ref = RefResult.from_dict(doc)
    mine = BenchResult.from_dict(convert.result_from_reference(doc))
    assert mine.schema_version == ref.schema_version == ver
    assert len(mine.points) == len(ref.points) > 0
    for p, q in zip(mine.points, ref.points):
        dp, dq = dict(p.__dict__), dict(q.__dict__)
        assert dp.pop("backend") == \
            convert.BACKEND_FROM_REFERENCE.get(dq.pop("backend"), q.backend)
        assert dp == dq
    assert set(BenchPoint.__dataclass_fields__) == \
        set(type(ref.points[0]).__dataclass_fields__)
    with pytest.raises(ValueError, match="newer than supported"):
        BenchResult.from_dict({**doc, "schema_version": 99})


# ---------------------------------------------------------------------------
# the compiled-case cache and the obs counters
# ---------------------------------------------------------------------------

def test_compiled_case_cache_hits():
    one = dict(sizes=(16 * 2**10,), reps=2, warmup=1, passes=1)
    r = Runner(device="cpu")
    base = BenchSpec(mixes=("load_sum",), backend="cuda", **one)
    res = r.run(base)
    assert (r.cache_hits, r.cache_misses) == (0, 1)
    assert res.meta["obs"]["runner"] == {"cache_hits": 0, "cache_misses": 1}
    assert res.meta["obs"]["counters"]["buffers_built"] == 1
    assert res.meta["obs"]["counters"]["buffers_released"] == 1
    assert res.meta["obs"]["gauges"]["peak_working_set_bytes"] == 16 * 2**10
    r.run(base)
    assert (r.cache_hits, r.cache_misses) == (1, 1)
    r.run_many([base, base.replace(block_rows=8)])   # a knob: a new case
    assert (r.cache_hits, r.cache_misses) == (2, 2)
    r.run(base.replace(reps=3, value=2.5, tags=("x",)))  # measurement-only
    assert (r.cache_hits, r.cache_misses) == (3, 2)
    fresh = Runner(device="cpu")                   # cache is per-instance
    fresh.run(base)
    assert (fresh.cache_hits, fresh.cache_misses) == (0, 1)


def test_compare_reports_skipped_and_agrees():
    spec = BenchSpec(mixes=("load_only", "load_sum", "triad"), backend="cuda",
                     sizes=(32 * 2**10,), reps=2, warmup=1, passes=2)
    out = Runner(device="cpu").compare(spec)
    assert sorted(out) == ["cuda", "torch"]
    assert [p.mix for p in out["torch"].points] == ["load_sum", "triad"]
    skipped = out["cuda"].meta["skipped"]
    assert [m for m, _ in skipped["torch"]] == ["load_only"]
    assert "not supported by backend 'torch'" in skipped["torch"][0][1]
    by = {p.mix: p for p in out["cuda"].points}
    for p in out["torch"].points:
        assert (p.bytes_per_call, p.flops_per_call, p.passes) == \
            (by[p.mix].bytes_per_call, by[p.mix].flops_per_call,
             by[p.mix].passes)


# ---------------------------------------------------------------------------
# validation: the reference's rules, in the reference's words
# ---------------------------------------------------------------------------

def _names(msg: str) -> str:
    """A reference error message with its backend names mapped to the
    port's."""
    return (msg.replace("'xla'", "'torch'").replace("'pallas'", "'cuda'")
            .replace("('xla', 'pallas')", "('torch', 'cuda')")
            .replace("('pallas',)", "('cuda',)"))


@pytest.mark.parametrize("kw", [
    dict(mixes=("nope",)),
    dict(mixes=()),
    dict(mixes=("load_only",)),            # cuda-only mix on the plain backend
    dict(sizes=(0,)),
    dict(sizes=()),
    dict(streams=0),
    dict(devices=0),
    dict(devices=2),
    dict(devices=2, backend="pallas"),
    dict(reps=0),
    dict(warmup=-1),
    dict(passes=0),
    dict(passes=3, unroll=2),
    dict(unroll=0),
    dict(interleave=0),
    dict(load=-1),
    dict(load=1),                           # load needs a chase mix
    dict(target_bytes=0),
])
def test_spec_rejects_in_the_reference_words(kw):
    with pytest.raises(RefSpecError) as ref:
        RefSpec(**kw)
    mine = dict(kw)
    if "backend" in mine:
        mine["backend"] = convert.BACKEND_FROM_REFERENCE[mine["backend"]]
    with pytest.raises(BenchSpecError) as port:
        BenchSpec(**mine)
    assert str(port.value) == _names(str(ref.value))


def test_spec_rejects_what_the_port_does_not_run_yet():
    for mix in ("rw_2to1", "latency_chase"):
        for backend in ("torch", "cuda"):
            with pytest.raises(BenchSpecError,
                               match="is not supported by backend"):
                BenchSpec(mixes=(mix,), backend=backend)
    for backend in ("xla", "pallas", "sharded", "distributed"):
        with pytest.raises(BenchSpecError, match="unknown backend"):
            BenchSpec(backend=backend)
    with pytest.raises(BenchSpecError, match="multiple of 8"):
        BenchSpec(block_rows=12)
    with pytest.raises(BenchSpecError, match="bad dtype"):
        BenchSpec(dtype="floatzz")
    with pytest.raises(BenchSpecError, match="unknown spec fields"):
        BenchSpec.from_dict({"mixes": ["load_sum"], "device": "cpu"})
    with pytest.raises(BenchSpecError, match="newer than supported"):
        BenchSpec.from_dict({"spec_version": 99})
    assert BenchSpec(mixes=("load_only",), backend="cuda").mixes == \
        ("load_only",)


@pytest.mark.parametrize("kw,match", [
    (dict(mixes=("copy",), streams=2), "streams>1 only for load_sum"),
    (dict(mixes=("copy",), block_rows=8), "block_rows only for load_sum"),
    (dict(mixes=("fma_8",), interleave=2), "no interleaved variant"),
    (dict(mixes=("load_sum",), streams=2, block_rows=8),
     "mutually exclusive"),
    (dict(mixes=("load_sum",), backend="cuda", unroll=3, passes=3),
     "unroll 3 is not one of"),
    (dict(mixes=("load_sum",), backend="cuda", block_rows=48),
     "block_rows 48 does not divide"),
    (dict(mixes=("load_sum",), backend="cuda", block_rows=8, streams=3),
     "streams 3 does not divide"),
    (dict(mixes=("load_sum",), backend="cuda", dtype="int32"),
     "float32 or bfloat16"),
])
def test_backend_gates_fire_before_any_timing(kw, match):
    spec = BenchSpec(**{**dict(sizes=(16 * 2**10,), reps=1, warmup=0), **kw})
    with pytest.raises(BenchSpecError, match=match):
        Runner(device="cpu").run(spec)


# ---------------------------------------------------------------------------
# the explicit device
# ---------------------------------------------------------------------------

def test_default_device_without_cuda_raises_and_names_the_flag(capsys):
    assert not torch.cuda.is_available()     # these tests run on the CPU
    with pytest.raises(RuntimeError, match="--device cpu"):
        Runner()
    with pytest.raises(RuntimeError, match="--device cpu"):
        Runner(device="cuda")
    from repro_torch.core.buffers import working_set
    with pytest.raises(RuntimeError, match="--device cpu"):
        working_set(16 * 2**10)
    with pytest.raises(RuntimeError, match="--device cpu"):
        timing.time_fn(lambda: None, reps=1, warmup=0)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["run", "--quick", "--backend", "torch", "--no-ledger"])
    assert Runner(device="cpu").device == torch.device("cpu")
    assert Runner(device=torch.device("cpu")).device.type == "cpu"
    assert "device" not in BenchSpec().to_dict()


def test_time_fn_validation_and_shape():
    with pytest.raises(ValueError, match="reps must be >= 1"):
        timing.time_fn(lambda: None, reps=0, device="cpu")
    with pytest.raises(ValueError, match="warmup must be >= 0"):
        timing.time_fn(lambda: None, reps=1, warmup=-1, device="cpu")
    calls = []
    t = timing.time_fn(lambda: calls.append(1), reps=3, warmup=0,
                       bytes_per_call=8.0, flops_per_call=2.0, device="cpu")
    assert len(calls) == 3 and len(t.times_s) == 3
    assert t.gbps == pytest.approx(8.0 / t.mean_s / 1e9)
    assert t.samples(2) == tuple(t.times_s[-2:])
    assert len(t.cumulative_mean_s) == 3 and t.summary()["reps"] == 3
    from repro.core.timing import TimingResult as RefTiming
    assert set(timing.TimingResult.__dataclass_fields__) == \
        set(RefTiming.__dataclass_fields__)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_run_writes_and_refuses_overwrite(tmp_path, capsys):
    out = tmp_path / "r.json"
    argv = ["run", "--quick", "--backend", "cuda", "--device", "cpu",
            "--sizes", "16K,64K", "--out", str(out)]
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    assert "# saved 6 points (schema v6)" in text and "# ledger +=" in text
    res = BenchResult.from_json(out)
    assert [p.mix for p in res.points[:3]] == list(quick_spec().mixes)
    assert res.spec["backend"] == "cuda" and "device" not in res.spec
    before = out.read_text()
    assert cli.main(argv) == 2                     # refused, nothing measured
    assert "refusing to overwrite" in capsys.readouterr().err
    assert out.read_text() == before
    assert cli.main(argv + ["--force", "--no-ledger"]) == 0
    assert "# ledger +=" not in capsys.readouterr().out
    # the ledger record went where the environment pointed it
    import os
    from repro_torch.obs import ledger
    root = Path(os.environ[ledger.LEDGER_ENV])
    assert (root / "ledger.jsonl").exists()


def test_cli_spec_file_trace_and_stdout(tmp_path, capsys):
    spec = BenchSpec(mixes=("load_sum", "triad"), sizes=(16 * 2**10,),
                     backend="cuda", reps=2, warmup=1, passes=2, unroll=2)
    spec.to_json(tmp_path / "spec.json")
    tr = tmp_path / "trace.json"
    assert cli.main(["run", "--spec", str(tmp_path / "spec.json"), "--device",
                     "cpu", "--no-ledger", "--trace", str(tr)]) == 0
    cli.trace.configure(enabled=False)
    text = capsys.readouterr().out
    doc = json.loads(text[text.index("{"):])
    assert doc["schema_version"] == 6 and len(doc["points"]) == 2
    assert doc["machine"]["device_platform"] == "cpu"
    names = {e["name"] for e in json.loads(tr.read_text())["traceEvents"]}
    assert {"runner.run", "runner.plan", "runner.size", "buffers.build",
            "case.build", "timing.warmup", "timing.rep"} <= names


def test_cli_compare_and_list(tmp_path, capsys):
    rc = cli.main(["compare", "--device", "cpu", "--mixes",
                   "load_only,load_sum,copy", "--sizes", "16K", "--reps", "2",
                   "--out", str(tmp_path / "c.json")])
    text = capsys.readouterr().out
    assert rc == 0 and "accounting mismatch" not in text
    assert "# skipped torch/load_only" in text
    assert sorted(json.loads((tmp_path / "c.json").read_text())) == \
        ["cuda", "torch"]
    assert cli.main(["compare", "--device", "cpu", "--sizes", "16K", "--out",
                     str(tmp_path / "c.json")]) == 2
    capsys.readouterr()
    assert cli.main(["list-mixes"]) == 0
    text = capsys.readouterr().out
    for mix in ("load_only", "load_sum", "fma_8", "mxu", "copy", "triad",
                "rw_2to1", "latency_chase"):
        assert mix in text
    assert cli.main(["run", "--device", "cpu", "--mixes", "rw_2to1"]) == 2
    assert "not supported by backend" in capsys.readouterr().err
