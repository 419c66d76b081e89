"""The latency probe in the port against the reference: ``chase_perm`` bit
for bit, the chase wrapper on CPU tensors (its plain version) against the
reference's Pallas ``_chase_kernel`` in interpret mode, the ``torch`` oracles
``k_chase`` / ``k_chase_loaded`` against the reference's, the timed forms
(idle and loaded), the Runner's accounting on both backends, the case cache,
the knee fits and the ``latency`` command.  Sizes <= 128 KiB.

A walk over ``chase_perm`` always returns to index 0, so on it every chase
returns exactly 0.0 — which a kernel that walks nothing returns too.  The
comparisons are therefore repeated on ``_off_cycle`` buffers, on which 0
lies on a seeded cycle shorter than the tile: a walk of one tile's length
ends at a seeded index that any other step count (a skipped, repeated or
missing step, one load per tile) moves.  Chase values are sums of integers
below 2**24:
compared exactly.  Loaded composites add float32 generator sums in another
order than the reference: 1e-5 of the value (``SUM_RTOL``, positive terms)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import BenchPoint as RefPoint
from repro.bench import BenchResult as RefResult
from repro.bench import BenchSpec as RefSpec
from repro.bench import Runner as RefRunner
from repro.characterize import loaded as ref_loaded
from repro.core import instruction_mix as ref_im
from repro.core.buffers import working_set as ref_working_set
from repro.kernels.membench import ops as ref_ops
from repro_torch import convert
from repro_torch.bench import BenchPoint, BenchResult, BenchSpec, Runner, cli
from repro_torch.bench.mixes import GEN_SWEEPS_PER_PASS, get_mix
from repro_torch.bench.runner import CHASE_TARGET_STEPS, pick_passes
from repro_torch.characterize import fit_knee, fit_loaded
from repro_torch.core import instruction_mix as port_im
from repro_torch.kernels.membench import membench as mb
from repro_torch.kernels.membench import ops as port_ops
from repro_torch.kernels.membench.ref import ref_chase

SUM_RTOL = 1e-5
TILINGS = [(8, 1), (32, 2), (16, 4)]


def _off_cycle(shape, block_rows: int, seed: int) -> np.ndarray:
    """Per tile of m entries: 0 on a seeded cycle of seeded length c, m/2 <
    c <= 3m/4, and the other indices on a second cycle.  A walk of k steps
    from 0 ends k mod c entries along 0's cycle, so the tile's walk of m
    steps ends m - c (m/4 .. m/2) entries along it, and a walk of any k not
    congruent to m mod c (one load per tile, m - 1, m + 1, 2m - 1, ...)
    ends elsewhere."""
    rng = np.random.default_rng(seed)
    rows, lanes = shape
    m = block_rows * lanes
    flat = np.empty(rows * lanes, dtype=np.int32)
    for t in range(rows // block_rows):
        c = int(rng.integers(m // 2 + 1, 3 * m // 4 + 1))
        rest = rng.permutation(np.arange(1, m))
        seg = np.empty(m, dtype=np.int32)
        for cyc in (np.concatenate([[0], rest[:c - 1]]), rest[c - 1:]):
            seg[cyc] = np.roll(cyc, -1)
        flat[t * m:(t + 1) * m] = seg
    return flat.reshape(rows, lanes)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.tensor(a)


def _ramp(nbytes):
    """The non-cancelling generator buffer, float32, on both sides."""
    a = np.abs(np.asarray(ref_working_set(nbytes)))
    a = a * np.linspace(0.5, 1.5, a.shape[0], dtype=np.float32)[:, None]
    return _both(a.astype(np.float32))


# ---------------------------------------------------------------------------
# the permutation buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,parts", [
    ((8, 128), 1), ((16, 128), 1), ((16, 128), 2), ((16, 128), 16),
    ((64, 128), 8), ((256, 128), 2), ((256, 128), 32)])
def test_chase_perm_is_bit_identical_to_the_reference(shape, parts):
    ours = port_im.chase_perm(shape, parts)
    theirs = np.asarray(ref_im.chase_perm(shape, parts))
    assert ours.dtype == theirs.dtype == np.int32
    assert ours.shape == theirs.shape == shape
    assert np.array_equal(ours, theirs)
    assert ours is port_im.chase_perm(shape, parts)      # cached ...
    with pytest.raises(ValueError):                       # ... and read-only
        ours[0, 0] = 1


@pytest.mark.parametrize("block_rows", [8, 16])
def test_off_cycle_walk_end_moves_with_any_wrong_step_count(block_rows):
    """The power of the exact comparisons: on an ``_off_cycle`` tile the
    end of the m-step walk differs from 0 and from the end of every walk
    of a nearby or multiple step count."""
    m = block_rows * 128
    for tile in _off_cycle((4 * block_rows, 128), block_rows,
                           seed=block_rows).reshape(4, m):
        ends, j = {}, 0
        for k in range(2 * m + 1):
            ends[k] = j
            j = int(tile[j])
        assert ends[m] != 0
        for k in (0, 1, 2, m - 2, m - 1, m + 1, 2 * m - 1, 2 * m):
            assert ends[k] != ends[m], k


@pytest.mark.parametrize("parts", [1, 4])
def test_chase_perm_is_one_cycle_per_part(parts):
    flat = port_im.chase_perm((16, 128), parts).reshape(-1)
    m = flat.size // parts
    for s in range(parts):
        seg = flat[s * m:(s + 1) * m]
        assert seg.min() >= 0 and seg.max() < m
        j, seen = 0, 0
        for _ in range(m):
            j, seen = seg[j], seen + 1
            if j == 0:
                break
        assert seen == m
    with pytest.raises(ValueError, match="must divide"):
        port_im.chase_perm((16, 128), 3)


# ---------------------------------------------------------------------------
# the chase wrapper against the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_rows,streams", TILINGS)
def test_chase_wrapper_vs_reference_kernel(block_rows, streams):
    shape = (64, 128)
    kw = dict(block_rows=block_rows, streams=streams)
    ref_fn = ref_ops.make_kernel("latency_chase", interpret=True, **kw)
    port_fn = port_ops.make_kernel("latency_chase", **kw)
    full = port_im.chase_perm(shape, shape[0] // block_rows)
    pj, pt = _both(full)
    assert float(ref_fn(pj)) == float(port_fn(pt)) == 0.0
    pj, pt = _both(_off_cycle(shape, block_rows, seed=block_rows))
    got, want = port_fn(pt), float(ref_fn(pj))
    assert got.ndim == 0 and got.dtype == torch.float32
    assert float(got) == want != 0.0
    assert float(ref_chase(pt, block_rows)) == want


def test_chase_wrapper_checks():
    perm = torch.tensor(port_im.chase_perm((16, 128), 2))
    with pytest.raises(TypeError, match="int32"):
        mb.chase(perm.float(), block_rows=8)
    with pytest.raises(ValueError, match="shape"):
        mb.chase(perm.reshape(-1, 64), block_rows=8)
    with pytest.raises(ValueError, match="streams 3"):
        mb.chase(perm, block_rows=8, streams=3)
    with pytest.raises(ValueError, match="multiple of unroll"):
        mb.chase(perm, block_rows=8, passes=3, unroll=2)
    mb.check_chase_perm(perm, 8)
    whole = torch.tensor(port_im.chase_perm((16, 128), 1))   # one cycle
    with pytest.raises(ValueError, match="outside"):
        mb.check_chase_perm(whole, 8)
    bad = perm.clone()
    bad[3, 3] = 1024
    with pytest.raises(ValueError, match=r"outside \[0, 1024\)"):
        mb.check_chase_perm(bad, 8)
    # a clean result is remembered per buffer, until the buffer is written
    mb.check_chase_perm(perm, 8)
    perm[3, 3] = 1024
    with pytest.raises(ValueError, match="outside"):
        mb.check_chase_perm(perm, 8)
    mb.check_chase_perm(whole, 16)           # ... and per tile size
    with pytest.raises(ValueError, match="outside"):
        mb.check_chase_perm(whole, 8)
    # the plain walk visits every tile once per pass, in any stream order
    off = torch.tensor(_off_cycle((64, 128), 8, seed=5))
    one = float(mb.chase(off, block_rows=8))
    for streams in (1, 2, 4, 8):
        assert float(mb.chase(off, block_rows=8, streams=streams,
                              passes=3)) == 3 * one


# ---------------------------------------------------------------------------
# the torch oracles against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("passes,unroll", [(1, 1), (4, 1), (4, 2), (6, 3)])
def test_k_chase_matches_the_reference(passes, unroll):
    """Idle probe: the walk over the whole buffer, ``j`` carried across
    passes — 0.0 on chase_perm, the same integer sum on an off-cycle
    buffer (whose walk moves m - c entries further along 0's cycle every
    pass)."""
    for a in (port_im.chase_perm((16, 128)), _off_cycle((16, 128), 16, 1)):
        pj, pt = _both(a)
        want = float(ref_im.k_chase(pj, passes, unroll))
        got = port_im.k_chase(pt, passes, unroll)
        assert got.ndim == 0 and got.dtype == torch.float32
        assert float(got) == want
    assert want != 0.0


@pytest.mark.parametrize("load", [1, 2])
@pytest.mark.parametrize("passes,unroll", [(1, 1), (4, 2)])
def test_k_chase_loaded_matches_the_reference(passes, unroll, load):
    gj, gt = _ramp(16 * 1024)
    for a in (port_im.chase_perm((16, 128)), _off_cycle((16, 128), 16, 2)):
        pj, pt = _both(a)
        want = float(ref_im.k_chase_loaded(pj, gj, passes, unroll,
                                           load=load))
        got = float(port_im.k_chase_loaded(pt, gt, passes, unroll,
                                           load=load))
        assert abs(got - want) <= SUM_RTOL * abs(want), (got, want)
    expect = passes * load * GEN_SWEEPS_PER_PASS * float(
        gt.to(torch.float64).sum())
    idle = float(port_im.k_chase(pt, passes, unroll))
    assert abs(got - idle - expect) <= SUM_RTOL * expect


def test_run_mix_latency_chase_matches_the_reference():
    xj = ref_working_set(32 * 1024)
    xt = convert.tensor_from_reference(np.asarray(xj))
    assert float(ref_im.run_mix("latency_chase", xj, 3)) == \
        float(port_im.run_mix("latency_chase", xt, 3)) == 0.0
    with pytest.raises(KeyError, match="no interleaved"):
        port_im.run_mix("latency_chase", xt, 2, interleave=2)


# ---------------------------------------------------------------------------
# the timed forms (the cuda backend's case), idle and loaded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("load", [0, 1, 2])
@pytest.mark.parametrize("passes,unroll", [(2, 1), (4, 2)])
def test_timed_chase_returns_the_pallas_scalar(passes, unroll, load):
    shape, br = (32, 128), 8
    kw = dict(block_rows=br, streams=2, passes=passes, unroll=unroll,
              load=load)
    ref_fn = ref_ops.make_timed_kernel("latency_chase", interpret=True, **kw)
    port_fn = port_ops.make_timed_kernel("latency_chase", **kw)
    gj, gt = _ramp(16 * 1024)
    for a in (port_im.chase_perm(shape, shape[0] // br),
              _off_cycle(shape, br, seed=3)):
        pj, pt = _both(a)
        if load:
            want = float(ref_fn(pj, gj))
            got = float(port_fn(pt, gt))
            assert abs(got - want) <= SUM_RTOL * abs(want), (got, want)
        else:
            assert float(port_fn(pt)) == float(ref_fn(pj))
    probe = float(mb.chase(pt, block_rows=br, streams=2))
    assert probe != 0.0
    if load:
        gen = passes * load * GEN_SWEEPS_PER_PASS * float(
            gt.to(torch.float64).sum())
        assert abs(got - passes * probe - gen) <= SUM_RTOL * gen


def test_loaded_case_counts_no_launch_on_the_cpu():
    mb.reset_launch_counts()
    perm = torch.tensor(port_im.chase_perm((16, 128), 2))
    gen = torch.ones(16, 128)
    port_ops.make_timed_kernel("latency_chase", block_rows=8, passes=2,
                               load=1)(perm, gen)
    assert mb.launch_counts == {k: 0 for k in mb.KERNEL_NAMES}


# ---------------------------------------------------------------------------
# the Runner: accounting parity, latency axes, the case cache
# ---------------------------------------------------------------------------

def _run_both(ref_backend, loads, **kw):
    specs = [RefSpec(mixes=("latency_chase",), backend=ref_backend,
                     load=load, **{**dict(sizes=(16 * 2**10,), reps=2,
                                          warmup=1), **kw})
             for load in loads]
    ref = RefRunner().run_many(specs)
    port = Runner(device="cpu").run_many([
        BenchSpec.from_dict(convert.spec_from_reference(s.to_dict()))
        for s in specs])
    return ref, port


@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
def test_runner_latency_points_match_the_reference(ref_backend):
    ref, port = _run_both(ref_backend, (0, 1, 2), passes=4)
    assert len(port.points) == len(ref.points) == 3
    want = convert.BACKEND_FROM_REFERENCE[ref_backend]
    for p, q in zip(port.points, ref.points):
        assert p.backend == want
        assert (p.load, p.passes, p.bytes_per_call, p.flops_per_call,
                p.nbytes) == (q.load, q.passes, q.bytes_per_call,
                              q.flops_per_call, q.nbytes)
        assert p.latency_ns > 0 and (p.gen_gbps > 0) == (p.load > 0)
        assert p.gen_gbps == 0.0 or p.load > 0
    idle = port.points[0]
    for p in port.points:
        assert p.bytes_per_call == idle.bytes_per_call * (
            1 + p.load * GEN_SWEEPS_PER_PASS)
        assert (p.flops_per_call > 0) == (p.load > 0)


def test_runner_chase_passes_are_picked_by_steps():
    ref, port = _run_both("xla", (0,), sizes=(32 * 2**10, 128 * 2**10))
    assert [p.passes for p in port.points] == \
        [p.passes for p in ref.points] == \
        [CHASE_TARGET_STEPS // 8192, CHASE_TARGET_STEPS // 32768]
    chase = get_mix("latency_chase")
    from repro.bench.runner import pick_passes as ref_pick
    for n in (1024, 8192, 2**21):
        for devices in (1, 4):
            assert pick_passes(n * 4, mix=chase, n_elems=n,
                               devices=devices) == \
                ref_pick(n * 4, mix=chase, n_elems=n, devices=devices)


def test_cache_never_aliases_load():
    from repro_torch.bench.backends import _NON_CASE_FIELDS, case_knobs
    assert "load" not in _NON_CASE_FIELDS
    tiny = dict(sizes=(16 * 2**10,), reps=1, warmup=0, passes=2)
    assert "load" in {n for n, _ in case_knobs(BenchSpec(**tiny))}
    for backend in ("torch", "cuda"):
        r = Runner(device="cpu")
        base = BenchSpec(mixes=("latency_chase",), backend=backend, **tiny)
        r.run(base)
        misses = r.cache_misses
        r.run(base.replace(load=1))
        assert r.cache_misses == misses + 1, "load=1 aliased the idle case"
        r.run(base.replace(load=1))
        assert r.cache_misses == misses + 1


def test_loaded_latency_is_not_below_idle_on_the_torch_backend():
    """The time-shared composite pays every probe pass's walk plus
    load * 16 generator sweeps, so latency per step cannot beat idle."""
    _, port = _run_both("xla", (0, 4), passes=4, reps=3)
    by_load = {p.load: p for p in port.points}
    assert by_load[4].latency_ns >= by_load[0].latency_ns


# ---------------------------------------------------------------------------
# knee fits
# ---------------------------------------------------------------------------

def _points(cls, backend, rows, nbytes=16 * 2**10):
    return [cls(nbytes=nbytes, mix="latency_chase", dtype="float32",
                backend=backend, passes=8, streams=1, block_rows=None,
                reps=3, bytes_per_call=1.0, flops_per_call=0.0, mean_s=1e-3,
                std_s=0.0, min_s=1e-3, gbps=1.0, gflops=0.0, load=load,
                latency_ns=lat, gen_gbps=gen)
            for load, lat, gen in rows]


@pytest.mark.parametrize("rows", [
    [(0, 40.0, 0.0), (1, 45.0, 2.0), (2, 55.0, 3.5), (4, 120.0, 4.0)],
    [(0, 40.0, 0.0), (2, 80.0, 3.0)],
    [(0, 10.0, 0.0), (0, 12.0, 0.0), (1, 11.0, 1.0), (1, 30.0, 1.5)],
    [(0, 40.0, 0.0)],
])
def test_fit_knee_equals_the_reference(rows):
    assert fit_knee(_points(BenchPoint, "torch", rows), factor=1.5) == \
        ref_loaded.fit_knee(_points(RefPoint, "xla", rows), factor=1.5)


def test_fit_loaded_equals_the_reference():
    small = [(0, 40.0, 0.0), (2, 80.0, 3.0)]
    big = [(0, 90.0, 0.0), (2, 100.0, 5.0)]
    ours = BenchResult(points=_points(BenchPoint, "torch", small)
                       + _points(BenchPoint, "torch", big, 8 * 2**20))
    theirs = RefResult(points=_points(RefPoint, "xla", small)
                       + _points(RefPoint, "xla", big, 8 * 2**20))
    for levels in (None, (("L1", 256 * 2**10), ("DRAM", None)),
                   (("L2", 50 * 2**20),)):
        assert fit_loaded(ours, levels=levels) == \
            ref_loaded.fit_loaded(theirs, levels=levels)
    assert fit_loaded(BenchResult(points=[])) is None


# ---------------------------------------------------------------------------
# the latency command
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_cli_latency_smoke(backend, tmp_path, capsys):
    out = tmp_path / "lat.json"
    argv = ["latency", "--smoke", "--device", "cpu", "--backend", backend,
            "--out", str(out), "--no-ledger"]
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    assert "latency ns" in text and "# all: idle" in text
    assert "# saved 3 points (schema v6)" in text
    doc = json.loads(out.read_text())
    ref = RefResult.from_dict(convert.result_to_reference(doc))
    want = convert.BACKEND_TO_REFERENCE[backend]
    assert [p.load for p in ref.points] == [0, 1, 2]
    assert {p.backend for p in ref.points} == {want}
    assert all(p.nbytes == 128 * 2**10 and p.latency_ns > 0
               for p in ref.points)
    assert ref.meta["loaded_latency"]["loads"] == [0, 1, 2]
    assert ref.meta["loaded_latency"]["fit"]["levels"]["all"]["loads"] == \
        [0, 1, 2]
    # the reference's inline chase audit: torch live (meta tensors), cuda
    # over the committed SASS goldens here (no card), each naming its source
    lines = [ln for ln in text.splitlines() if ln.startswith("# audit ")]
    assert lines == [f"# audit {b}/latency_chase{k} ({s}): ok"
                     for b, s in (("torch", "live"), ("cuda", "goldens"))
                     for k in ("", "[load=1]")]
    audits = doc["meta"]["audit"]
    assert [(a["backend"], a["knobs"]["load"], a["source"]) for a in audits] \
        == [("torch", 0, "live"), ("torch", 1, "live"),
            ("cuda", 0, "goldens"), ("cuda", 1, "goldens")]
    assert all(a["ok"] and not a["waived"] for a in audits)
    assert cli.main(argv) == 2                  # refuses to overwrite
    assert "refusing to overwrite" in capsys.readouterr().err


def test_cli_latency_smoke_exits_2_on_a_corrupted_chase(monkeypatch, capsys):
    import dataclasses
    from repro_torch.bench import mixes
    bad = dataclasses.replace(get_mix("latency_chase"), reads_per_elem=2.0)
    monkeypatch.setitem(mixes._REGISTRY, "latency_chase", bad)
    assert cli.main(["latency", "--smoke", "--device", "cpu", "--backend",
                     "torch", "--loads", "0", "--reps", "1",
                     "--no-ledger"]) == 2
    captured = capsys.readouterr()
    assert "latency_chase accounting must be checked clean" in captured.err
    assert captured.out.count(": FAIL") == 4


def test_cli_latency_flags_and_default_device(tmp_path, capsys):
    assert cli.main(["latency", "--device", "cpu", "--sizes", "16K,32K",
                     "--loads", "0,2", "--reps", "2", "--no-ledger",
                     "--trace", str(tmp_path / "t.json"),
                     "--out", str(tmp_path / "d.json")]) == 0
    cli.trace.configure(enabled=False)
    text = capsys.readouterr().out
    rows = [line.split() for line in text.splitlines()
            if line and line.split()[0].isdigit()]
    assert [(int(r[0]), int(r[1])) for r in rows] == \
        [(16384, 0), (32768, 0), (16384, 2), (32768, 2)]
    # the default backend is the kernels' (cuda), as for ``run``
    doc = BenchResult.from_json(tmp_path / "d.json")
    assert {p.backend for p in doc.points} == {"cuda"}
    assert (tmp_path / "t.json").exists()
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["latency", "--smoke", "--no-ledger"])
