"""The rw_RtoW family in the port against the reference: the rw wrapper on CPU
tensors (where it takes its plain version) against the reference's Pallas
``_rw_kernel`` in interpret mode, the ``torch`` oracles ``k_rw`` /
``k_rw_istream`` against the reference's jnp oracles, the timed scalars of
both port backends against their reference counterparts, and the Runner's
accounting.  Buffers are made by the reference (``working_set``, or numpy
for the ramp input) and carried over bit for bit; sizes <= 64 KiB.

Tolerances.  The port rounds once per operation in the working dtype
(``v = v + 1.5*s``: the product, then the sum, after every read stream).
The reference's compiler may contract each ``v + 1.5*s`` into one fused
multiply-add, and for bfloat16 keep the running value in float32 between
the streams, so the two may differ by at most one rounding per fold step:
(R-1) ulp of ``|v|`` per element (rw_1to1: bit-exact).  Measured worst
over the wrapper cases below (both inputs, three tilings, interleave 1/2/4):
float32 1 ulp at R = 2 and 2 ulp at R = 3, 4, 8; bfloat16 0.
The timed scalars fold a few such elements: 1e-6 relative, plus (R-1) ulp
per folded element.  The CUDA kernel itself is held against the plain
version (tolerance 0) on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import BenchSpec as RefSpec
from repro.bench import Runner as RefRunner
from repro.bench.mixes import RW_RATIOS
from repro.core import instruction_mix as ref_im
from repro.core.buffers import working_set as ref_working_set
from repro.kernels.membench import ops as ref_ops
from repro_torch import convert
from repro_torch.bench import BenchSpec, Runner, get_backend, get_mix
from repro_torch.bench.mixes import mix_names, registry, rw_name
from repro_torch.core import instruction_mix as port_im
from repro_torch.kernels.membench import membench as mb
from repro_torch.kernels.membench import ops as port_ops
from repro_torch.kernels.membench.ref import reference as port_reference

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
RATIOS = list(RW_RATIOS) + [(1, 8), (8, 1), (8, 8)]
TILINGS = [(8, 1), (32, 2), (16, 4)]
#: ulp(v) of bfloat16 is 2**16 times float32's (7 fraction bits, not 23)
ULP_SCALE = {"float32": 1.0, "bfloat16": 2.0**16}


def _pair(nbytes, dtype, ramp=False):
    """(reference array, port tensor) of the same bits: the working set, or
    the non-cancelling ramp input (|x| scaled row by row 0.5..1.5)."""
    xj = ref_working_set(nbytes, dtype=JNP[dtype])
    if ramp:
        a = np.abs(np.asarray(xj.astype(jnp.float32)))
        a = a * np.linspace(0.5, 1.5, a.shape[0], dtype=np.float32)[:, None]
        xj = jnp.asarray(a).astype(JNP[dtype])
    return xj, convert.tensor_from_reference(np.asarray(xj))


def _streams(xj, reads):
    """The reference's R-1 extra read streams and the same bits as tensors
    (the port's own rw_streams must give those bits too)."""
    ysj = ref_im.rw_streams(xj, reads)[1:]
    return ysj, [convert.tensor_from_reference(np.asarray(y)) for y in ysj]


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _ulps(got, want, dtype):
    """Elementwise |got - want| in ulps of the larger magnitude."""
    g, w = _np32(got), _np32(want)
    ulp = np.spacing(np.maximum(np.abs(g), np.abs(w))) * ULP_SCALE[dtype]
    return np.abs(g - w) / ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_rows,streams", TILINGS)
@pytest.mark.parametrize("reads,writes", RATIOS)
def test_rw_wrapper_vs_reference_kernel(reads, writes, block_rows, streams,
                                        dtype):
    """Every output of the port's rw equals the reference's Pallas kernel to
    (R-1) ulp, on the working set and on the ramp input, for interleave 1, 2
    and 4."""
    mix = rw_name(reads, writes)
    for ramp in (False, True):
        xj, xt = _pair(32 * 1024, dtype, ramp)
        ysj, yst = _streams(xj, reads)
        for interleave in (1, 2, 4):
            want = ref_ops.make_kernel(mix, block_rows=block_rows,
                                       streams=streams, interpret=True,
                                       interleave=interleave)(xj, *ysj)
            got = port_ops.make_kernel(mix, block_rows=block_rows,
                                       streams=streams,
                                       interleave=interleave)(xt, *yst)
            assert isinstance(got, tuple) and len(got) == len(want) == writes
            for g, w in zip(got, want):
                assert g.dtype == xt.dtype and g.shape == xt.shape
                assert _ulps(g, w, dtype).max() <= reads - 1, \
                    (mix, ramp, interleave)
            # the per-call reference of the port, bit for bit
            assert torch.equal(got[0], port_reference(mix, xt, ys=yst))


def test_rw_streams_match_the_reference():
    for dtype in ("float32", "bfloat16"):
        xj, xt = _pair(16 * 1024, dtype)
        for reads in range(1, 9):
            ours = port_im.rw_streams(xt, reads)
            assert len(ours) == reads and ours[0] is xt
            _, theirs = _streams(xj, reads)
            for a, b in zip(ours[1:], theirs):
                assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rw_1to1_is_copy_and_2to1_is_triad(dtype):
    _, xt = _pair(32 * 1024, dtype, ramp=True)
    (one,) = mb.rw(xt, reads=1, writes=1, block_rows=16)
    assert torch.equal(one, mb.copy(xt, block_rows=16))
    (two,) = mb.rw(xt, xt * 0.5, reads=2, writes=1, block_rows=16)
    assert torch.equal(two, mb.triad(xt, xt * 0.5, block_rows=16))


def test_rw_outputs_and_errors():
    _, xt = _pair(16 * 1024, "float32", ramp=True)
    ys = port_im.rw_streams(xt, 3)[1:]
    outs = (torch.zeros_like(xt), torch.zeros_like(xt))
    got = mb.rw(xt, *ys, reads=3, writes=2, outs=outs, block_rows=8,
                passes=2)
    assert got[0] is outs[0] and got[1] is outs[1]
    want = xt + 1.5 * ys[0] + 1.5 * ys[1]
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    with pytest.raises(ValueError, match="extra read streams"):
        mb.rw(xt, reads=2, writes=1, block_rows=8)
    with pytest.raises(ValueError, match="reads, writes <= 8"):
        mb.rw(xt, reads=1, writes=9, block_rows=8)
    with pytest.raises(ValueError, match="outs holds 1"):
        mb.rw(xt, reads=1, writes=2, outs=(outs[0],), block_rows=8)
    with pytest.raises(ValueError, match="aliases"):
        mb.rw(xt, reads=1, writes=1, outs=(xt,), block_rows=8)
    with pytest.raises(ValueError, match="aliases"):
        mb.rw(xt, reads=1, writes=2, outs=(outs[0], outs[0]), block_rows=8)
    with pytest.raises(ValueError, match="like x"):
        mb.rw(xt, xt[:8].contiguous(), reads=2, writes=1, block_rows=8)
    with pytest.raises(ValueError, match="interleave 16 not in"):
        mb.rw(xt, reads=1, writes=1, block_rows=8, interleave=16)


def test_interleave_rule_is_the_registry_s():
    """``membench_call`` reads ``mixes.interleavable``: the rw family
    interleaves, the other non-sum mixes do not."""
    _, xt = _pair(16 * 1024, "float32")
    out = mb.membench_call(xt, mix="rw_2to1", ys=(xt * 0.5,), block_rows=8,
                           interleave=2)
    assert len(out) == 1
    for mix in ("triad", "mxu", "fma", "fma_4", "load_only",
                "latency_chase"):
        with pytest.raises(ValueError, match="no interleaved variant"):
            mb.membench_call(xt, mix=mix, y=xt, block_rows=8, interleave=2)


# ---------------------------------------------------------------------------
# the torch oracles against the reference's jnp oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("passes,unroll,interleave",
                         [(1, 1, 1), (4, 1, 1), (4, 2, 1), (4, 4, 2),
                          (2, 2, 4)])
@pytest.mark.parametrize("reads,writes", RATIOS)
def test_rw_oracles_match_the_reference(reads, writes, passes, unroll,
                                        interleave, dtype):
    """k_rw / k_rw_istream, same streams and aliased write seeds: the
    returned ``passes * v[0,0] + W * unroll * v[-1,-1]``."""
    xj, xt = _pair(64 * 1024, dtype)
    ysj, yst = _streams(xj, reads)
    if interleave > 1:
        want = ref_im.k_rw_istream((xj, *ysj), (xj,) * writes, passes,
                                   unroll, interleave)
        got = port_im.k_rw_istream((xt, *yst), (xt,) * writes, passes,
                                   unroll, interleave)
    else:
        want = ref_im.k_rw((xj, *ysj), (xj,) * writes, passes, unroll)
        got = port_im.k_rw((xt, *yst), (xt,) * writes, passes, unroll)
    v = _np32(port_reference(rw_name(reads, writes), xt, ys=yst))
    ulp = float(np.spacing(np.abs(v).max())) * ULP_SCALE[dtype]
    tol = 1e-6 * abs(float(want)) + (reads - 1) * ulp * (passes + writes
                                                         * unroll)
    assert got.ndim == 0 and got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= tol, (float(got), float(want))
    expect = passes * v[0, 0] + writes * unroll * v[-1, -1]
    assert abs(float(got) - expect) <= 1e-6 * abs(expect) + 1e-6


def test_run_mix_rw_matches_the_reference():
    xj, xt = _pair(32 * 1024, "float32")
    for mix, interleave in (("rw_3to2", 1), ("rw_2to1", 2)):
        want = ref_im.run_mix(mix, xj, 4, unroll=2, interleave=interleave)
        got = port_im.run_mix(mix, xt, 4, unroll=2, interleave=interleave)
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


# ---------------------------------------------------------------------------
# the timed forms: each backend against its own reference counterpart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("unroll", [1, 2])
@pytest.mark.parametrize("reads,writes", list(RW_RATIOS) + [(3, 2)])
def test_timed_rw_returns_the_pallas_scalar(reads, writes, unroll, dtype):
    """make_timed_kernel, both sides, passes=4: ``passes * sum_w
    out_w[0,0] + unroll * sum_w out_w[-1,-1]`` (the reference chains every
    output leaf)."""
    passes = 4
    mix = rw_name(reads, writes)
    xj, xt = _pair(32 * 1024, dtype, ramp=True)
    ysj, yst = _streams(xj, reads)
    kw = dict(block_rows=16, streams=2, passes=passes, unroll=unroll)
    want = float(ref_ops.make_timed_kernel(mix, interpret=True, **kw)(
        xj, *ysj))
    got = port_ops.make_timed_kernel(mix, **kw)(xt, *yst)
    assert got.ndim == 0 and got.dtype == torch.float32
    v = _np32(port_reference(mix, xt, ys=yst))
    ulp = float(np.spacing(np.abs(v).max())) * ULP_SCALE[dtype]
    tol = 1e-6 * abs(want) + (reads - 1) * ulp * writes * (passes + unroll)
    assert abs(float(got) - want) <= tol, (float(got), want)
    expect = writes * (passes * v[0, 0] + unroll * v[-1, -1])
    assert abs(float(got) - expect) <= 1e-6 * abs(expect)


def test_timed_rw_writes_the_given_outputs():
    _, xt = _pair(16 * 1024, "float32", ramp=True)
    outs = (torch.zeros_like(xt), torch.zeros_like(xt))
    ys = port_im.rw_streams(xt, 2)[1:]
    v = port_ops.make_timed_kernel("rw_2to2", block_rows=8, passes=2)(
        xt, *ys, outs=outs)
    want = xt + 1.5 * ys[0]
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    assert float(v) == pytest.approx(
        2 * (2 * float(want[0, 0]) + float(want[-1, -1])), rel=1e-6)


# ---------------------------------------------------------------------------
# through the backends and the Runner
# ---------------------------------------------------------------------------

TINY = dict(sizes=(16 * 2**10, 64 * 2**10), reps=2, warmup=1,
            target_bytes=2e5)


@pytest.mark.parametrize("ref_backend,kw", [
    ("pallas", dict(mixes=tuple(rw_name(r, w) for r, w in RW_RATIOS))),
    ("pallas", dict(mixes=("rw_8to8", "rw_2to3"), dtype="bfloat16",
                    block_rows=16, streams=2, unroll=2)),
    ("pallas", dict(mixes=("rw_1to2", "rw_3to1"), interleave=4, passes=4,
                    unroll=2)),
    ("xla", dict(mixes=tuple(rw_name(r, w) for r, w in RW_RATIOS))),
    ("xla", dict(mixes=("rw_4to1",), interleave=2, dtype="bfloat16")),
])
def test_runner_accounting_equals_the_reference(ref_backend, kw):
    """The same spec through both Runners: identical passes / bytes_per_call
    / flops_per_call per point (registry formulas, same pass picking)."""
    spec = RefSpec(backend=ref_backend, **{**TINY, **kw})
    ref = RefRunner().run(spec)
    port = Runner(device="cpu").run(BenchSpec.from_dict(
        convert.spec_from_reference(spec.to_dict())))
    assert len(port.points) == len(ref.points) > 0
    for p, q in zip(port.points, ref.points):
        assert (p.mix, p.nbytes, p.passes, p.bytes_per_call,
                p.flops_per_call, p.interleave, p.unroll) == \
            (q.mix, q.nbytes, q.passes, q.bytes_per_call, q.flops_per_call,
             q.interleave, q.unroll)
        assert p.latency_ns is None and p.gen_gbps is None
        r, w = get_mix(p.mix).rw
        assert p.bytes_per_call == (r + w) * p.nbytes * p.passes


def _model(name, x64, p, block_rows=None):
    """What each port backend's timed case returns for a registered mix on a
    positive buffer (a numpy model; the perturbation terms vanish in
    float32).  ``block_rows`` None: the torch oracles; else the cuda form."""
    m = get_mix(name)
    lead = x64[::block_rows or x64.shape[0], 0].sum()
    if name == "load_only":
        return p * lead
    if name == "load_sum":
        return p * x64.sum()
    if name == "copy":
        return p * x64[0, 0] + x64[-1, -1]
    if name == "triad":
        return p * 1.75 * x64[0, 0] + 1.75 * x64[-1, -1]
    if name == "mxu":
        return p * lead
    if m.chase:
        return 0.0            # every full-cycle walk ends where it started
    if m.fma_depth:
        v = x64.copy()
        for _ in range(m.fma_depth):
            v = v * np.float64(np.float32(1.0000001)) + 1e-9
        return p * v.sum()
    factor = 1.0 + 1.5 * sum(0.5 ** r for r in range(1, m.rw[0]))
    v = x64 * factor
    if block_rows is None:
        return p * v[0, 0] + m.rw[1] * v[-1, -1]
    return m.rw[1] * (p * v[0, 0] + v[-1, -1])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", mix_names())
def test_numeric_parity_every_registered_mix(name, backend):
    """Every registered mix runs on the port (mirror of the reference's
    ``test_numeric_parity_xla`` / ``_pallas``), and each timed case returns
    its numpy model's value."""
    mix = get_mix(name)
    assert mix.backends, name
    if not mix.supports(backend):
        assert name == "load_only" and backend == "torch"
        return
    x = np.random.default_rng(0).uniform(0.5, 1.5, size=(32, 128))
    x = x.astype(np.float32)
    xt = torch.tensor(x)
    passes = 3
    spec = BenchSpec(mixes=(name,), backend=backend, sizes=(16 * 2**10,),
                     reps=1, warmup=0, passes=passes,
                     block_rows=8 if backend == "cuda" else None)
    got = float(get_backend(backend).build(spec, mix, xt, passes)())
    want = _model(name, x.astype(np.float64), passes,
                  8 if backend == "cuda" else None)
    assert got == pytest.approx(want, rel=1e-4, abs=1e-6), (name, got, want)


def test_no_mix_is_declared_without_a_backend():
    """Every registered mix runs on at least one port backend, as the
    reference demands of its own registry."""
    assert all(m.backends for m in registry().values())
    assert set(mix_names()) == set(mix_names("torch")) | \
        set(mix_names("cuda"))
