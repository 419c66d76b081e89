"""The port's membench wrappers on CPU tensors (where they take their plain
PyTorch versions) against the reference's Pallas kernels in interpret mode —
mirror of ``tests/test_kernels.py::test_membench_vs_ref``, plus load_only,
triad, interleave and the timed forms.  The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.

Tolerance (the reference test's own): sums cancel exactly in exact
arithmetic, so ``atol = max(n * eps * 1.3, 1e-4)`` with eps 1e-7 float32 /
8e-3 bfloat16; times the chain depth for fma; copy is bit-exact; triad
rounds once per operation in the port; the reference's compiler may
contract ``b + 1.5 * c`` into one fused multiply-add (a single rounding), so
the two may differ by one ulp of the result at |value| < 4: 2**-22 float32,
2**-6 bfloat16.

Those absolute bounds exceed the sums themselves (about 0 on the working
set), so they cannot tell a kernel that reads every tile once from one that
does not.  The ``*_non_cancelling`` tests therefore repeat the comparisons on
a ramp input (``|x|`` scaled row by row from 0.5 to 1.5: every tile has its
own positive sum) with a relative tolerance: both sides widen to float32 and
add at most 2**16 positive terms in another order, so they agree to 1e-5 of
the sum (``SUM_RTOL``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.buffers import working_set as ref_working_set
from repro.kernels.membench import ops as ref_ops
from repro.kernels.membench.ref import reference as ref_reference
from repro_torch import convert
from repro_torch.kernels.membench import membench as mb
from repro_torch.kernels.membench import ops as port_ops
from repro_torch.kernels.membench.ref import reference as port_reference

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
EPS = {"float32": 1e-7, "bfloat16": 8e-3}
TRIAD_ULP = {"float32": 2.0**-22, "bfloat16": 2.0**-6}
SUM_RTOL = 1e-5


def _triad_y(mix, xt):
    """The extra positional operand of a triad kernel (none otherwise)."""
    return (xt * 0.5,) if mix == "triad" else ()


def _pair(nbytes, dtype):
    xj = ref_working_set(nbytes, dtype=JNP[dtype])
    return xj, convert.tensor_from_reference(np.asarray(xj))


def _ramp_pair(nbytes, dtype):
    """The non-cancelling input, made with numpy and handed to both sides."""
    a = np.abs(np.asarray(ref_working_set(nbytes, dtype=jnp.float32)))
    a = a * np.linspace(0.5, 1.5, a.shape[0], dtype=np.float32)[:, None]
    xj = jnp.asarray(a).astype(JNP[dtype])
    return xj, convert.tensor_from_reference(np.asarray(xj))


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("nbytes", [16 * 1024, 128 * 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", ["load_sum", "load_only", "copy", "fma_4",
                                 "mxu", "triad"])
@pytest.mark.parametrize("block_rows,streams", [(8, 1), (32, 2), (16, 4)])
def test_membench_vs_reference_kernel(nbytes, dtype, mix, block_rows, streams):
    xj, xt = _pair(nbytes, dtype)
    if xt.shape[0] % (block_rows * streams):
        # the tiling does not fit this buffer: the wrapper refuses it
        # instead of walking a ragged edge
        with pytest.raises(ValueError, match="does not divide"):
            port_ops.make_kernel(mix=mix, block_rows=block_rows,
                                 streams=streams)(xt, *_triad_y(mix, xt))
        return
    fj = ref_ops.make_kernel(mix=mix, block_rows=block_rows, streams=streams,
                             interpret=True)
    ft = port_ops.make_kernel(mix=mix, block_rows=block_rows, streams=streams)
    if mix == "triad":
        want, got = fj(xj, xj * 0.5), ft(xt, xt * 0.5)
    else:
        want, got = fj(xj), ft(xt)
    own = port_reference(mix, xt, depth=4, block_rows=block_rows, y=xt * 0.5)
    theirs = ref_reference(mix, xj, depth=4, block_rows=block_rows,
                           y=xj * 0.5)
    atol = max(xt.numel() * EPS[dtype] * 1.3, 1e-4)
    if mix == "fma_4":
        atol *= 4
    if mix == "copy":
        assert got.dtype == xt.dtype and got.shape == xt.shape
        assert np.array_equal(_np32(got), _np32(want))
        assert got.data_ptr() != xt.data_ptr()
    elif mix == "triad":
        tol = TRIAD_ULP[dtype]
        assert got.dtype == xt.dtype
        np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=0)
        np.testing.assert_allclose(_np32(own), _np32(theirs), atol=tol, rtol=0)
    else:
        assert got.ndim == 0 and got.dtype == torch.float32
        assert abs(float(got) - float(want)) < atol, (float(got), float(want))
        assert abs(float(own) - float(theirs)) < atol
        assert abs(float(got) - float(own)) < atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", ["load_sum", "load_only", "fma_4", "mxu"])
@pytest.mark.parametrize("block_rows,streams,interleave",
                         [(8, 1, 1), (32, 2, 1), (16, 4, 1), (16, 2, 4)])
def test_membench_vs_reference_kernel_non_cancelling(mix, block_rows, streams,
                                                     interleave, dtype):
    if interleave > 1 and mix != "load_sum":
        interleave = 1            # only load_sum has an interleaved sum
    xj, xt = _ramp_pair(128 * 1024, dtype)
    kw = dict(mix=mix, block_rows=block_rows, streams=streams,
              interleave=interleave)
    want = float(ref_ops.make_kernel(interpret=True, **kw)(xj))
    got = float(port_ops.make_kernel(**kw)(xt))
    own = float(port_reference(mix, xt, depth=4, block_rows=block_rows))
    # what the kernel must return, in float64 from the same stored values
    a = _np32(xt).astype(np.float64)
    if mix == "fma_4":
        for _ in range(4):
            a = a * np.float64(np.float32(mb.FMA_A)) + mb.FMA_B
    exact = a[::block_rows, 0].sum() if mix in ("load_only", "mxu") \
        else a.sum()
    assert exact > 1
    for v in (got, want, own):
        assert abs(v - exact) <= SUM_RTOL * exact, (v, exact)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fma_depth_is_honoured_non_cancelling(dtype):
    """At depth 4 the chain moves a value by 5e-7 of itself, less than
    SUM_RTOL; at depth 256 it moves it by 3e-5, and a sum of 4096 terms is
    good to 5e-6 on both sides."""
    xj, xt = _ramp_pair(16 * 1024, dtype)
    want = float(ref_ops.make_kernel(mix="fma_256", block_rows=8,
                                     interpret=True)(xj))
    got = float(port_ops.make_kernel(mix="fma_256", block_rows=8)(xt))
    shallow = float(port_ops.make_kernel(mix="fma_4", block_rows=8)(xt))
    tol = 5e-6 * abs(want)
    assert abs(got - want) <= tol, (got, want)
    assert abs(shallow - want) > 4 * tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", ["load_sum", "copy"])
@pytest.mark.parametrize("interleave", [2, 4])
def test_interleave_matches_reference_kernel(mix, interleave, dtype):
    xj, xt = _pair(64 * 1024, dtype)
    fj = ref_ops.make_kernel(mix=mix, block_rows=16, streams=2,
                             interleave=interleave, interpret=True)
    ft = port_ops.make_kernel(mix=mix, block_rows=16, streams=2,
                              interleave=interleave)
    want, got = fj(xj), ft(xt)
    if mix == "copy":
        assert np.array_equal(_np32(got), _np32(want))
    else:
        atol = max(xt.numel() * EPS[dtype] * 1.3, 1e-4)
        assert abs(float(got) - float(want)) < atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("unroll", [1, 2])
@pytest.mark.parametrize("mix", ["load_sum", "load_only", "fma_4", "mxu",
                                 "copy", "triad"])
def test_timed_kernel_returns_the_reference_scalar(mix, unroll, dtype):
    """make_timed_kernel, both sides, passes=4: the same returned scalar
    (sum over passes for the scalar mixes; passes*out[0,0] +
    unroll*out[-1,-1] for copy / triad)."""
    passes = 4
    xj, xt = _pair(32 * 1024, dtype)
    fj = ref_ops.make_timed_kernel(mix, block_rows=16, streams=2,
                                   interpret=True, passes=passes,
                                   unroll=unroll)
    ft = port_ops.make_timed_kernel(mix, block_rows=16, streams=2,
                                    passes=passes, unroll=unroll)
    if mix == "triad":
        want, got = fj(xj, xj * 0.5), ft(xt, xt * 0.5)
    else:
        want, got = fj(xj), ft(xt)
    assert got.ndim == 0 and got.dtype == torch.float32
    if mix in ("copy", "triad"):
        tol = 1e-6 * abs(float(want)) + 1e-6
        if dtype == "bfloat16" and mix == "triad":
            tol += (passes + unroll) * 2.0**-6
    else:
        depth = 4 if mix == "fma_4" else 1
        tol = max(xt.numel() * EPS[dtype] * 1.3 * passes * depth, 1e-4)
    assert abs(float(got) - float(want)) <= tol, (float(got), float(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", ["load_sum", "load_only", "fma_4", "mxu"])
def test_timed_kernel_returns_the_reference_scalar_non_cancelling(mix, dtype):
    passes = 4
    xj, xt = _ramp_pair(32 * 1024, dtype)
    kw = dict(block_rows=16, streams=2, passes=passes, unroll=2)
    want = float(ref_ops.make_timed_kernel(mix, interpret=True, **kw)(xj))
    got = float(port_ops.make_timed_kernel(mix, **kw)(xt))
    one = float(port_ops.make_kernel(mix=mix, block_rows=16, streams=2)(xt))
    assert one > 1
    assert abs(got - want) <= SUM_RTOL * abs(want), (got, want)
    assert abs(got - passes * one) <= SUM_RTOL * abs(want)


def test_timed_copy_writes_the_given_output():
    _, xt = _pair(16 * 1024, "float32")
    out = torch.zeros_like(xt)
    v = port_ops.make_timed_kernel("copy", block_rows=8, passes=2)(xt, out=out)
    assert torch.equal(out, xt)
    assert float(v) == pytest.approx(2 * float(xt[0, 0]) + float(xt[-1, -1]))
    out.zero_()
    port_ops.make_timed_kernel("triad", block_rows=8)(xt, xt * 0.5, out=out)
    assert torch.equal(out, xt + 1.5 * (xt * 0.5))


def test_stream_orders_equivalent():
    """All stream interleavings must visit every block exactly once."""
    xj, xt = _pair(64 * 1024, "float32")
    outs = [float(port_ops.make_kernel("load_sum", block_rows=16,
                                       streams=s)(xt)) for s in (1, 2, 4)]
    refs = [float(ref_ops.make_kernel("load_sum", block_rows=16,
                                      streams=s)(xj)) for s in (1, 2, 4)]
    assert max(outs + refs) - min(outs + refs) < 1e-3


def test_stream_orders_equivalent_non_cancelling():
    """On the ramp input every tile has its own sum: a walk that leaves a
    tile out or visits one twice moves the result."""
    xj, xt = _ramp_pair(64 * 1024, "float32")
    exact = float(_np32(xt).astype(np.float64).sum())
    outs = [float(port_ops.make_kernel("load_sum", block_rows=16,
                                       streams=s)(xt)) for s in (1, 2, 4)]
    refs = [float(ref_ops.make_kernel("load_sum", block_rows=16,
                                      streams=s)(xj)) for s in (1, 2, 4)]
    assert max(abs(v - exact) for v in outs + refs) <= SUM_RTOL * exact


def test_work_accounting_equals_reference():
    xj, xt = _pair(32 * 1024, "float32")
    for mix in ("load_sum", "load_only", "copy", "triad", "fma_8", "mxu",
                "fma"):
        assert port_ops.work_per_call(mix, xt) == ref_ops.work_per_call(mix, xj)
    b, f = port_ops.work_per_call("load_sum", xt)
    assert b == xt.numel() * 4 and f == xt.numel()
    assert port_ops.work_per_call("fma_8", xt)[1] == 16 * xt.numel()


@pytest.mark.parametrize("bad,match", [
    (dict(block_rows=12), "multiple of 8"),
    (dict(block_rows=48), "divides"),
    (dict(block_rows=8, streams=3), "streams 3 does not divide"),
    (dict(block_rows=8, unroll=3, passes=3), "unroll 3 not in"),
    (dict(block_rows=8, unroll=2, passes=3), "multiple of unroll"),
    (dict(block_rows=8, interleave=3), "interleave 3 not in"),
    (dict(block_rows=8, interleave=16), "interleave 16 not in"),
    (dict(block_rows=16, passes=0), "positive multiple"),
])
def test_wrapper_rejects_bad_knobs(bad, match):
    _, xt = _pair(16 * 1024, "float32")      # 32 rows
    with pytest.raises(ValueError, match=match):
        mb.load_sum(xt, **bad)


def test_wrapper_rejects_bad_tensors():
    _, xt = _pair(16 * 1024, "float32")
    with pytest.raises(ValueError, match="contiguous"):
        mb.load_sum(xt.t().contiguous().t(), block_rows=8)
    with pytest.raises(ValueError, match="shape"):
        mb.load_sum(xt.reshape(-1, 64), block_rows=8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mb.load_sum(xt.to(torch.float64), block_rows=8)
    with pytest.raises(TypeError, match="torch.Tensor"):
        mb.copy(xt.numpy(), block_rows=8)
    with pytest.raises(ValueError, match="like x"):
        mb.triad(xt, xt[:16].contiguous(), block_rows=8)
    with pytest.raises(ValueError, match="like x"):
        mb.copy(xt, xt.to(torch.bfloat16), block_rows=8)
    with pytest.raises(ValueError, match="depth"):
        mb.fma(xt, 0, block_rows=8)
    with pytest.raises(ValueError, match="no interleaved variant"):
        mb.membench_call(xt, mix="triad", y=xt, block_rows=8, interleave=2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mb.load_sum(xt.to("meta"), block_rows=8)


def test_cpu_tensors_never_touch_the_kernels():
    """On the CPU the wrappers take their plain versions: nothing is built,
    nothing is counted as a launch."""
    _, xt = _pair(16 * 1024, "float32")
    mb.reset_launch_counts()
    for mix in ("load_sum", "load_only", "fma_8", "mxu", "copy"):
        mb.membench_call(xt, mix=mix, block_rows=8, passes=2)
    mb.membench_call(xt, mix="triad", y=xt, block_rows=8)
    assert mb._libs == {}
    assert mb.launch_counts == {k: 0 for k in mb.KERNEL_NAMES}
    assert set(mb.SOURCES) == set(mb.KERNEL_NAMES)
    assert all((mb.CSRC / s).exists() for s in mb.SOURCES.values())


def test_mxu_checksum_covers_all_of_y():
    """With w = eye the product is x itself: the checksum the kernel returns
    beside the y[0,0] sum equals the sum of x."""
    _, xt = _ramp_pair(32 * 1024, "float32")
    both = mb.mxu(xt, block_rows=16, passes=2, with_checksum=True)
    assert both.shape == (2,)
    assert float(both[0]) == pytest.approx(
        2 * float(xt[::16, 0].sum()), rel=1e-6)
    assert float(both[1]) == pytest.approx(
        2 * float(xt.sum(dtype=torch.float64)), rel=SUM_RTOL)
    w = torch.full((128, 128), 0.5)
    both = mb.mxu(xt, w, block_rows=16, with_checksum=True)
    y = xt @ w
    assert float(both[0]) == pytest.approx(float(y[::16, 0].sum()), rel=1e-5)


def test_default_block_rows_matches_the_backend_rule():
    from repro.bench.backends import get_backend as ref_backend
    from repro.bench.spec import BenchSpec as RefSpec
    spec = RefSpec(backend="pallas")
    for rows in (8, 64, 120, 128, 136, 1000 * 8, 2**20):
        assert mb.default_block_rows(rows) == \
            ref_backend("pallas")._resolve(spec, rows)
