"""The port's plain PyTorch oracles (``repro_torch.core.instruction_mix``)
against the reference's jnp oracles: the same buffer, made by the reference
and carried over bit for bit, gives the same returned scalar for the same
``(passes, unroll, interleave)``.

Tolerance: both sides add the same float32 values, in another order; the
reference's own test bound ``n * eps * 1.3`` per sweep (eps 1e-7 — every
oracle widens to float32 before it adds), times the chain depth for fma
(one rounding per link, and XLA may fuse a link into one FMA).  copy / triad
fold single elements, not sums: 1e-6 relative (sequential float32 adds), and
for bfloat16 triad one bfloat16 ulp of the element (2**-6 at |value| < 4)
per term, since each side rounds once per operation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buffers as ref_buffers
from repro.core import instruction_mix as ref
from repro_torch import convert
from repro_torch.core import instruction_mix as port

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
KNOBS = [(1, 1, 1), (4, 1, 1), (4, 2, 1), (4, 4, 2)]   # passes, unroll, ileave
NBYTES = 64 * 1024


def _pair(dtype, nbytes=NBYTES):
    xj = ref_buffers.working_set(nbytes, dtype=JNP[dtype])
    return xj, convert.tensor_from_reference(np.asarray(xj))


def _sum_tol(n, passes, depth=1):
    return max(n * 1e-7 * 1.3 * passes * depth, 1e-4)


def _elem_tol(dtype, passes, unroll, value):
    tol = 1e-6 * abs(value) + 1e-6
    if dtype == "bfloat16":
        tol += (passes + unroll) * 2.0**-6
    return tol


def _check_scalar(got, want, tol):
    assert isinstance(got, torch.Tensor) and got.ndim == 0
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= tol, (float(got), float(want), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("passes,unroll,interleave", KNOBS)
@pytest.mark.parametrize("mix", ["load_sum", "copy", "fma_4", "fma_8", "mxu",
                                 "triad"])
def test_run_mix_returns_the_reference_scalar(mix, passes, unroll, interleave,
                                              dtype):
    if interleave > 1 and mix not in ("load_sum", "copy"):
        with pytest.raises(KeyError, match="no interleaved"):
            port.run_mix(mix, _pair(dtype)[1], passes, unroll=unroll,
                         interleave=interleave)
        with pytest.raises(KeyError, match="no interleaved"):
            ref.run_mix(mix, _pair(dtype)[0], passes, unroll=unroll,
                        interleave=interleave)
        return
    xj, xt = _pair(dtype)
    want = ref.run_mix(mix, xj, passes, unroll=unroll, interleave=interleave)
    got = port.run_mix(mix, xt, passes, unroll=unroll, interleave=interleave)
    if mix in ("copy", "triad", "mxu"):
        tol = _elem_tol(dtype, passes, unroll, float(want))
    else:
        depth = int(mix.split("_")[1]) if mix.startswith("fma_") else 1
        tol = _sum_tol(xt.numel(), passes, depth)
    _check_scalar(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("passes,unroll", [(1, 1), (4, 1), (4, 2), (4, 4)])
def test_each_kernel_function_matches(passes, unroll, dtype):
    xj, xt = _pair(dtype)
    n = xt.numel()
    pairs = [
        (port.k_load_sum(xt, passes, unroll), ref.k_load_sum(xj, passes, unroll),
         _sum_tol(n, passes)),
        (port.k_load_sum_istream(xt, passes, unroll, 4),
         ref.k_load_sum_istream(xj, passes, unroll, 4), _sum_tol(n, passes)),
        (port.k_strided_sum(xt, 4, passes, unroll),
         ref.k_strided_sum(xj, 4, passes, unroll), _sum_tol(n, passes)),
        (port.k_blocked_sum(xt, 16, passes, unroll),
         ref.k_blocked_sum(xj, 16, passes, unroll), _sum_tol(n, passes)),
        (port.k_fma(xt, passes, 3, unroll), ref.k_fma(xj, passes, 3, unroll),
         _sum_tol(n, passes, 3)),
    ]
    for got, want, tol in pairs:
        _check_scalar(got, want, tol)
    # element-folding mixes
    want = ref.k_copy(xj, passes, unroll)
    _check_scalar(port.k_copy(xt, passes, unroll), want,
                  _elem_tol(dtype, passes, unroll, float(want)))
    want = ref.k_copy_istream(xj, passes, unroll, 2)
    _check_scalar(port.k_copy_istream(xt, passes, unroll, 2), want,
                  _elem_tol(dtype, passes, unroll, float(want)))
    want = ref.k_triad(jnp.zeros_like(xj), xj, xj * 0.5, passes, unroll)
    _check_scalar(port.k_triad(torch.zeros_like(xt), xt, xt * 0.5, passes,
                               unroll), want,
                  _elem_tol(dtype, passes, unroll, float(want)))
    wj = jnp.eye(128, dtype=JNP[dtype])
    want = ref.k_mxu(xj, wj, passes, unroll)
    _check_scalar(port.k_mxu(xt, convert.tensor_from_reference(np.asarray(wj)),
                             passes, unroll), want,
                  _elem_tol(dtype, passes, unroll, float(want)))


def test_consume_slots_term_is_in_the_scalar():
    """copy returns passes*x[0,0] + unroll*x[-1,-1]: the rotating slots' last
    elements are part of the value, as in the reference."""
    _, xt = _pair("float32", 16 * 1024)
    first, last = float(xt[0, 0]), float(xt[-1, -1])
    for passes, unroll in ((4, 1), (4, 2), (8, 4)):
        got = float(port.k_copy(xt, passes, unroll))
        assert got == pytest.approx(passes * first + unroll * last, rel=1e-6)


def test_the_buffer_survives_the_perturbation():
    """The in-place ``acc * 1e-30`` write leaves a working-set buffer bit for
    bit as it was (the reference perturbs a copy)."""
    for dtype in ("float32", "bfloat16"):
        _, xt = _pair(dtype, 16 * 1024)
        before = xt.clone()
        port.k_load_sum(xt, 4)
        port.k_fma(xt, 2, 8)
        port.k_mxu(xt, torch.eye(128, dtype=xt.dtype), 2)
        port.k_strided_sum(xt, 2, 2)
        assert torch.equal(xt, before)


def test_errors_match_the_reference():
    xj, xt = _pair("float32", 16 * 1024)
    for fn, x in ((ref.k_load_sum, xj), (port.k_load_sum, xt)):
        with pytest.raises(ValueError, match="passes=3 is not a multiple of "
                                             "unroll=2"):
            fn(x, 3, 2)
    for fn, x in ((ref.k_copy, xj), (port.k_copy, xt)):
        with pytest.raises(ValueError, match="not a multiple"):
            fn(x, 3, 2)
    for fn, x in ((ref.k_load_sum_istream, xj), (port.k_load_sum_istream, xt)):
        with pytest.raises(ValueError, match="interleave=5 does not divide"):
            fn(x, 1, 1, 5)
    for mod, x in ((ref, xj), (port, xt)):
        with pytest.raises(KeyError):
            mod.run_mix("nope", x, 1)
    # the mixes whose kernels are not in the port yet are refused by name
    for name in ("rw_2to1", "latency_chase"):
        with pytest.raises(KeyError):
            port.run_mix(name, xt, 1)
