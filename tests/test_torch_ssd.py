"""The port's Mamba-2 SSD (``repro_torch.kernels.ssd_scan`` and the model's
SSD routes) against the JAX package's, on the CPU: ``plain_ssd`` (the plain
version beside the CUDA kernel) against the reference's Pallas kernel in
interpret mode and its recurrence oracle, at ``test_ssd_vs_recurrence``'s
shapes; the port's ``ssd_chunked`` against the reference's; the kernel route
of ``Variant.use_pallas`` (per-head layout, stride-0 B/C views) against the
reference's ``ssd_chunked`` at ``test_model_ssd_matches_kernel``'s shapes;
the wrapper's layouts and checks.  The CUDA kernel itself runs only on the
card (``chip_smoke.py`` phase 2c)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import flops as j_flops
from repro.kernels.ssd_scan.ops import ssd as j_ssd
from repro.kernels.ssd_scan.ref import reference as j_ref
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.convert import tensor_from_reference
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan as sk
from repro_torch.models import ssm

#: the reference's own tolerance (test_ssd_vs_recurrence): the chunked and
#: the token-level forms sum in another order, in float32
TOL = 2e-4


def T(a):
    return tensor_from_reference(np.asarray(a))


def _kernel_inputs(BH, S, P, N, seed):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.standard_normal((BH, S, P)) * 0.5, jnp.float32),
            jnp.asarray(-np.abs(rng.standard_normal((BH, S))) * 0.3,
                        jnp.float32),
            jnp.asarray(rng.standard_normal((BH, S, N)) * 0.5, jnp.float32),
            jnp.asarray(rng.standard_normal((BH, S, N)) * 0.5, jnp.float32))


@pytest.mark.parametrize("BH,S,P,N,Q", [
    (4, 128, 32, 16, 32), (2, 256, 64, 32, 64), (1, 64, 16, 8, 16),
])
def test_plain_ssd_matches_the_reference(BH, S, P, N, Q):
    xdt, dA, Bm, Cm = _kernel_inputs(BH, S, P, N, seed=BH + S)
    y, st = sk.plain_ssd(T(xdt), T(dA), T(Bm), T(Cm))
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (BH, S, P) and tuple(st.shape) == (BH, N, P)
    for jy, jst in (j_ssd(xdt, dA, Bm, Cm, chunk=Q), j_ref(xdt, dA, Bm, Cm)):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=TOL,
                                   atol=TOL)


def _model_inputs(dtype, seed=7):
    """``test_model_ssd_matches_kernel``'s inputs (B 2, S 128, H 4, P 16,
    N 8, one group), drawn with numpy."""
    rng = np.random.default_rng(seed)
    B, S, H, P, N = 2, 128, 4, 16, 8
    return (jnp.asarray(rng.standard_normal((B, S, H, P)) * 0.5, dtype),
            jnp.asarray(np.abs(rng.standard_normal((B, S, H))) * 0.5 + 0.1,
                        jnp.float32),
            -jnp.ones((H,), jnp.float32) * 0.5,
            jnp.asarray(rng.standard_normal((B, S, 1, N)) * 0.5, dtype),
            jnp.asarray(rng.standard_normal((B, S, 1, N)) * 0.5, dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("chunk", [32, 128])
def test_ssd_chunked_matches_the_reference(dtype, chunk):
    args = _model_inputs(dtype)
    y, st = ssm.ssd_chunked(*(T(a) for a in args), chunk)
    jy, jst = jax.jit(j_ssd_chunked, static_argnums=5)(*args, chunk)
    # the same bf16 roundings of the einsum operands on both sides, float32
    # sums in another order: 1e-5 of the largest value for float32 inputs
    # (measured <= 1.6e-6); 1e-4 for bf16 inputs (measured <= 7.2e-5), where
    # XLA pairs the three-operand einsums otherwise and rounds an
    # intermediate product the port keeps
    tol = 1e-5 if dtype == jnp.float32 else 1e-4
    for want, got in ((jy, y), (jst, st)):
        want = np.asarray(want, np.float32)
        err = np.abs(want - got.numpy()).max() / np.abs(want).max()
        assert err <= tol, err


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kernel_route_matches_the_reference_ssd_chunked(dtype):
    """``ssd_kernel_route`` (what ``use_pallas`` runs) against the
    reference's ``ssd_chunked``, with the reference's own tolerance for the
    same comparison (test_model_ssd_matches_kernel, 5e-3): the kernel keeps
    CB*L, the decays and the carried state in float32 where ``ssd_chunked``
    rounds them to bf16.  For bf16 inputs y comes back in bf16 (the kernel
    returns y in xdt's dtype), whose rounding adds at most 2**-8 of |y| (the
    unit roundoff) to y's relative tolerance; the float32 state keeps
    5e-3."""
    args = _model_inputs(dtype)
    y, st = ssm.ssd_kernel_route(*(T(a) for a in args), 32)
    jy, jst = jax.jit(j_ssd_chunked, static_argnums=5)(*args, 32)
    rtol = 5e-3 if dtype == jnp.float32 else 5e-3 + 2**-8
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=rtol,
                               atol=5e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=5e-3,
                               atol=5e-3)


def test_wrapper_layouts_and_dtypes_on_cpu():
    xdt, dA, Bm, Cm = (T(a) for a in _kernel_inputs(8, 64, 16, 8, seed=3))
    y, st = ops.ssd(xdt, dA, Bm, Cm, chunk=16)
    wy, wst = ref.reference(xdt, dA, Bm, Cm)
    assert torch.equal(y, wy) and torch.equal(st, wst)
    # (B, H, S, N) views: one batch row's B shared by its 4 heads, stride 0
    b4 = Bm[::4].unsqueeze(1).expand(2, 4, 64, 8)
    c4 = Cm[::4].unsqueeze(1).expand(2, 4, 64, 8)
    assert b4.stride(1) == 0
    y4, st4 = sk.ssd_scan(xdt, dA, b4, c4, chunk=16)
    wy4, wst4 = sk.plain_ssd(xdt, dA, Bm[::4].repeat_interleave(4, 0),
                             Cm[::4].repeat_interleave(4, 0))
    assert torch.equal(y4, wy4) and torch.equal(st4, wst4)
    # y comes back in xdt's dtype, the state in float32 (the reference's)
    yb, stb = sk.ssd_scan(xdt.bfloat16(), dA, Bm.bfloat16(), Cm.bfloat16())
    assert yb.dtype == torch.bfloat16 and stb.dtype == torch.float32
    assert sk.launch_counts == {"ssd_scan": 0}     # no kernel on the CPU


def test_argument_checks_follow_the_reference():
    xdt, dA, Bm, Cm = _kernel_inputs(2, 96, 16, 8, seed=4)
    with pytest.raises(AssertionError):          # 96 % 64 != 0
        j_ssd(xdt, dA, Bm, Cm, chunk=64)
    with pytest.raises(ValueError, match="multiple of the chunk 64"):
        ops.ssd(T(xdt), T(dA), T(Bm), T(Cm), chunk=64)
    with pytest.raises(ValueError, match="dA must be"):
        ops.ssd(T(xdt), T(dA)[:, :32], T(Bm), T(Cm), chunk=32)
    with pytest.raises(ValueError, match="Bm must be"):
        ops.ssd(T(xdt), T(dA), T(Bm)[:1], T(Cm), chunk=32)
    # the kernel's shared memory is checked before a launch
    assert sk.smem_bytes(64, 64, 256) == 101_120
    assert sk.smem_bytes(128, 256, 256) > sk.MAX_SMEM_BYTES


def test_flops_match_the_reference():
    assert ops.flops(320, 512, 64, 64, 256) == j_flops(320, 512, 64, 64, 256)
    # the serving shape's count (PERF.md): 13.4 GFLOP per call
    assert ops.flops(320, 512, 64, 64, 256) == 13_421_772_800.0


def _ssd_doing_the_needed_work(x, dA, B, C, Q: int, heads: int):
    """The SSD computed with only the products ``ops.work_flops`` counts,
    each a 2-d matmul: per chunk C B^T over the causal half of the pairs
    once a group of ``heads`` rows (which share B and C), then per row
    (C B^T o L) x over the same half, C state after the first chunk, and
    the state update.  x (BH, S, P), dA (BH, S), B and C (BH, S, N)."""
    BH, S, P = x.shape
    y = torch.zeros(BH, S, P)
    st = torch.zeros(BH, B.shape[-1], P)
    for c0 in range(0, S, Q):
        cum = torch.cumsum(dA[:, c0:c0 + Q], 1)
        for g in range(0, BH, heads):
            Bc, Cc = B[g, c0:c0 + Q], C[g, c0:c0 + Q]
            cb = [Cc[i:i + 1] @ Bc[:i + 1].T for i in range(Q)]
            for h in range(g, g + heads):
                for i in range(Q):
                    L = torch.exp(cum[h, i] - cum[h, :i + 1])
                    y[h, c0 + i] = ((cb[i] * L) @ x[h, c0:c0 + i + 1])[0]
                if c0:
                    y[h, c0:c0 + Q] += torch.exp(cum[h])[:, None] * (
                        Cc @ st[h])
                w = torch.exp(cum[h, -1] - cum[h])
                st[h] = torch.exp(cum[h, -1]) * st[h] + Bc.T @ (
                    w[:, None] * x[h, c0:c0 + Q])
    return y, st


@pytest.mark.parametrize("heads", [1, 2])
def test_work_flops_is_what_a_computation_of_the_function_needs(heads):
    """``ops.work_flops`` (the bound's count) equals the matmul FLOPs that
    ``FlopCounterMode`` counts in a computation doing only the products it
    names, and that computation is the SSD: it agrees with the recurrence
    oracle within the reference's tolerance.  B and C per row (``heads``
    1) or one matrix for each pair of rows (2 heads a group)."""
    from torch.utils.flop_counter import FlopCounterMode
    BH, S, P, N, Q = 4, 24, 4, 8, 8
    rng = np.random.default_rng(heads)
    x = rng.standard_normal((BH, S, P)).astype(np.float32) * 0.5
    dA = -np.abs(rng.standard_normal((BH, S))).astype(np.float32) * 0.3
    B, C = (np.repeat(rng.standard_normal((BH // heads, S, N)).astype(
        np.float32) * 0.5, heads, axis=0) for _ in range(2))
    with FlopCounterMode(display=False) as fc:
        y, st = _ssd_doing_the_needed_work(T(x), T(dA), T(B), T(C), Q, heads)
    assert fc.get_total_flops() == ops.work_flops(BH, S, P, N, Q,
                                                  BH // heads)
    assert ops.work_flops(BH, S, P, N, Q, BH // heads) \
        < ops.flops(BH, S, P, N, Q)
    ry, rst = j_ref(x, dA, B, C)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(rst), rtol=TOL,
                               atol=TOL)
