"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's, on the CPU: ``plain_flash`` (the plain version
beside the CUDA kernel) against the reference's Pallas kernel in interpret
mode and against its oracle, at ``tests/test_kernels.py``'s shapes plus one
with the serving model's head dim 80; the wrapper on CPU tensors; the
argument checks.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` phase 2c)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash as j_flash
from repro.kernels.flash_attention.ops import flops as j_flops
from repro.kernels.flash_attention.ref import reference as j_ref
from repro_torch.convert import tensor_from_reference
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops, ref

SHAPES = [(2, 128, 8, 4, 64), (1, 256, 4, 4, 32), (2, 128, 8, 2, 64),
          (1, 128, 16, 16, 32), (1, 128, 4, 4, 80)]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: the reference's own tolerances (test_flash_vs_ref): float32 2e-5; bf16
#: 2e-2 (the output is rounded to bf16, 2**-8 relative, and the two sides
#: sum in another order)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, S, H, KV, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(shape), dtype)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]


def T(a):
    return tensor_from_reference(np.asarray(a))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dname", DTYPES)
def test_plain_flash_matches_the_reference(shape, causal, dname):
    q, k, v = _inputs(*shape, DTYPES[dname], seed=sum(shape))
    got = fa.plain_flash(T(q), T(k), T(v), causal=causal)
    assert got.dtype == T(q).dtype and tuple(got.shape) == q.shape
    got = got.float().numpy()
    tol = TOL[dname]
    for want in (j_flash(q, k, v, causal=causal, q_block=64, kv_block=64),
                 j_ref(q, k, v, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_on_cpu_is_the_plain_version(causal):
    q, k, v = (T(a) for a in _inputs(2, 64, 8, 2, 80, jnp.bfloat16, 7))
    want = fa.plain_flash(q, k, v, causal=causal)
    for got in (ops.flash(q, k, v, causal=causal),
                fa.flash_attention(q, k, v, causal=causal, q_block=32,
                                   kv_block=16),
                ref.reference(q, k, v, causal=causal)):
        assert torch.equal(got, want)
    assert fa.launch_counts == {"flash_attn": 0}   # no kernel on the CPU


def test_argument_checks_follow_the_reference():
    q, k, v = _inputs(1, 128, 4, 4, 32, jnp.float32, 1)
    # the reference asserts Sq % q_block == 0 and Sk % kv_block == 0
    with pytest.raises(AssertionError):
        j_flash(q, k, v, q_block=48, kv_block=64)
    with pytest.raises(ValueError, match="q_block=48"):
        ops.flash(T(q), T(k), T(v), q_block=48, kv_block=64)
    with pytest.raises(ValueError, match="kv_block=96"):
        ops.flash(T(q), T(k), T(v), q_block=64, kv_block=96)
    # blocks longer than the sequence are capped, as in the reference
    assert ops.flash(T(q), T(k), T(v), q_block=512, kv_block=512).shape == \
        (1, 128, 4, 32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash(T(q).half(), T(k).half(), T(v).half())
    with pytest.raises(ValueError, match="share one device and dtype"):
        ops.flash(T(q), T(k).bfloat16(), T(v))
    with pytest.raises(ValueError, match="multiple of"):
        ops.flash(T(q), T(k)[:, :, :3], T(v)[:, :, :3])
    with pytest.raises(ValueError, match="do not pair"):
        ops.flash(T(q), T(k)[:, :64], T(v))


def test_flops_match_the_reference():
    q, k, _ = _inputs(4, 512, 32, 32, 80, jnp.bfloat16, 0)
    for causal in (True, False):
        assert ops.flops(T(q), T(k), causal) == j_flops(q, k, causal)
    # the serving shape's count (PERF.md): 5.37 GFLOP per causal call
    assert ops.flops(T(q), T(k), True) == 5_368_709_120.0
