"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's, on the CPU: ``plain_flash`` (the plain version
beside the CUDA kernel) against the reference's Pallas kernel in interpret
mode and against its oracle, at ``tests/test_kernels.py``'s shapes plus one
with the serving model's head dim 80, and with value heads of their own
width (MLA's 192 / 128) and Sq != Sk (whisper's 1500 frames, whole-sequence
blocks); an emulation of the CUDA kernel's bf16 tensor-core numerics
against the same two; the wrapper on CPU tensors; the argument checks and
the (D, Dv) pairs the kernel is built for.  The CUDA kernel itself runs
only on the card (``chip_smoke.py`` phase 2c)."""
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


#: the bf16 route of flash_attn.cu in float32 arithmetic: key tiles of 64,
#: scores scaled by log2(e) / sqrt(D) and masked to -1e30, an online
#: softmax in base 2 in float32, P rounded to bf16 before P V, l summed from
#: the float32 P, O accumulated in float32 and rounded to bf16 once
def _emulate_tensor_core_flash(q, k, v, causal):
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    c = np.float32(np.log2(np.e) / np.sqrt(D))
    m = torch.full((B, KV, G, Sq), -1e30)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, v.shape[-1]))
    pos = torch.arange(Sq)[:, None]
    for j0 in range(0, Sk, 64):
        keys = torch.arange(j0, min(j0 + 64, Sk))[None, :]
        s = torch.einsum("bkgqd,bkjd->bkgqj", qf, kf[:, :, j0:j0 + 64]) * c
        if causal:
            s = torch.where(keys <= pos, s, torch.tensor(-1e30))
        mx = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - mx[..., None])
        corr = torch.exp2(m - mx)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqj,bkjd->bkgqd", p.bfloat16().float(), vf[:, :, j0:j0 + 64])
        m = mx
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, -1).bfloat16()


@pytest.mark.parametrize("shape", SHAPES + [(1, 256, 2, 2, 80)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_numerics_fit_the_reference(shape, causal):
    """The bf16 route's rounding (P in bf16 before P V) stays within the
    reference's bf16 tolerance of its oracle and of its Pallas kernel."""
    q, k, v = _inputs(*shape, jnp.bfloat16, seed=sum(shape))
    got = _emulate_tensor_core_flash(T(q), T(k), T(v), causal)
    assert tuple(got.shape) == q.shape
    got = got.float().numpy()
    tol = TOL["bfloat16"]
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


def _inputs_dv(B, Sq, Sk, H, KV, D, Dv, dtype, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(shape), dtype)
            for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, Dv))]


#: (B, Sq, Sk, H, KV, D, Dv, q_block, kv_block): MLA's (192, 128) pair; the
#: encoder's 1500 frames and the cross-attention's prompt against them,
#: each with a block spanning the sequence (the reference's rule allows
#: it; 256 divides neither)
DV_CASES = [(1, 128, 128, 4, 2, 192, 128, 64, 64),
            (1, 1500, 1500, 2, 2, 64, 64, 1500, 1500),
            (1, 256, 1500, 2, 1, 64, 64, 256, 1500)]


@pytest.mark.parametrize("case", DV_CASES,
                         ids=lambda c: "x".join(map(str, c[:7])))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dname", DTYPES)
def test_plain_flash_matches_the_reference_beyond_square_heads(case, causal,
                                                                dname):
    """``plain_flash`` (and the wrapper, on CPU tensors) with Dv != D and
    with Sq != Sk against the reference's Pallas kernel (interpret mode)
    at the same blocks, and against its oracle; the reference's
    tolerances."""
    B, Sq, Sk, H, KV, D, Dv, qb, kb = case
    q, k, v = _inputs_dv(B, Sq, Sk, H, KV, D, Dv, DTYPES[dname],
                         seed=Sq + Sk + D)
    got = fa.flash_attention(T(q), T(k), T(v), causal=causal, q_block=qb,
                             kv_block=kb)
    assert tuple(got.shape) == (B, Sq, H, Dv)
    tol = TOL[dname]
    for want in (j_flash(q, k, v, causal=causal, q_block=qb, kv_block=kb),
                 j_ref(q, k, v, causal=causal)):
        assert want.shape == got.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_numerics_fit_the_reference_at_the_mla_pair(causal):
    """The bf16 route's rounding at (192, 128), Sq != Sk too, within the
    reference's bf16 tolerance of its oracle and its Pallas kernel."""
    for B, Sq, Sk, H, KV in ((1, 128, 128, 4, 2), (1, 64, 192, 2, 2)):
        q, k, v = _inputs_dv(B, Sq, Sk, H, KV, 192, 128, jnp.bfloat16, Sk)
        got = _emulate_tensor_core_flash(T(q), T(k), T(v), causal)
        assert tuple(got.shape) == (B, Sq, H, 128)
        for want in (j_flash(q, k, v, causal=causal, q_block=64,
                             kv_block=64), j_ref(q, k, v, causal=causal)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=TOL["bfloat16"],
                                       atol=TOL["bfloat16"])


def test_the_kernel_is_built_for_the_mla_pair_only_beside_square_heads():
    """(192, 128) joins the five (D, D) pairs; any other pair is refused
    before a launch (its plain version takes any)."""
    assert fa.HEAD_DIMS == ((32, 32), (64, 64), (80, 80), (96, 96),
                            (128, 128), (192, 128))
    fa.check_built(192, 128)
    fa.check_built(80, 80)
    for pair in ((192, 192), (128, 64), (48, 32)):
        with pytest.raises(ValueError, match="built for the"):
            fa.check_built(*pair)
    # the wrapper's block rule is the reference's, for every caller: 1500
    # takes a block of 1500 (or 1500's divisors), not the default 256
    q, k, v = (T(a) for a in _inputs_dv(1, 64, 1500, 2, 1, 64, 64,
                                        jnp.float32, 0))
    with pytest.raises(ValueError, match="kv_block=256"):
        ops.flash(q, k, v, causal=False)
    assert ops.flash(q, k, v, causal=False, kv_block=1500).shape == \
        (1, 64, 2, 64)


def test_flops_match_the_reference():
    q, k, _ = _inputs(4, 512, 32, 32, 80, jnp.bfloat16, 0)
    for causal in (True, False):
        assert ops.flops(T(q), T(k), causal) == j_flops(q, k, causal)
    # the serving shape's count (PERF.md): 5.37 GFLOP per causal call
    assert ops.flops(T(q), T(k), True) == 5_368_709_120.0
