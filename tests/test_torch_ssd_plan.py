"""The tensor-core design of the SSD kernel (route 1 of
``csrc/ssd_scan.cu``) and its launch plan, on the CPU.

The kernel runs only on the card (``chip_smoke.py`` phase 2c).  Here its
arithmetic is emulated in plain PyTorch along its own decomposition -- CTAs
of (row, 16 columns of P) from the grid the wrapper plans, chunks walked in
order with the state carried in float32, query tiles of 16 dealt to the
warps in snake order, key tiles at or below the diagonal, state columns in
n-tiles of 8 owned by warps -- with its roundings: every product takes bf16
operands and sums in float32, and a float32 operand (C B^T o L, the state,
w o x) enters as two bf16 halves, hi = bf16(a) and lo = bf16(a - hi).  The
emulation is held against the JAX package's recurrence oracle and its
Pallas kernel in interpret mode at the reference's test shapes.  Float32
inputs take route 0 (float32 FMAs), emulated along the same decomposition
without the splits.  The launch plan is held against the constants and the
note of the source: coverage, shared memory against the CTAs an SM the
launch bound claims, and the wave count at the serving shape."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import reference as j_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan as j_ssd_scan
from repro_torch.convert import tensor_from_reference
from repro_torch.kernels.ssd_scan import ssd_scan as sk

SOURCE = (sk.LIBRARY.csrc / "ssd_scan.cu").read_text()
#: chip_smoke.py's SSD_SHAPES (the reference's test shapes): (BH, S, P, N, Q)
SHAPES = [(4, 128, 32, 16, 32), (2, 256, 64, 32, 64), (1, 64, 16, 8, 16)]
#: chip_smoke.py's SSD_TOL: the chunked kernel and the token recurrence sum
#: in another order, in float32; bf16 y adds its rounding, 2**-8 of |y|
TOL = 2e-4
#: the serving shape (B * H, S, P, N, chunk) and the card's SM count
SERVE = (4 * 80, 512, 64, 64, 256)
SMS = 132
LOG2E = 1.4426950408889634


def _constant(name: str, **known: int) -> int:
    """An integer constant of the source (an expression of ``known``)."""
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, f"{name} not found in ssd_scan.cu"
    return int(eval(m.group(1), {}, known))


WARPS = _constant("kTcWarps")


def T(a):
    return tensor_from_reference(np.asarray(a))


def _inputs(BH, S, P, N, seed, bf16: bool):
    """The reference test's inputs (x, B, C at 0.5, dA = -|0.3 n|); with
    ``bf16`` x, B and C rounded to bfloat16 (kept as float32 arrays, so that
    the reference computes in float32 on exactly the kernel's values)."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((BH, S, P)) * 0.5, jnp.float32)
    dA = jnp.asarray(-np.abs(rng.standard_normal((BH, S))) * 0.3,
                     jnp.float32)
    B = jnp.asarray(rng.standard_normal((BH, S, N)) * 0.5, jnp.float32)
    C = jnp.asarray(rng.standard_normal((BH, S, N)) * 0.5, jnp.float32)
    if bf16:
        x, B, C = (a.astype(jnp.bfloat16).astype(jnp.float32)
                   for a in (x, B, C))
    return x, dA, B, C


def _cta(c: int, BH: int, P: int) -> tuple[int, int]:
    """CTA c of route 1's grid -> (row bh, first column p0): the column
    slices of one row are neighbours (blockIdx.x % slices)."""
    slices = -(-P // sk.TC_COLS)
    return c // slices, (c % slices) * sk.TC_COLS


def _query_tiles(warp: int, Q: int) -> list[int]:
    """The query tiles of 16 rows warp ``warp`` takes in a chunk: dealt in
    snake order (tile u * W + w for even u, u * W + W - 1 - w for odd)."""
    n = Q // 16
    tiles = []
    for u in range(-(-n // WARPS)):
        qt = u * WARPS + (WARPS - 1 - warp if u % 2 else warp)
        if qt < n:
            tiles.append(qt)
    return tiles


def _state_tiles(warp: int, N: int) -> list[int]:
    """The n-tiles of 8 state columns warp ``warp`` owns (N padded up)."""
    nt = sk.tc_width(N) // 8
    return [t for t in range(warp, nt, WARPS)]


def _split(a: torch.Tensor, route: int) -> tuple:
    """A float32 operand as the kernel feeds it: (hi, lo) bf16 halves on
    route 1, (a, 0) on route 0."""
    if route == 0:
        return a, torch.zeros_like(a)
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def emulate(x, dA, B, C, Q: int, route: int, one_rounding: bool = False
            ) -> tuple:
    """y (float32, before the output's rounding) and the final state (N, P)
    per row, along the kernel's decomposition.  x, B, C float32 tensors
    (bf16 values on route 1).  ``one_rounding``: the float32 operands
    rounded to bf16 once instead of split (what the kernel must not do)."""

    def _mm2(a, b, route):               # a float32, b exact in its type
        if one_rounding:
            return a.to(torch.bfloat16).float() @ b
        hi, lo = _split(a, route)
        return hi @ b + lo @ b

    BH, S, P = x.shape
    N = B.shape[-1]
    plan = sk.launch_plan(BH, P, N, Q, torch.bfloat16 if route else
                          torch.float32)
    assert plan["route"] == route
    y = torch.full((BH, S, P), float("nan"))
    state = torch.full((BH, N, P), float("nan"))
    ctas = plan["grid"] if route else BH
    for c in range(ctas):
        bh, p0 = _cta(c, BH, P) if route else (c, 0)
        cols = slice(p0, min(p0 + (sk.TC_COLS if route else P), P))
        st = torch.zeros(N, cols.stop - cols.start)
        for c0 in range(0, S, Q):
            c2 = torch.cumsum(dA[bh, c0:c0 + Q], 0) * LOG2E
            w = torch.exp2(c2[-1] - c2)
            Cc, Bc = C[bh, c0:c0 + Q], B[bh, c0:c0 + Q]
            Xc = x[bh, c0:c0 + Q, cols]
            for warp in range(WARPS):
                for qt in _query_tiles(warp, Q):
                    r = slice(16 * qt, 16 * qt + 16)
                    acc = _mm2(st.T, Cc[r].T, route).T * \
                        torch.exp2(c2[r])[:, None]
                    for kt in range(qt + 1):
                        k = slice(16 * kt, 16 * kt + 16)
                        s = (Cc[r] @ Bc[k].T) * torch.exp2(
                            c2[r][:, None] - c2[k][None, :])
                        if kt == qt:
                            s = torch.where(torch.ones(16, 16).tril().bool(),
                                            s, torch.zeros(()))
                        acc = acc + _mm2(s, Xc[k], route)
                    y[bh, c0 + r.start:c0 + r.stop, cols] = acc
            upd = _mm2((w[:, None] * Xc).T, Bc, route).T        # (N, cols)
            new = torch.full_like(st, float("nan"))
            for warp in range(WARPS):
                for nt in _state_tiles(warp, N):
                    n = slice(8 * nt, min(8 * nt + 8, N))
                    new[n] = st[n] * torch.exp2(c2[-1]) + upd[n]
            st = new
        state[bh, :, cols] = st
    return y, state


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_tensor_core_numerics_fit_the_reference(shape, dname):
    """bf16 inputs: route 1's split products keep y within SSD_TOL (plus
    its bf16 rounding) of the recurrence oracle and of the Pallas kernel,
    and the float32 state within SSD_TOL; float32 inputs: route 0 along the
    same decomposition, likewise."""
    BH, S, P, N, Q = shape
    bf16 = dname == "bfloat16"
    x, dA, B, C = _inputs(BH, S, P, N, seed=BH + S, bf16=bf16)
    y, st = emulate(T(x), T(dA), T(B), T(C), Q, route=int(bf16))
    assert bool(y.isfinite().all()) and bool(st.isfinite().all())
    ry, rst = j_ref(x, dA, B, C)
    py, pst = j_ssd_scan(x, dA, B, C, chunk=Q, interpret=True)
    out = y.to(torch.bfloat16).float() if bf16 else y
    rounding = 2.0**-8 if bf16 else 0.0
    for want_y, want_st in ((ry, rst), (py, pst)):
        want_y, want_st = np.asarray(want_y), np.asarray(want_st)
        # before the output's rounding, within SSD_TOL
        np.testing.assert_allclose(y.numpy(), want_y, rtol=TOL, atol=TOL)
        assert np.all(np.abs(out.numpy() - want_y)
                      <= TOL + (TOL + rounding) * np.abs(want_y))
        np.testing.assert_allclose(st.numpy(), want_st, rtol=TOL, atol=TOL)


def test_one_bf16_rounding_would_not_be_the_same_function():
    """Why the float32 operands are split: rounding C B^T o L, the state and
    w o x to bf16 once moves y by far more than the two-half products."""
    BH, S, P, N, Q = SHAPES[1]
    x, dA, B, C = _inputs(BH, S, P, N, seed=BH + S, bf16=True)
    ry = np.asarray(j_ref(x, dA, B, C)[0])
    y2, _ = emulate(T(x), T(dA), T(B), T(C), Q, route=1)
    err_split = float(np.abs(y2.numpy() - ry).max())
    y1, _ = emulate(T(x), T(dA), T(B), T(C), Q, route=1, one_rounding=True)
    err_once = float(np.abs(y1.numpy() - ry).max())
    assert err_split < TOL < err_once
    assert err_once > 20 * err_split


@pytest.mark.parametrize("shape", SHAPES + [SERVE, (6, 96, 40, 24, 48),
                                            (3, 64, 8, 56, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_grid_and_warps_cover_every_piece_once(shape):
    """Every (row, 16-column slice, chunk) belongs to one CTA; in a chunk
    every query tile to one warp, every state n-tile to one warp."""
    BH, S, P, N, Q = shape
    plan = sk.launch_plan(BH, P, N, Q, torch.bfloat16)
    assert plan["route"] == 1
    slices = -(-P // sk.TC_COLS)
    assert plan["grid"] == BH * slices
    seen = {}
    for c in range(plan["grid"]):
        bh, p0 = _cta(c, BH, P)
        for c0 in range(0, S, Q):
            key = (bh, p0, c0)
            seen[key] = seen.get(key, 0) + 1
    assert sorted(seen) == sorted((bh, s * sk.TC_COLS, c0) for bh in range(BH)
                                  for s in range(slices)
                                  for c0 in range(0, S, Q))
    assert set(seen.values()) == {1}
    tiles = sorted(t for w in range(WARPS) for t in _query_tiles(w, Q))
    assert tiles == list(range(Q // 16))
    ntiles = sorted(t for w in range(WARPS) for t in _state_tiles(w, N))
    assert ntiles == list(range(sk.tc_width(N) // 8))


def test_snake_order_balances_the_causal_work_at_the_serving_chunk():
    """At Q 256 each warp runs the same number of key tiles (17)."""
    work = [sum(qt + 1 for qt in _query_tiles(w, SERVE[-1]))
            for w in range(WARPS)]
    assert work == [17] * WARPS


def test_source_constants_are_the_wrappers():
    assert _constant("kTcCols") == sk.TC_COLS
    assert _constant("kTcCtas") == sk.TC_CTAS_PER_SM
    assert _constant("kTcThreads", kTcWarps=WARPS) == sk.TC_THREADS \
        == 32 * WARPS
    assert re.search(r"__launch_bounds__\(kTcThreads, kTcCtas\)", SOURCE)
    assert f"return 16 * NK + {sk.TC_PAD};" in SOURCE
    assert "constexpr int kXStride = kTcCols + 8;" in SOURCE
    for w in sk.TC_WIDTHS:
        assert f"if (N <= {w}) return SSD_TC({w // 16});" in SOURCE


@pytest.mark.parametrize("N,Q", [(64, 256), (48, 256), (16, 32), (32, 64),
                                 (64, 512)])
def test_shared_memory_fits_the_ctas_the_launch_bound_claims(N, Q):
    """The launch bound caps registers for TC_CTAS_PER_SM CTAs (65536 / (2 *
    256) = 128 a thread); at the serving widths shared memory lets exactly
    that many stay resident, and no plan asks a block for more than it may
    use (Q 512 at N 64: one CTA an SM, or route 0 where it does not fit)."""
    plan = sk.launch_plan(320, 64, N, Q, torch.bfloat16)
    smem = sk.tc_smem_bytes(N, Q)
    assert plan["smem_bytes"] == smem
    if smem <= sk.MAX_SMEM_BYTES:
        assert plan["route"] == 1
        assert plan["ctas_per_sm"] * (smem + sk.SMEM_PER_BLOCK) \
            <= sk.SM_SMEM_BYTES
        assert 1 <= plan["ctas_per_sm"] <= sk.TC_CTAS_PER_SM
    else:
        assert plan["route"] == 0
    if (N, Q) == (64, 256):
        assert smem == 98_304
        assert plan["ctas_per_sm"] == sk.TC_CTAS_PER_SM == 2
    assert 65536 // (sk.TC_CTAS_PER_SM * sk.TC_THREADS) == 128


def test_wave_count_at_the_serving_shape_is_the_sources_note():
    """1280 CTAs in 4.85 waves of 264 on 132 SMs; the last wave holds 224
    (85 % of the slots, at least half, as the design asks)."""
    BH, S, P, N, Q = SERVE
    plan = sk.launch_plan(BH, P, N, Q, torch.bfloat16, sms=SMS)
    assert plan["route"] == 1 and plan["grid"] == 1280
    assert plan["slots"] == 264
    assert round(plan["waves"], 2) == 4.85
    assert plan["last_wave"] == 224 and plan["last_wave"] >= plan["slots"] / 2
    note = re.search(r"run in ([\d.]+) waves of (\d+) on (\d+) SMs: the last "
                     r"wave holds (\d+) CTAs \((\d+) % of the slots\)",
                     " ".join(SOURCE.replace("//", " ").split()))
    assert note, "the source's wave note is missing"
    waves, slots, sms, last, share = note.groups()
    assert float(waves) == round(plan["waves"], 2)
    assert (int(slots), int(sms), int(last)) == (plan["slots"], SMS,
                                                 plan["last_wave"])
    assert int(share) == round(100 * plan["last_wave"] / plan["slots"])


@pytest.mark.parametrize("dtype,P,N,Q,aligned,route", [
    (torch.bfloat16, 64, 64, 256, True, 1),
    (torch.bfloat16, 16, 8, 16, True, 1),
    (torch.float32, 64, 64, 256, True, 0),     # no exact f32 tensor product
    (torch.bfloat16, 12, 64, 256, True, 0),    # P not a multiple of 8
    (torch.bfloat16, 64, 20, 256, True, 0),    # N not a multiple of 8
    (torch.bfloat16, 64, 128, 256, True, 0),   # wider than TC_WIDTHS
    (torch.bfloat16, 64, 64, 24, True, 0),     # Q not a multiple of 16
    (torch.bfloat16, 64, 64, 256, False, 0),   # rows not 16-byte aligned
])
def test_route_choice(dtype, P, N, Q, aligned, route):
    assert sk.launch_plan(8, P, N, Q, dtype, aligned=aligned)["route"] == route
