"""The tensor-core design of the SSD kernel (routes 1 and 2 of
``csrc/ssd_scan.cu``) and its launch plan, on the CPU.

The kernel runs only on the card (``chip_smoke.py`` phase 2c).  Here its
arithmetic is emulated in plain PyTorch along its own decomposition -- CTAs
of (row, 16 columns of P) on route 1 and (row, 32 columns) on route 2 from
the grid the wrapper plans, B and C rows read through the layout the
wrapper passes (per head, or one group's rows with stride 0 over its
heads), chunks walked in order with the state carried in float32, query
tiles of 16 dealt to the warps in snake order, key tiles at or below the
diagonal, state columns in n-tiles of 8 owned by warps (one a warp on
route 1 and on route 2 at width 64, two on route 2 at width 128) -- with
its roundings: every product takes bf16
operands and sums in float32, and a float32 operand (C B^T o L, the state,
w o x) enters as two bf16 halves, hi = bf16(a) and lo = bf16(a - hi).  The
emulation is held against the JAX package's recurrence oracle and its
Pallas kernel in interpret mode at the reference's test shapes and at
N 128.  Float32 inputs take route 0 (float32 FMAs), emulated along the same
decomposition without the splits.  The launch plan is held against the
constants and the notes of the source: coverage, shared memory against the
CTAs an SM the launch bound claims, and the wave counts at the serving
shapes."""
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
#: mamba2-2.7b's prefill shape (d_state 128): route 2
SERVE_MAMBA2 = (4 * 80, 512, 64, 128, 256)
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


def _cols(route: int) -> int:
    """Columns of P a CTA of a tensor-core route owns."""
    return sk.WIDE_COLS if route == 2 else sk.TC_COLS


def _cta(c: int, BH: int, P: int, route: int = 1) -> tuple[int, int]:
    """CTA c of a tensor-core route's grid -> (row bh, first column p0):
    the column slices of one row are neighbours (blockIdx.x % slices)."""
    cols = _cols(route)
    slices = -(-P // cols)
    return c // slices, (c % slices) * cols


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


def _state_tiles(warp: int, N: int, route: int = 1) -> list[int]:
    """The n-tiles of 8 state columns warp ``warp`` owns (N padded up):
    tile ``warp`` on route 1; on route 2 NTW = width / 64 tiles from NTW
    warp (tiles 2 warp and 2 warp + 1 at width 128)."""
    if route == 2:
        per = sk.wide_width(N) // (8 * WARPS)
        return [per * warp + i for i in range(per)]
    nt = sk.tc_width(N) // 8
    return [t for t in range(warp, nt, WARPS)]


def _bc_row(m: torch.Tensor, bh: int) -> torch.Tensor:
    """Row bh of B or C as the kernel reads it: a (BH, S, N) tensor's row,
    or of a (B, H, S, N) view the outer index bh / H and the inner bh % H
    (``_bc_layout``'s heads)."""
    if m.ndim == 3:
        return m[bh]
    heads = sk._bc_layout(m, "m", m.shape[0] * m.shape[1], m.shape[2],
                          m.shape[3])[0]
    return m[bh // heads, bh % heads]


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
    (bf16 values on routes 1 and 2); B and C (BH, S, N), or (B, H, S, N)
    views with B * H = BH.  ``one_rounding``: the float32 operands rounded
    to bf16 once instead of split (what the kernel must not do)."""

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
    for c in range(plan["grid"]):
        bh, p0 = _cta(c, BH, P, route) if route else (c, 0)
        cols = slice(p0, min(p0 + (_cols(route) if route else P), P))
        st = torch.zeros(N, cols.stop - cols.start)
        for c0 in range(0, S, Q):
            c2 = torch.cumsum(dA[bh, c0:c0 + Q], 0) * LOG2E
            w = torch.exp2(c2[-1] - c2)
            Cc, Bc = _bc_row(C, bh)[c0:c0 + Q], _bc_row(B, bh)[c0:c0 + Q]
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
                for nt in _state_tiles(warp, N, route):
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


#: N 128 (mamba2's d_state), a width route 2 pads (N 96, P 40: a ragged
#: column slice) and route 2 at width 64 (N 48, padded, P 16: a chunk of 656
#: route 1 cannot stage), at small sizes: (BH, S, P, N, Q)
WIDE_SHAPES = [(2, 128, 32, 128, 32), (2, 256, 64, 128, 64),
               (2, 64, 40, 96, 32), (2, 656, 16, 48, 656)]


@pytest.mark.parametrize("layout", ["per_head", "stride0"])
@pytest.mark.parametrize("shape", WIDE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_wide_route_numerics_fit_the_reference(shape, layout):
    """bf16 inputs on route 2: its split products, along its
    decomposition, keep y within SSD_TOL (plus its bf16 rounding) of the
    recurrence oracle and of the Pallas kernel, and the float32 state within
    SSD_TOL; B and C per head, or one group's rows expanded over the row's
    two heads with stride 0 (as the model passes them)."""
    BH, S, P, N, Q = shape
    x, dA, B, C = _inputs(BH, S, P, N, seed=BH + S + N, bf16=True)
    if layout == "stride0":
        B, C = (jnp.broadcast_to(a[:1], a.shape) for a in (B, C))
        Bk, Ck = (T(a[:1]).unsqueeze(1).expand(1, BH, S, N) for a in (B, C))
        assert Bk.stride(1) == 0
    else:
        Bk, Ck = T(B), T(C)
    assert sk.launch_plan(BH, P, N, Q, torch.bfloat16)["route"] == 2
    y, st = emulate(T(x), T(dA), Bk, Ck, Q, route=2)
    assert bool(y.isfinite().all()) and bool(st.isfinite().all())
    ry, rst = j_ref(x, dA, B, C)
    py, pst = j_ssd_scan(x, dA, B, C, chunk=Q, interpret=True)
    out = y.to(torch.bfloat16).float()
    for want_y, want_st in ((ry, rst), (py, pst)):
        want_y, want_st = np.asarray(want_y), np.asarray(want_st)
        np.testing.assert_allclose(y.numpy(), want_y, rtol=TOL, atol=TOL)
        assert np.all(np.abs(out.numpy() - want_y)
                      <= TOL + (TOL + 2.0**-8) * np.abs(want_y))
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
                                            (3, 64, 8, 56, 64)]
                         + [SERVE_MAMBA2] + WIDE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_grid_and_warps_cover_every_piece_once(shape):
    """Every (row, column slice, chunk) belongs to one CTA (slices of 16
    columns on route 1, 32 on route 2); in a chunk every query tile to one
    warp, every state n-tile to one warp."""
    BH, S, P, N, Q = shape
    plan = sk.launch_plan(BH, P, N, Q, torch.bfloat16)
    route = 1 if N <= max(sk.TC_WIDTHS) \
        and sk.tc_smem_bytes(N, Q) <= sk.MAX_SMEM_BYTES else 2
    assert plan["route"] == route
    cols = _cols(route)
    slices = -(-P // cols)
    assert plan["grid"] == BH * slices
    seen = {}
    for c in range(plan["grid"]):
        bh, p0 = _cta(c, BH, P, route)
        for c0 in range(0, S, Q):
            key = (bh, p0, c0)
            seen[key] = seen.get(key, 0) + 1
    assert sorted(seen) == sorted((bh, s * cols, c0) for bh in range(BH)
                                  for s in range(slices)
                                  for c0 in range(0, S, Q))
    assert set(seen.values()) == {1}
    tiles = sorted(t for w in range(WARPS) for t in _query_tiles(w, Q))
    assert tiles == list(range(Q // 16))
    ntiles = sorted(t for w in range(WARPS)
                    for t in _state_tiles(w, N, route))
    width = sk.tc_width(N) if route == 1 else sk.wide_width(N)
    assert ntiles == list(range(width // 8))


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
    # route 2
    assert _constant("kWideCols") == sk.WIDE_COLS
    assert _constant("kWideCtas") == sk.WIDE_CTAS_PER_SM
    assert f"constexpr int wide_row(int WN) {{ return WN + {sk.TC_PAD}; }}" \
        in SOURCE
    assert _constant("kWideXStride", kWideCols=sk.WIDE_COLS) \
        == sk.WIDE_COLS + sk.TC_PAD
    assert re.search(r"__launch_bounds__\(kTcThreads, kWideCtas\)", SOURCE)
    for w in sk.WIDE_WIDTHS:
        assert f"if (N <= {w}) return SSD_WIDE({w});" in SOURCE
    assert "static_assert(WN == 64 || WN == 128," in SOURCE


@pytest.mark.parametrize("N,Q", [(64, 256), (48, 256), (16, 32), (32, 64),
                                 (64, 512), (128, 256), (64, 672), (64, 960)])
def test_shared_memory_fits_the_ctas_the_launch_bound_claims(N, Q):
    """The launch bounds cap registers for TC_CTAS_PER_SM (route 1) and
    WIDE_CTAS_PER_SM (route 2) CTAs (65536 / (2 * 256) = 128 a thread); at
    the serving widths shared memory lets exactly that many stay resident,
    and no plan asks a block for more than it may use (Q 512 at N 64: one
    CTA an SM; Q 672 at N 64: too long for route 1, route 2 at width 64;
    route 0 where neither fits)."""
    plan = sk.launch_plan(320, 64, N, Q, torch.bfloat16)
    route = 1 if N <= max(sk.TC_WIDTHS) \
        and sk.tc_smem_bytes(N, Q) <= sk.MAX_SMEM_BYTES else 2
    smem = sk.tc_smem_bytes(N, Q) if route == 1 \
        else sk.wide_smem_bytes(N, Q)
    bound = sk.TC_CTAS_PER_SM if route == 1 else sk.WIDE_CTAS_PER_SM
    if smem <= sk.MAX_SMEM_BYTES:
        assert plan["smem_bytes"] == smem
        assert plan["route"] == route
        assert plan["ctas_per_sm"] * (smem + sk.SMEM_PER_BLOCK) \
            <= sk.SM_SMEM_BYTES
        assert 1 <= plan["ctas_per_sm"] <= bound
    else:
        assert plan["route"] == 0 and (N, Q) == (64, 960)
    if (N, Q) == (64, 256):
        assert smem == 98_304
        assert plan["ctas_per_sm"] == sk.TC_CTAS_PER_SM == 2
    if (N, Q) == (128, 256):
        assert smem == 110_592
        assert plan["ctas_per_sm"] == sk.WIDE_CTAS_PER_SM == 2
    assert 65536 // (bound * sk.TC_THREADS) == 128


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


def test_wave_count_at_mamba2s_shape_is_the_sources_note():
    """Route 2 at mamba2's prefill shape: 640 CTAs in 2.42 waves of 264 on
    132 SMs; the last wave holds 112 (42 % of the slots)."""
    BH, S, P, N, Q = SERVE_MAMBA2
    plan = sk.launch_plan(BH, P, N, Q, torch.bfloat16, sms=SMS)
    assert plan["route"] == 2 and plan["grid"] == 640
    assert plan["slots"] == 264 and plan["last_wave"] == 112
    note = re.search(r"the (\d+) CTAs run in ([\d.]+) waves of (\d+) on "
                     r"(\d+) SMs: the last wave holds (\d+) CTAs \((\d+) % "
                     r"of the slots\)\. CTAs start",
                     " ".join(SOURCE.replace("//", " ").split()))
    assert note, "route 2's wave note is missing"
    grid, waves, slots, sms, last, share = note.groups()
    assert (int(grid), float(waves)) == (plan["grid"], round(plan["waves"],
                                                             2))
    assert (int(slots), int(sms), int(last)) == (plan["slots"], SMS,
                                                 plan["last_wave"])
    assert int(share) == round(100 * plan["last_wave"] / plan["slots"])


@pytest.mark.parametrize("N", [64, 128])
def test_the_sources_bound_notes_count_the_needed_work(N):
    """The source's bound notes (zamba2's N 64, mamba2's N 128, B and C one
    matrix a batch row of 80 heads) state ``ops.work_flops`` in GFLOP."""
    from repro_torch.kernels.ssd_scan import ops
    BH, S, P, _, Q = SERVE
    want = ops.work_flops(BH, S, P, N, Q, BH // 80) / 1e9
    note = " ".join(SOURCE.replace("//", " ").split())
    pat = (r"BH 320, S 512, P 64, N 64, Q 256, bf16 x/B/C, B and C shared "
           r"by the 80 heads of a batch row\) the function needs ([\d.]+) "
           r"GFLOP" if N == 64 else
           r"N 128, Q 256, B and C shared by the 80 heads of a batch row\): "
           r"the function needs ([\d.]+) GFLOP")
    m = re.search(pat, note)
    assert m, f"the source's bound note at N {N} is missing"
    assert float(m.group(1)) == round(want, 2)


def test_tensor_parallel_mamba2_ranks_take_route_2():
    """A rank of a ``model`` axis of 2 or 4 runs mamba2's SSD at 40 / 20 of
    its 80 heads: still route 2, one CTA pair a row."""
    for heads in (40, 20):
        plan = sk.launch_plan(4 * heads, 64, 128, 256, torch.bfloat16)
        assert plan["route"] == 2 and plan["grid"] == 4 * heads * 2


@pytest.mark.parametrize("dtype,P,N,Q,aligned,route", [
    (torch.bfloat16, 64, 64, 256, True, 1),
    (torch.bfloat16, 16, 8, 16, True, 1),
    (torch.float32, 64, 64, 256, True, 0),     # no exact f32 tensor product
    (torch.bfloat16, 12, 64, 256, True, 0),    # P not a multiple of 8
    (torch.bfloat16, 64, 20, 256, True, 0),    # N not a multiple of 8
    (torch.bfloat16, 64, 128, 256, True, 2),   # wider than TC_WIDTHS
    (torch.bfloat16, 64, 72, 256, True, 2),
    (torch.bfloat16, 64, 192, 256, True, 0),   # wider than WIDE_WIDTHS
    (torch.bfloat16, 64, 64, 672, True, 2),    # too long for route 1
    (torch.bfloat16, 64, 32, 672, True, 1),    # route 1 stages it at 32
    (torch.bfloat16, 64, 64, 960, True, 0),    # too long for route 2 too
    (torch.float32, 64, 128, 256, True, 0),
    (torch.bfloat16, 64, 128, 256, False, 0),  # rows not 16-byte aligned
    (torch.bfloat16, 64, 128, 24, True, 0),    # Q not a multiple of 16
    (torch.bfloat16, 64, 64, 24, True, 0),     # Q not a multiple of 16
    (torch.bfloat16, 64, 64, 256, False, 0),   # rows not 16-byte aligned
])
def test_route_choice(dtype, P, N, Q, aligned, route):
    assert sk.launch_plan(8, P, N, Q, dtype, aligned=aligned)["route"] == route
