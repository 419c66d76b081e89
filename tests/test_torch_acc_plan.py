"""The launch plan of the accumulating kernels (``csrc/acc.cu``: load_sum,
load_only, fma), on the CPU.

acc.cu cuts the walk into blocks of consecutive positions (``csrc/walk.cuh``:
with interleave K a position is one vector in each of a tile's K row chunks)
and runs one of two grid shapes, which ``membench.acc_launch_plan`` picks by
the buffer against the L2: persistent at and below it, non-persistent (the
pass on grid.y) above it.  These tests walk the plan's grid as the kernel
does and check that every 16-byte vector of every tile is read exactly once
per pass and that load_only's element [0,0] is taken once per tile, on both
shapes and at the threshold, with the sequential and the interleaved tile
walks; that the partials scratch holds what the kernel writes; that the
main path's index walk (acc_linear) takes 32-bit indices only where every
index it forms fits them; and that the plan's constants are the source's."""
import re

import numpy as np
import pytest
import torch

from _vector_walk import positions_of_a_pass, source_constant
from repro_torch.kernels.membench import membench as mb

KiB, MiB, GiB = 2**10, 2**20, 2**30
SOURCE = (mb.CSRC / "acc.cu").read_text()
WALK = (mb.CSRC / "walk.cuh").read_text()
L2 = 50 * MiB


def _plan_and_vecs(n_tiles, tile_bytes, interleave, sms, l2):
    plan = mb.acc_launch_plan(n_tiles, tile_bytes, interleave, sms, l2)
    vecs = (mb.ACC_NP if plan["shape"] else mb.ACC_WIN)[1]
    return plan, vecs


@pytest.mark.parametrize("rows,block_rows,streams", [
    (64, 64, 1), (256, 8, 1), (256, 8, 4), (1024, 128, 1), (1024, 64, 2),
    (4096, 128, 8),
])
@pytest.mark.parametrize("interleave", [1, 2, 4])
@pytest.mark.parametrize("l2", [4 * KiB, 256 * 128 * 4, 8 * MiB])
@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_vector_once_per_pass(rows, block_rows, streams, interleave,
                                    l2, sms, dtype):
    """l2 below, at and above the buffer (the threshold is inclusive: a
    buffer of exactly the L2 stays persistent); one SM makes the persistent
    CTAs take many blocks each (the stride walk of Pos::add)."""
    esize = torch.empty((), dtype=dtype).element_size()
    tile_bytes = block_rows * mb.LANES * esize
    n_tiles = rows // block_rows
    tile_vecs = tile_bytes // 16
    plan, vecs = _plan_and_vecs(n_tiles, tile_bytes, interleave, sms, l2)
    assert plan["shape"] == (1 if n_tiles * tile_bytes > l2 else 0)
    if interleave == 1:
        # a long fma chain walks the persistent grid whatever the L2
        fma = mb.acc_launch_plan(n_tiles, tile_bytes, 1, sms, l2,
                                 mb.FMA_PERSISTENT_PER_BYTE)
        _, _, fvec = positions_of_a_pass(fma, n_tiles, tile_vecs, streams,
                                         1, mb.ACC_WIN[1])
        assert fma["shape"] == 0
        assert np.array_equal(np.sort(fvec), np.arange(n_tiles * tile_vecs))
    tiles, cols, vectors = positions_of_a_pass(plan, n_tiles, tile_vecs,
                                               streams, interleave, vecs)
    assert np.array_equal(np.sort(vectors), np.arange(n_tiles * tile_vecs))
    if interleave == 1:
        # load_only: element [0,0] is the column-0 position of each tile
        assert np.array_equal(np.sort(tiles[cols == 0]), np.arange(n_tiles))


@pytest.mark.parametrize("nbytes,shape", [
    (32 * KiB, 0), (1 * MiB, 0), (16 * MiB, 0), (50 * MiB, 0),
    (64 * MiB, 1), (256 * MiB, 1), (2 * GiB, 1),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threshold_at_the_l2(nbytes, shape, dtype):
    """One buffer against the 50 MiB L2: up to 50 MiB persistent, 64 MiB
    and above non-persistent.  The persistent grid is at most
    ACC_WIN[2] CTAs an SM and no more CTAs than blocks (a 32 KiB buffer,
    one tile, spans 8 CTAs); non-persistent blocks cover the buffer once."""
    esize = torch.empty((), dtype=dtype).element_size()
    rows = nbytes // (mb.LANES * esize)
    br = mb.default_block_rows(rows)
    n_tiles = rows // br
    plan = mb.acc_launch_plan(n_tiles, br * mb.LANES * esize, 1, 132, L2)
    assert plan["shape"] == shape
    vecs = nbytes // 16
    if shape == 1:
        assert plan["grid"] * plan["block"] >= vecs
        assert (plan["grid"] - 1) * plan["block"] < vecs
        assert plan["grid"] <= 2**31 - 1
    else:
        assert 1 <= plan["grid"] <= mb.ACC_WIN[2] * 132
        assert plan["grid"] == min(-(-vecs // plan["block"]),
                                   mb.ACC_WIN[2] * 132)
    if nbytes == 32 * KiB and dtype == torch.float32:
        assert plan["grid"] == 8
    # a depth-8 fma chain keeps the persistent grid at every size in
    # bfloat16 (4 links a byte), not in float32 (2 a byte)
    fma = mb.acc_launch_plan(n_tiles, br * mb.LANES * esize, 1, 132, L2,
                             8 / esize)
    assert fma["shape"] == (shape if esize == 4 else 0)
    if fma["shape"] == 0:
        assert fma["grid"] == min(-(-vecs // fma["block"]),
                                  mb.ACC_WIN[2] * 132)


@pytest.mark.parametrize("shape_bytes,passes", [(32 * KiB, 2048),
                                                (2 * GiB, 8)])
def test_partials_scratch(shape_bytes, passes):
    """The scratch holds one partial a CTA (persistent) or per block and
    pass (non-persistent: 131072 a pass at 2 GiB float32), then the first
    fold stage's ceil(n / FOLD_CHUNK) sums."""
    rows = shape_bytes // (mb.LANES * 4)
    br = mb.default_block_rows(rows)
    plan = mb.acc_launch_plan(rows // br, br * mb.LANES * 4, 1, 132, L2)
    n = plan["grid"] * (passes if plan["shape"] else 1)
    assert mb.acc_scratch(plan, passes) == n + -(-n // mb.FOLD_CHUNK)
    if plan["shape"]:
        assert plan["grid"] == 131072


def test_plan_constants_are_the_sources():
    assert (source_constant(SOURCE, "kAccWinThreads"),
            source_constant(SOURCE, "kAccWinVecs"),
            source_constant(SOURCE, "kAccWinCtas")) == mb.ACC_WIN
    assert (source_constant(SOURCE, "kAccNpThreads"),
            source_constant(SOURCE, "kAccNpVecs")) == mb.ACC_NP
    assert source_constant(SOURCE, "kAccNpThreads") \
        * source_constant(SOURCE, "kAccNpCtas") <= 2048
    assert source_constant(SOURCE, "kFoldChunk") == mb.FOLD_CHUNK
    # the entry launches the shapes the plan describes
    assert "kAccWinThreads, kAccWinVecs, kAccWinCtas" in SOURCE
    assert "kAccNpThreads, kAccNpVecs, kAccNpCtas" in SOURCE
    # interleave >= 4 is compiled for half the persistent CTAs, planned so
    assert "__launch_bounds__(THREADS, K >= 4 ? CTAS / 2 : CTAS)" in SOURCE
    for k, ctas in ((8, mb.ACC_WIN[2] // 2), (4, mb.ACC_WIN[2] // 2),
                    (2, mb.ACC_WIN[2])):
        plan = mb.acc_launch_plan(256, 64 * KiB, k, 132, L2)
        assert plan["shape"] == 0 and plan["grid"] == ctas * 132


@pytest.mark.parametrize("interleave", [1, 8])
@pytest.mark.parametrize("shape", ["win", "np"])
def test_resources_fit_an_sm(shape, interleave):
    """The persistent grid's CTAs are resident at once (threads and the
    load_only ring's shared memory), and the loads of a thread (V positions
    of K vectors) fit the register budget its launch bound leaves, with at
    least a quarter of it for addresses, the sums and the loop: the
    persistent kernel is bound to the plan's CTAs an SM (half of them at
    K >= 4), the non-persistent one to kAccNpCtas (one where a thread holds
    more than 4 vectors)."""
    stages = source_constant(SOURCE, "kLoadOnlyStages")
    if shape == "win":
        threads, vecs, ctas = mb._win(mb.ACC_WIN, interleave)
        ring = min(stages, 2048 // threads) * threads * 16
    else:
        (threads, vecs) = mb.ACC_NP
        # the launch bound asks for kAccNpCtas CTAs where V x K <= 4 vectors
        ctas = (source_constant(SOURCE, "kAccNpCtas")
                if vecs * interleave <= 4 else 1)
        ring = min(vecs, 2048 // threads) * threads * 16
    assert threads * ctas <= 2048 and threads % 32 == 0
    assert ring <= 48 * KiB and ctas * ring <= 227 * KiB
    budget = min(255, 65536 // (threads * ctas))
    assert 4 * vecs * interleave <= budget * 3 // 4


def _linear_fits_int():
    """acc.cu's linear_fits_int(n, grid, block, r), from its source."""
    m = re.search(r"bool linear_fits_int\([^)]*\)\s*\{\s*return ([^;]+);",
                  SOURCE)
    assert m
    expr = m.group(1).replace("LL", "")
    return lambda n, grid, block, r: eval(          # noqa: S307
        expr, {}, {"n": n, "grid": grid, "block": block, "r": r})


def _largest_linear_index(n: int, grid: int, threads: int, vecs: int,
                          r: int) -> int:
    """The largest index acc_linear forms over a pass of n vectors: thread
    q0 of the grid's span takes q = q0, q0 + span r, ... and stops at the
    first q >= n; every index of an iteration (q + (i / V) span + (i % V)
    THREADS, i < r V) lies below the next q."""
    span = grid * threads * vecs
    q0 = np.arange(span, dtype=np.int64)
    step = span * r
    return int((q0 + np.maximum(0, -(-(n - q0) // step)) * step).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_walk_indices_fit_their_type(dtype):
    """acc_linear (interleave 1, streams 1, more blocks a pass than CTAs)
    indexes with int where linear_fits_int says so.  A long fma chain (4
    links a byte: bfloat16 at depth 8, float32 at 16) stays persistent at
    any size, so an 80 GB card holds
    buffers whose ~2**31 vectors reach the boundary: there every index the
    walk forms must fit the type it picked, and a pass of fewer than 2**31
    vectors whose walk passes 2**31 - 1 must not take int."""
    int_max = 2**31 - 1
    threads, vecs, _ = mb.ACC_WIN
    assert "walk_group = V * K >= 4 ? 1 : 4 / (V * K)" in WALK
    r = 1 if vecs >= 4 else 4 // vecs
    rule = _linear_fits_int()
    esize = torch.empty((), dtype=dtype).element_size()
    tile_bytes = mb.default_block_rows(2**30) * mb.LANES * esize
    tile_vecs = tile_bytes // 16
    grid = mb.ACC_WIN[2] * 132
    edge = (int_max - grid * threads * vecs * r) // tile_vecs
    picked = []
    for n_tiles in (edge - 1, edge, edge + 1, int_max // tile_vecs):
        plan = mb.acc_launch_plan(n_tiles, tile_bytes, 1, 132, L2,
                                  mb.FMA_PERSISTENT_PER_BYTE)
        assert (plan["shape"], plan["grid"], plan["block"]) == \
            (0, grid, threads * vecs)
        n = n_tiles * tile_vecs
        assert n <= int_max
        fits = rule(n, grid, threads * vecs, r)
        largest = _largest_linear_index(n, grid, threads, vecs, r)
        if fits:
            assert largest <= int_max
        picked.append((fits, largest > int_max))
    # both sides of the boundary are reached, and near it a pass of fewer
    # than 2**31 vectors forms indices past 2**31 - 1 (long long there)
    assert (True, False) in picked and (False, True) in picked
