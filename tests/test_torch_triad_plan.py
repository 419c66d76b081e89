"""The launch plan of the triad kernel (``csrc/triad.cu``), on the CPU.

triad.cu cuts the tile walk into blocks of consecutive 16-byte vectors
(vector q of the walk is vector q % tile_vecs of tile walk_tile(q //
tile_vecs)) and runs one of two grid shapes, which
``membench.triad_launch_plan`` picks by the working set against the L2:
above it a non-persistent grid (one block per ``TRIAD_NP_THREADS`` vectors,
the pass the slow grid dimension), at and below it a persistent grid (each
resident CTA takes blocks c, c + G, ... of 256 vectors in every pass).
These tests walk the plan's grid as the kernel does and check that every
16-byte vector of every tile is read and written exactly once per pass, on
both sides of the threshold and at it, with the sequential and the
interleaved tile walks; and that the plan's constants are the source's."""
import re

import pytest
import torch

from repro_torch.kernels.membench import membench as mb

KiB, MiB, GiB = 2**10, 2**20, 2**30
SOURCE = (mb.CSRC / "triad.cu").read_text()
L2 = 50 * MiB                    # an H100's L2 (L2_cache_size)


def _walk_tile(step: int, streams: int, seg: int) -> int:
    return (step % streams) * seg + step // streams


def _vectors_of_a_pass(plan: dict, n_tiles: int, tile_vecs: int,
                       streams: int) -> list[int]:
    """Every vector (tile * tile_vecs + i) the kernel touches in one pass,
    in the order the grid's blocks and CTAs are numbered."""
    total = n_tiles * tile_vecs
    seg = n_tiles // streams
    per = plan["block_vecs"]
    blocks = -(-total // per)
    if plan["shape"] == 1:
        assert plan["grid"] == blocks
        owners = [[blk] for blk in range(blocks)]
    else:
        owners = [list(range(c, blocks, plan["grid"]))
                  for c in range(plan["grid"])]
    seen = []
    for blks in owners:
        for blk in blks:
            for t in range(per):
                q = blk * per + t
                if q < total:
                    step, i = divmod(q, tile_vecs)
                    seen.append(_walk_tile(step, streams, seg) * tile_vecs
                                + i)
    return seen


@pytest.mark.parametrize("rows,block_rows,streams", [
    (64, 64, 1), (256, 8, 1), (256, 8, 4), (1024, 128, 1), (1024, 64, 2),
    (4096, 128, 8),
])
@pytest.mark.parametrize("l2", [4 * KiB, 3 * 256 * 128 * 4, 8 * MiB])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_vector_once_per_pass(rows, block_rows, streams, l2, dtype):
    """l2 below, at and above the working set (the threshold is strict:
    three buffers of exactly the L2 stay persistent)."""
    esize = torch.empty((), dtype=dtype).element_size()
    tile_bytes = block_rows * mb.LANES * esize
    n_tiles = rows // block_rows
    tile_vecs = tile_bytes // 16
    plan = mb.triad_launch_plan(n_tiles, tile_bytes, 132, l2)
    working = 3 * n_tiles * tile_bytes
    assert plan["shape"] == (1 if working > l2 else 0)
    seen = _vectors_of_a_pass(plan, n_tiles, tile_vecs, streams)
    assert sorted(seen) == list(range(n_tiles * tile_vecs))


@pytest.mark.parametrize("nbytes,shape", [
    (32 * KiB, 0), (1 * MiB, 0), (16 * MiB, 0), (17 * MiB, 1),
    (256 * MiB, 1), (2 * GiB, 1),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threshold_at_the_l2(nbytes, shape, dtype):
    """The sizes the bench runs: 16 MiB (48 MiB of buffers) is inside the
    50 MiB L2 and keeps the persistent pass loop; 17 MiB (51 MiB), 256 MiB
    and 2 GiB go non-persistent.  Non-persistent blocks cover the buffer;
    the persistent grid is at most TRIAD_WIN_CTAS CTAs an SM and no more
    CTAs than blocks."""
    esize = torch.empty((), dtype=dtype).element_size()
    rows = nbytes // (mb.LANES * esize)
    br = mb.default_block_rows(rows)
    n_tiles = rows // br
    plan = mb.triad_launch_plan(n_tiles, br * mb.LANES * esize, 132, L2)
    assert plan["shape"] == shape
    vecs = nbytes // 16
    if shape == 1:
        assert plan["grid"] * plan["block_vecs"] >= vecs
        assert (plan["grid"] - 1) * plan["block_vecs"] < vecs
        assert plan["grid"] <= 2**31 - 1
    else:
        assert 1 <= plan["grid"] <= mb.TRIAD_WIN_CTAS * 132
        assert plan["grid"] <= -(-vecs // plan["block_vecs"])


def test_plan_constants_are_the_sources():
    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
        assert m, name
        return int(m.group(1))
    assert const("kTriadNpThreads") == mb.TRIAD_NP_THREADS
    assert const("kTriadWinCtas") == mb.TRIAD_WIN_CTAS
    assert "__launch_bounds__(kTriadNpThreads)" in SOURCE
    assert "__launch_bounds__(kThreads, kTriadWinCtas)" in SOURCE
    # the persistent grid fills the SM's 2048 threads and no more
    assert mb.TRIAD_WIN_CTAS * 256 == 2048
    assert mb.TRIAD_NP_THREADS <= 1024
