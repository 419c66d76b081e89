"""The launch plan of the copy kernel (``csrc/copy.cu``), on the CPU.

copy.cu walks the same vector blocks as acc.cu (``csrc/walk.cuh``) and runs
one of two grid shapes, which ``membench.copy_launch_plan`` picks by its two
buffers against the L2.  These tests walk the plan's grid as the kernel
does and check that every 16-byte vector is read and written exactly once
per pass (each position's loads and stores go to the same offsets), on both
shapes and at the threshold, with the sequential and the interleaved walks;
and that the plan's constants are the source's."""
import numpy as np
import pytest
import torch

from _vector_walk import positions_of_a_pass, source_constant
from repro_torch.kernels.membench import membench as mb

KiB, MiB, GiB = 2**10, 2**20, 2**30
SOURCE = (mb.CSRC / "copy.cu").read_text()
L2 = 50 * MiB


@pytest.mark.parametrize("rows,block_rows,streams", [
    (64, 64, 1), (256, 8, 1), (256, 8, 4), (1024, 128, 1), (1024, 64, 2),
    (4096, 128, 8),
])
@pytest.mark.parametrize("interleave", [1, 2, 4])
@pytest.mark.parametrize("l2", [4 * KiB, 2 * 256 * 128 * 4, 8 * MiB])
@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_vector_copied_once_per_pass(rows, block_rows, streams,
                                           interleave, l2, sms, dtype):
    """l2 below, at and above the two buffers (a working set of exactly
    the L2 stays persistent)."""
    esize = torch.empty((), dtype=dtype).element_size()
    tile_bytes = block_rows * mb.LANES * esize
    n_tiles = rows // block_rows
    plan = mb.copy_launch_plan(n_tiles, tile_bytes, interleave, sms, l2)
    assert plan["shape"] == (1 if 2 * n_tiles * tile_bytes > l2 else 0)
    vecs = (mb.COPY_NP if plan["shape"] else mb.COPY_WIN)[1]
    _, _, vectors = positions_of_a_pass(plan, n_tiles, tile_bytes // 16,
                                        streams, interleave, vecs)
    # copy_positions stores to the offsets it loaded from
    assert np.array_equal(np.sort(vectors), np.arange(n_tiles * tile_bytes
                                                      // 16))


@pytest.mark.parametrize("nbytes,shape", [
    (32 * KiB, 0), (1 * MiB, 0), (16 * MiB, 0), (25 * MiB, 0),
    (32 * MiB, 1), (64 * MiB, 1), (256 * MiB, 1), (2 * GiB, 1),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threshold_at_the_l2(nbytes, shape, dtype):
    """The two buffers against the 50 MiB L2: 16 MiB (32 MiB of buffers)
    stays persistent, 32 MiB and above go non-persistent."""
    esize = torch.empty((), dtype=dtype).element_size()
    rows = nbytes // (mb.LANES * esize)
    br = mb.default_block_rows(rows)
    plan = mb.copy_launch_plan(rows // br, br * mb.LANES * esize, 1, 132,
                               L2)
    assert plan["shape"] == shape
    vecs = nbytes // 16
    if shape == 1:
        assert plan["grid"] * plan["block"] >= vecs
        assert (plan["grid"] - 1) * plan["block"] < vecs
    else:
        assert plan["grid"] == min(-(-vecs // plan["block"]),
                                   mb.COPY_WIN[2] * 132)


def test_plan_constants_are_the_sources():
    assert (source_constant(SOURCE, "kCopyWinThreads"),
            source_constant(SOURCE, "kCopyWinVecs"),
            source_constant(SOURCE, "kCopyWinCtas")) == mb.COPY_WIN
    assert (source_constant(SOURCE, "kCopyNpThreads"),
            source_constant(SOURCE, "kCopyNpVecs")) == mb.COPY_NP
    assert "kCopyWinThreads, kCopyWinVecs" in SOURCE
    assert "kCopyNpThreads, kCopyNpVecs" in SOURCE
    # interleave >= 4 is compiled for half the persistent CTAs, planned so
    assert "__launch_bounds__(THREADS, K >= 4 ? CTAS / 2 : CTAS)" in SOURCE
    for k, ctas in ((8, mb.COPY_WIN[2] // 2), (4, mb.COPY_WIN[2] // 2),
                    (2, mb.COPY_WIN[2])):
        plan = mb.copy_launch_plan(256, 64 * KiB, k, 132, L2)
        assert plan["shape"] == 0 and plan["grid"] == ctas * 132
    # the stores stay volatile inline PTX (no pass's stores merged)
    assert "st16(out + off" in SOURCE

