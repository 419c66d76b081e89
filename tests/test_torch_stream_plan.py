"""The launch plan of the R:W kernel (``csrc/rw.cu``), on the CPU.

rw.cu is compiled for ``kRwCtas`` resident CTAs of 256 threads an SM
(``__launch_bounds__``, which holds a thread to 65536 / (kRwCtas * 256)
registers) and keeps ``kRwVecs[R]`` 16-byte vectors of each of its R read
streams in flight a thread.  The wrapper launches ``grid_size`` CTAs.  These
tests hold the two together: the grid the wrapper asks for is resident at
once (no second wave of CTAs), the in-flight vectors fit the register budget
the launch bound leaves, and the in-flight depth is a power of two (the
interleaved walk of ``csrc/stream.cuh`` splits it over the row chunks)."""
import re

import pytest
import torch

from repro_torch.core.buffers import working_set_shape
from repro_torch.kernels.membench import membench as mb

KiB, MiB, GiB = 2**10, 2**20, 2**30
MAX_THREADS_PER_SM = 2048
REGISTERS_PER_SM = 65536
THREADS = 256
RW_SOURCE = (mb.CSRC / "rw.cu").read_text()


def _constant(name: str) -> str:
    m = re.search(rf"constexpr int {name}(?:\[[^\]]*\])? = ([^;]+);",
                  RW_SOURCE)
    assert m, f"{name} not found in rw.cu"
    return m.group(1)


def _rw_ctas() -> int:
    return int(_constant("kRwCtas"))


def _rw_vecs() -> list[int]:
    return [int(v) for v in _constant("kRwVecs").strip("{}").split(",")]


def test_launch_bound_is_the_grid_plan():
    assert _rw_ctas() == mb.CTAS_PER_SM
    assert mb.CTAS_PER_SM * THREADS <= MAX_THREADS_PER_SM


@pytest.mark.parametrize("reads", range(1, mb.MAX_RW + 1))
def test_in_flight_vectors_fit_the_register_budget(reads):
    vecs = _rw_vecs()
    assert len(vecs) == mb.MAX_RW + 1
    v = vecs[reads]
    assert v >= 1 and v & (v - 1) == 0
    budget = REGISTERS_PER_SM // (_rw_ctas() * THREADS)
    # four 32-bit registers a 16-byte vector, and at least a quarter of the
    # budget left for addresses, the fold and the loop
    assert 4 * v * reads <= budget * 3 // 4


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("nbytes", [32 * KiB, 1 * MiB, 16 * MiB, 256 * MiB,
                                    2 * GiB])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_is_resident_at_once(nbytes, dtype, sms, monkeypatch):
    rows, _ = working_set_shape(nbytes, dtype)
    n_tiles = rows // mb.default_block_rows(rows)
    monkeypatch.setattr(mb, "sm_count", lambda device: sms)
    grid = mb.grid_size(n_tiles, "cuda:0")
    assert 1 <= grid <= n_tiles
    assert grid <= _rw_ctas() * sms
