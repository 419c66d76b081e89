"""The vector-block walk of ``csrc/walk.cuh`` (acc.cu, copy.cu), emulated
on the CPU with numpy, for the plan tests of both kernels.

``positions_of_a_pass`` walks a launch plan's grid as the kernels do: the
persistent shape with each thread's positions advanced by the fixed stride
of ``Pos::add`` (no division), the non-persistent one from ``Pos::set``; it
returns, for every position a thread takes in one pass, its (tile, column)
and the vectors it reads."""
import re

import numpy as np


def walk_tile(step, streams: int, seg: int):
    return (step % streams) * seg + step // streams


def _add(step, col, d_step: int, d_col: int, nv: int):
    """Pos::add: col += d.col, step += d.step, one carry."""
    col = col + d_col
    step = step + d_step
    carry = col >= nv
    return step + carry, np.where(carry, col - nv, col)


def positions_of_a_pass(plan: dict, n_tiles: int, tile_vecs: int,
                        streams: int, interleave: int, vecs: int):
    """(tiles, cols, vectors): one entry per valid position a thread takes
    in one pass (vectors: interleave of them per position, one per row
    chunk), over the whole grid of ``plan``; ``vecs`` is V, the positions a
    thread takes a block."""
    nv = tile_vecs // interleave
    threads, per = plan["threads"], plan["block"]
    assert per == threads * vecs
    seg = n_tiles // streams
    t = np.arange(threads)[None, :, None]
    k = np.arange(vecs)[None, None, :]
    grid = plan["grid"]
    if plan["shape"] == 1:
        blocks = np.arange(grid)[:, None, None]
        q = blocks * per + k * threads + t
        steps, cols = [q // nv], [q % nv]
    else:
        c = np.arange(grid)[:, None, None]
        q0 = c * per + k * threads + t
        step, col = q0 // nv, q0 % nv
        d_step, d_col = divmod(grid * per, nv)
        n_blocks = -(-n_tiles * nv // per)
        steps, cols = [], []
        for r in range(-(-n_blocks // grid)):    # the CTA's r-th block
            live = c + r * grid < n_blocks
            steps.append(np.where(live, step, n_tiles))
            cols.append(col)
            step, col = _add(step, col, d_step, d_col, nv)
    step = np.concatenate([s.ravel() for s in steps])
    col = np.concatenate([c.ravel() for c in cols])
    valid = step < n_tiles
    step, col = step[valid], col[valid]
    tiles = walk_tile(step, streams, seg)
    chunks = np.arange(interleave)[None, :] * nv
    vectors = (tiles * tile_vecs)[:, None] + chunks + col[:, None]
    return tiles, col, vectors.ravel()


def source_constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", source)
    assert m, name
    return int(m.group(1))
