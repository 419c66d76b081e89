// The vector-block walk of acc.cu and copy.cu.
//
// A pass over n_tiles tiles of tile_vecs 16-byte vectors is cut into
// positions: with interleave = K a tile has nv = tile_vecs / K columns, and
// position q of the pass is column q % nv of walk step q / nv, i.e. of tile
// walk_tile(q / nv) (so `streams` stays the address order of the tiles).  A
// position stands for the K vectors col, nv + col, ... of its tile, one in
// each of the K row chunks (K = 1: vector q of the walk).  Blocks of THREADS x
// V consecutive positions are the unit of work: thread t of a block takes its
// positions t, t + THREADS, ... (V of them).  Two grid shapes take the
// blocks (membench.acc_launch_plan / copy_launch_plan pick one):
//
//  * persistent (the working set fits the L2): G resident CTAs, CTA c takes
//    blocks c, c + G, ... in every pass, so a CTA reads the same vectors in
//    every pass and reuse across passes is what a many-pass call measures;
//  * non-persistent (above the L2): one CTA a block, in address order, the
//    pass the slow grid dimension (blockIdx.y).
#pragma once

#include "membench_common.cuh"

namespace mb {

// a position as (step, col) = divmod(q, nv); the persistent loop advances
// it by a fixed stride without dividing
struct Pos {
  int step, col;
  __device__ __forceinline__ void set(long long q, int nv) {
    if (q <= 0x7fffffffLL) {               // a 32-bit division, far cheaper
      step = (int)((unsigned)q / (unsigned)nv);
      col = (int)q - step * nv;
    } else {
      step = (int)(q / nv);
      col = (int)(q - (long long)step * nv);
    }
  }
  __device__ __forceinline__ void add(const Pos& d, int nv) {
    step += d.step;
    col += d.col;
    if (col >= nv) { col -= nv; ++step; }
  }
};

struct VecWalk {
  int n_tiles, tile_vecs, nv, streams, seg;
  __device__ __forceinline__ VecWalk(int n_tiles_, int tile_vecs_,
                                     int streams_, int k)
      : n_tiles(n_tiles_), tile_vecs(tile_vecs_), nv(tile_vecs_ / k),
        streams(streams_), seg(n_tiles_ / streams_) {}
  // positions a pass
  __device__ __forceinline__ long long positions() const {
    return (long long)n_tiles * nv;
  }
  __device__ __forceinline__ bool valid(const Pos& p) const {
    return p.step < n_tiles;
  }
  // byte offset of the position's first vector (chunk j: + j * chunk())
  __device__ __forceinline__ size_t offset(const Pos& p) const {
    const long long tile = streams == 1 ? p.step
                                        : walk_tile(p.step, streams, seg);
    return ((size_t)tile * tile_vecs + p.col) * 16;
  }
  __device__ __forceinline__ size_t chunk() const { return (size_t)nv * 16; }
};

// The positions a thread of a persistent CTA takes in each pass: those of
// blocks c, c + G, ...; `first` is reset at every pass, `stride` = G blocks.
// Where a pass has no more blocks than the grid has CTAs (`fixed`), a CTA
// takes at most one block, and a thread the same V positions, in every
// pass: the kernels then work out their addresses once and issue a pass's
// loads before the previous pass's values are used (the passes of a small
// buffer are otherwise each one load latency long).
template <int THREADS, int V>
struct WinCursor {
  static constexpr int B = THREADS * V;
  Pos first[V], stride;
  long long blocks;
  __device__ __forceinline__ static long long blocks_of(const VecWalk& w) {
    return (w.positions() + B - 1) / B;
  }
  __device__ __forceinline__ static bool fixed(const VecWalk& w) {
    return blocks_of(w) <= gridDim.x;
  }
  __device__ __forceinline__ WinCursor(const VecWalk& w) {
    blocks = blocks_of(w);
    stride.set((long long)gridDim.x * B, w.nv);
#pragma unroll
    for (int k = 0; k < V; ++k)
      first[k].set((long long)blockIdx.x * B + k * THREADS + threadIdx.x,
                   w.nv);
  }
};

// the positions of block blockIdx.x for one thread (non-persistent shape)
template <int THREADS, int V>
__device__ __forceinline__ void np_positions(const VecWalk& w, Pos (&p)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k)
    p[k].set((long long)blockIdx.x * (THREADS * V) + k * THREADS +
                 threadIdx.x, w.nv);
}

// loads issued one pass ahead while they take at most 8 registers (twice:
// this pass's values and the next's); with more a thread has that many
// loads in flight already
template <int V, int K>
constexpr bool kAhead = V * K <= 2;

// blocks whose loads a thread issues together in the persistent loop: as
// many as keep its vectors in flight at 4 (at least one block)
template <int V, int K>
constexpr int walk_group = V * K >= 4 ? 1 : 4 / (V * K);

}  // namespace mb
