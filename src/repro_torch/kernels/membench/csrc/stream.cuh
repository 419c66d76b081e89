// The pass body of the streaming membench kernel rw.cu (and of its design
// variants in tools/stream_variants.cu).
//
// A pass moves every 16-byte vector of a (rows, 128) buffer once: R read
// streams are loaded, folded into one value, and stored to W write streams.
// The buffer is cut into n_tiles tiles; with interleave = K each tile is cut
// into K row chunks of `units` vectors, and unit i of a tile is the K
// vectors c*units + i (c < K): the K chunks are walked side by side.  CTA c
// of G owns walk steps c, c+G, ... in every pass (membench_common.cuh).
//
// Each thread keeps V vectors of every read stream in flight (V x R volatile
// loads issued before the first store), then stores the V folded vectors to
// each write stream.  The loads and stores are volatile inline PTX, so none
// is deleted, merged or hoisted out of the pass loop.
#pragma once

#include "membench_common.cuh"

namespace mb {

constexpr int kMaxStreams = 8;   // R, W <= 8

// The stream pointers, passed to a kernel by value as a __grid_constant__
// parameter: the store loop indexes out[] at run time straight from the
// parameter space, without a copy to local memory.
struct StreamPtrs {
  const char* in[kMaxStreams];
  char* out[kMaxStreams];
};

// cache hints of the streaming loads and stores, as bits (rw.cu uses none;
// tools/stream_variants.cu times them): kStoreStreaming stores with
// st.global.cs (evict first: written data does not push the read streams
// out of the caches), kLoadPrefetch256 loads with ld.global.L2::256B (the L2
// fetches 256-byte blocks from memory)
constexpr int kStoreStreaming = 1;
constexpr int kLoadPrefetch256 = 2;

template <int HINT>
__device__ __forceinline__ uint4 ld16_hint(const void* p) {
  if (HINT & kLoadPrefetch256) {
    uint4 v;
    asm volatile("ld.global.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
  }
  return ld16(p);
}

template <int HINT>
__device__ __forceinline__ void st16_hint(void* p, uint4 v) {
  if (HINT & kStoreStreaming)
    asm volatile("st.global.cs.v4.u32 [%0], {%1,%2,%3,%4};"
                 :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  else
    st16(p, v);
}

// Units [a, b) of the tile at byte offset `tile`: R loads, fold, W stores
// per vector, V vectors a thread in flight.  K1: interleave is 1 (the slot
// offsets are then constants).  Otherwise a trip covers kv = min(K, V) row
// chunks and V / kv units of each.
template <int R, int V, int HINT, bool K1, typename Fold>
__device__ __forceinline__ void stream_piece(const StreamPtrs& p, int writes,
                                             size_t tile, int units, int K,
                                             int a, int b, Fold fold) {
  const int kv = K1 ? 1 : min(K, V);
  const int ksh = K1 ? 0 : __ffs(kv) - 1;
  const int per = V >> ksh;                    // units a chunk per trip
  for (int cg = 0; cg < K; cg += kv) {
    const size_t base = tile + (size_t)cg * units * 16;
    for (int i0 = a + threadIdx.x; i0 < b; i0 += per * kThreads) {
      uint4 v[V][R];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int j = (q >> ksh) * kThreads;
        const int off = (q & (kv - 1)) * units + i0 + j;
        if (i0 + j < b) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            v[q][r] = ld16_hint<HINT>(p.in[r] + base + (size_t)off * 16);
        }
      }
      uint4 o[V];
#pragma unroll
      for (int q = 0; q < V; ++q) o[q] = fold(v[q]);
#pragma unroll 1
      for (int w = 0; w < writes; ++w) {
        char* dst = p.out[w] + base;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int j = (q >> ksh) * kThreads;
          const int off = (q & (kv - 1)) * units + i0 + j;
          if (i0 + j < b) st16_hint<HINT>(dst + (size_t)off * 16, o[q]);
        }
      }
    }
  }
}

// One launch: `passes` passes over the buffer, U pass bodies a loop trip;
// CTA c of G takes the tiles at walk steps c, c+G, ... in every pass.
template <int R, int V, int HINT, int U, typename Fold>
__device__ __forceinline__ void stream_passes(const StreamPtrs& p, int writes,
                                              int n_tiles, int units, int K,
                                              int streams, int passes,
                                              Fold fold) {
  const size_t tile_bytes = (size_t)units * K * 16;
  const int seg = n_tiles / streams;
  for (int pass = 0; pass < passes; pass += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int step = blockIdx.x; step < n_tiles; step += gridDim.x) {
        const size_t tile = walk_tile(step, streams, seg) * tile_bytes;
        if (K == 1)
          stream_piece<R, V, HINT, true>(p, writes, tile, units, 1, 0, units,
                                         fold);
        else
          stream_piece<R, V, HINT, false>(p, writes, tile, units, K, 0,
                                          units, fold);
      }
      pass_barrier();
    }
  }
}

}  // namespace mb
