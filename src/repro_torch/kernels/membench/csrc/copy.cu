// STREAM-copy membench kernel: out[tile] = x[tile], once per pass.
//
// Replaces _copy_kernel of src/repro/kernels/membench/membench.py.  With
// interleave = K each position of the walk stands for one vector in each of
// the tile's K row chunks, copied as K independent load/store streams (K
// loads in flight, then K stores).
//
// Bound on an H100: bytes (each byte read once and written once per pass).
// The design (walk.cuh): the walk is cut into blocks of consecutive 16-byte
// vectors, every load of a block issued before the first store, so that a
// small buffer spans many SMs (a CTA that owned whole tiles copied a 32 KiB
// buffer, one tile, alone).  Two grid shapes, picked by the wrapper from the
// two buffers against the L2 (membench.copy_launch_plan):
//
//  * at and below the L2: persistent, kCopyWinCtas CTAs of kCopyWinThreads
//    an SM, the pass loop inside, each thread copying the same vectors in
//    every pass; a thread issues the loads of several of its blocks (or the
//    next pass's, where it has one) before it stores any (copy_fixed);
//  * above it: non-persistent, one CTA of kCopyNpThreads per block in
//    address order, the pass on grid.y, as csrc/triad.cu does there.
//
// The copy moves bytes, so one kernel serves every element type.  Each pass
// rewrites the same output with the same values; the stores are volatile
// inline PTX, so no pass's stores are merged away.  The reference carries one
// output slot per unrolled sweep only to keep XLA from narrowing the sweeps;
// one output buffer is enough here.
#include "walk.cuh"

namespace mb {

// the grid shapes (mirrored by membench.COPY_* and checked against it by
// tests/test_torch_copy_plan.py)
constexpr int kCopyWinThreads = 256;  // persistent: threads a CTA
constexpr int kCopyWinVecs = 1;       // persistent: positions a thread a block
constexpr int kCopyWinCtas = 4;       // persistent: resident CTAs an SM
constexpr int kCopyNpThreads = 256;   // non-persistent: threads a CTA
constexpr int kCopyNpVecs = 1;        // non-persistent: positions a thread

// one thread's V positions of one block: V x K loads, then V x K stores
template <int K, int V>
__device__ __forceinline__ void copy_positions(const char* x, char* out,
                                               const VecWalk& w,
                                               const Pos (&p)[V]) {
  uint4 r[V][K];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (!w.valid(p[k])) continue;
    const size_t off = w.offset(p[k]);
#pragma unroll
    for (int j = 0; j < K; ++j) r[k][j] = ld16(x + off + j * w.chunk());
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (!w.valid(p[k])) continue;
    const size_t off = w.offset(p[k]);
#pragma unroll
    for (int j = 0; j < K; ++j)                 // K separate store streams
      st16(out + off + j * w.chunk(), r[k][j]);
  }
}

// the persistent loop where a thread has the same positions in every pass
// (WinCursor::fixed): addresses worked out once, each pass's loads issued
// before the previous pass's stores
template <int U, int K, int V>
__device__ __forceinline__ void copy_fixed(const char* x, char* out,
                                           const VecWalk& w,
                                           const Pos (&p)[V], int passes) {
  constexpr bool ahead = kAhead<V, K>;
  size_t off[V];
  bool ok[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ok[k] = w.valid(p[k]);
    off[k] = ok[k] ? w.offset(p[k]) : 0;
  }
  uint4 r[V][K], nxt[V][K];
  auto load = [&](uint4 (&v)[V][K]) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (ok[k]) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          v[k][j] = ld16(x + off[k] + j * w.chunk());
      }
  };
  if (ahead) load(r);
  for (int q = 0; q < passes; q += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ahead) load(r);
      else if (q + u + 1 < passes) load(nxt);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (!ok[k]) continue;
#pragma unroll
        for (int j = 0; j < K; ++j) {           // K separate store streams
          st16(out + off[k] + j * w.chunk(), r[k][j]);
          if (ahead) r[k][j] = nxt[k][j];
        }
      }
      pass_barrier();
    }
  }
}

// K >= 4 holds K vectors and their addresses: compiled for half the
// resident CTAs (twice the registers), and launched so (copy_launch_plan)
template <int U, int K, int THREADS, int V, int CTAS>
__global__ void __launch_bounds__(THREADS, K >= 4 ? CTAS / 2 : CTAS)
copy_win(const char* x, char* out, int n_tiles, int tile_vecs, int streams,
         int passes) {
  const VecWalk w(n_tiles, tile_vecs, streams, K);
  const WinCursor<THREADS, V> cur(w);
  if (WinCursor<THREADS, V>::fixed(w)) {
    copy_fixed<U, K, V>(x, out, w, cur.first, passes);
    return;
  }
  // several blocks a pass: a thread issues the loads of R of its blocks
  // (c, c + G, ...) before it stores any
  constexpr int R = walk_group<V, K>;
  Pos group;
  group.set((long long)gridDim.x * THREADS * V * R, w.nv);
  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Pos q[R * V];
#pragma unroll
      for (int i = 0; i < R * V; ++i) {
        if (i < V) q[i] = cur.first[i];
        else { q[i] = q[i - V]; q[i].add(cur.stride, w.nv); }
      }
      for (long long blk = blockIdx.x; blk < cur.blocks;
           blk += (long long)gridDim.x * R) {
        copy_positions<K, R * V>(x, out, w, q);
#pragma unroll
        for (int i = 0; i < R * V; ++i) q[i].add(group, w.nv);
      }
      pass_barrier();
    }
  }
}

template <int K, int THREADS, int V>
__global__ void __launch_bounds__(THREADS)
copy_np(const char* x, char* out, int n_tiles, int tile_vecs, int streams) {
  const VecWalk w(n_tiles, tile_vecs, streams, K);
  Pos q[V];
  np_positions<THREADS, V>(w, q);
  copy_positions<K, V>(x, out, w, q);
}

struct CopyArgs {
  const char* x;
  char* out;
  int n_tiles, tile_vecs, streams, passes, grid;
  cudaStream_t st;
};

template <int U, int K, int THREADS, int V, int CTAS>
static void launch_copy_win(const CopyArgs& a) {
  copy_win<U, K, THREADS, V, CTAS><<<a.grid, THREADS, 0, a.st>>>(
      a.x, a.out, a.n_tiles, a.tile_vecs, a.streams, a.passes);
}

// a.grid must be the blocks of a pass; the passes go on grid.y, 65535 a
// launch
template <int K, int THREADS, int V>
static int launch_copy_np(const CopyArgs& a) {
  const long long per = (long long)THREADS * V;
  const long long pos = (long long)a.n_tiles * (a.tile_vecs / K);
  if (a.grid < 1 || (long long)a.grid * per < pos ||
      (long long)(a.grid - 1) * per >= pos)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < a.passes; p += 65535) {
    const int n = a.passes - p < 65535 ? a.passes - p : 65535;
    copy_np<K, THREADS, V><<<dim3((unsigned)a.grid, (unsigned)n), THREADS,
                             0, a.st>>>(a.x, a.out, a.n_tiles, a.tile_vecs,
                                        a.streams);
  }
  return 0;
}

}  // namespace mb

// tile_bytes = block_rows * 128 * element size.  shape: 0 persistent (grid
// resident CTAs, the pass loop inside, unrolled `unroll` times), 1
// non-persistent (grid = the blocks of a pass, the passes on grid.y;
// `unroll` unused).  Returns cudaGetLastError().
extern "C" int membench_copy(const void* x, void* out, int n_tiles,
                             long long tile_bytes, int streams, int passes,
                             int unroll, int interleave, int shape, int grid,
                             void* stream) {
  using namespace mb;
  const CopyArgs a{static_cast<const char*>(x), static_cast<char*>(out),
                   n_tiles, (int)(tile_bytes / 16), streams, passes, grid,
                   static_cast<cudaStream_t>(stream)};
  if (shape == 0) {
#define MB_COPY(U)                                                          \
  switch (interleave) {                                                     \
    case 1: launch_copy_win<U, 1, kCopyWinThreads, kCopyWinVecs,            \
                            kCopyWinCtas>(a); break;                        \
    case 2: launch_copy_win<U, 2, kCopyWinThreads, kCopyWinVecs,            \
                            kCopyWinCtas>(a); break;                        \
    case 4: launch_copy_win<U, 4, kCopyWinThreads, kCopyWinVecs,            \
                            kCopyWinCtas>(a); break;                        \
    case 8: launch_copy_win<U, 8, kCopyWinThreads, kCopyWinVecs,            \
                            kCopyWinCtas>(a); break;                        \
    default: return (int)cudaErrorInvalidValue;                             \
  }
    MB_UNROLL_CASES(MB_COPY)
#undef MB_COPY
  } else if (shape == 1) {
    int err = (int)cudaErrorInvalidValue;
    switch (interleave) {
      case 1: err = launch_copy_np<1, kCopyNpThreads, kCopyNpVecs>(a); break;
      case 2: err = launch_copy_np<2, kCopyNpThreads, kCopyNpVecs>(a); break;
      case 4: err = launch_copy_np<4, kCopyNpThreads, kCopyNpVecs>(a); break;
      case 8: err = launch_copy_np<8, kCopyNpThreads, kCopyNpVecs>(a); break;
    }
    if (err) return err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
