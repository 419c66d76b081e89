// Scalar-accumulating membench kernels: load_sum, load_only, fma.
//
// Replaces _acc_kernel + _mix_body("load_sum" | "load_only" | "fma") of
// src/repro/kernels/membench/membench.py.  Each returns, through a scratch
// vector of partials and a fixed-order fold, the float32 sum over all passes
// and tiles of the tile's contribution:
//   load_sum   sum of every element (interleave = K: K row chunks of the
//              tile summed by K independent accumulators)
//   load_only  element [0,0] of the tile; the whole tile is still moved
//   fma        sum over elements of a depth-long chain v = fma(v, a, b)
//
// Bound on an H100: bytes (each buffer byte read once per pass) except fma
// at large depth, which is bound by float32 FMA throughput.  The design
// (walk.cuh): the walk is cut into blocks of consecutive 16-byte vectors,
// so that a small buffer spans many SMs (a 32 KiB buffer is one tile, which
// a CTA that owned whole tiles read alone), every load of a block is issued
// before the first use.  Two grid shapes, picked by the wrapper from the
// buffer against the L2 (membench.acc_launch_plan):
//
//  * at and below the L2: persistent, kAccWinCtas CTAs of kAccWinThreads an
//    SM, the pass loop inside, each thread's share of a pass the same in
//    every pass; a thread issues the loads of several of its blocks (or
//    the next pass's, where it has one) before it uses any (acc_linear,
//    acc_walk, acc_fixed); one partial a CTA;
//  * above it: non-persistent, one CTA of kAccNpThreads per block in address
//    order, the pass on grid.y; one partial per (block, pass), folded in two
//    fixed-order stages (fold_chunks): no float atomics, so a result is
//    bit-identical from run to run.  A long fma chain (4 links a byte and
//    more: bfloat16 at depth 8) keeps the persistent grid above the L2 too:
//    it keeps the float32 units about as busy as the loads keep the memory,
//    and CTAs that retire after one block overlap the two less
//    (membench.acc_launch_plan).
//
// load_only is pure data movement: every 16-byte vector but the first of a
// tile goes global -> shared memory by cp.async (a copy writes shared memory,
// so it cannot be deleted; no loaded value passes through a register and no
// arithmetic runs), into a per-thread ring of slots: kLoadOnlyStages that run
// on across passes in the persistent shape, one a copy (drained before the
// CTA ends) in the other.  The first vector of each tile is a register load
// whose element [0,0] is added to the result: it is used, so it is kept
// (ptxas may narrow it to the word it uses; its 32-byte sector moves all the
// same).  chip_smoke.py phase 1 checks the SASS of every kernel here for its
// global loads (LDG, LDGSTS; the persistent kernels' inside their loops).
#include "walk.cuh"

namespace mb {

// the grid shapes (mirrored by membench.ACC_* and checked against it by
// tests/test_torch_acc_plan.py)
constexpr int kAccWinThreads = 256;   // persistent: threads a CTA
constexpr int kAccWinVecs = 1;        // persistent: positions a thread a block
constexpr int kAccWinCtas = 4;        // persistent: resident CTAs an SM
constexpr int kAccNpThreads = 256;    // non-persistent: threads a CTA
constexpr int kAccNpVecs = 4;         // non-persistent: positions a thread
constexpr int kAccNpCtas = 4;         // non-persistent: CTAs an SM compiled for
constexpr int kLoadOnlyStages = 4;    // load_only: cp.async slots a thread
constexpr int kFoldChunk = 1024;      // partials a CTA of the first fold stage

enum { kLoadSum = 0, kLoadOnly = 1, kFma = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
               :
               : "r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// a thread's ring of S 16-byte slots in shared memory: a copy waits only
// for the copy that used its slot S copies earlier
template <int THREADS, int S>
struct CopyRing {
  int slot = 0;
  __device__ __forceinline__ void put(const char* src) {
    __shared__ __align__(16) unsigned char slots[S][THREADS][16];
    cp_async_wait<S - 1>();
    cp_async16(slots[slot][threadIdx.x], src);
    cp_async_commit();
    slot = slot + 1 == S ? 0 : slot + 1;
  }
  __device__ __forceinline__ void drain() { cp_async_wait<0>(); }
};

// load_only ring slots a thread: `want`, fewer where a CTA of THREADS
// would pass 32 KiB of them
__host__ __device__ constexpr int ring_stages(int want, int threads) {
  return want < 2048 / threads ? want : 2048 / threads;
}

template <typename T> __device__ __forceinline__ float elem0(uint4 v);
template <> __device__ __forceinline__ float elem0<float>(uint4 v) {
  return __uint_as_float(v.x);
}
template <> __device__ __forceinline__ float elem0<__nv_bfloat16>(uint4 v) {
  return __uint_as_float(v.x << 16);     // element 0 is the low half-word
}

template <typename T>
__device__ __forceinline__ float fma_chain(uint4 r, int depth) {
  const float a = 1.0000001f, b = 1e-9f;
  float f[Vec<T>::N];
  Vec<T>::unpack(r, f);
#pragma unroll 8
  for (int d = 0; d < depth; ++d) {
#pragma unroll
    for (int e = 0; e < Vec<T>::N; ++e) f[e] = fmaf(f[e], a, b);
  }
  float s = f[0];
#pragma unroll
  for (int e = 1; e < Vec<T>::N; ++e) s += f[e];
  return s;
}

// fixed-order sum over a CTA of THREADS; the result is valid in thread 0
template <int THREADS>
__device__ __forceinline__ float block_sum_n(float v) {
  __shared__ float warp_part[THREADS / 32];
  __syncthreads();                       // warp_part may be in use
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < THREADS / 32 ? warp_part[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// one thread's V positions of one block: every load issued, then used
template <typename T, int K, int MIX, int V, typename Ring>
__device__ __forceinline__ void acc_positions(const char* x, const VecWalk& w,
                                              const Pos (&p)[V],
                                              float (&acc)[K], int depth,
                                              Ring& ring) {
  if constexpr (MIX == kLoadOnly) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!w.valid(p[k])) continue;
      const char* src = x + w.offset(p[k]);
      if (p[k].col == 0) acc[0] += elem0<T>(ld16(src));   // element [0,0]
      else ring.put(src);
    }
  } else {
    uint4 r[V][K];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!w.valid(p[k])) continue;
      const char* src = x + w.offset(p[k]);
#pragma unroll
      for (int j = 0; j < K; ++j) r[k][j] = ld16(src + j * w.chunk());
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!w.valid(p[k])) continue;
#pragma unroll
      for (int j = 0; j < K; ++j)               // K independent chains
        acc[j] += MIX == kLoadSum ? vec_sum<T>(r[k][j])
                                  : fma_chain<T>(r[k][j], depth);
    }
  }
}

// the persistent loop where a thread has the same positions in every pass
// (WinCursor::fixed): addresses worked out once, and each pass's loads
// issued before the previous pass's values are used (load_only: its
// [0,0] register loads; its copies never wait on a value)
template <typename T, int U, int K, int MIX, int V, typename Ring>
__device__ __forceinline__ void acc_fixed(const char* x, const VecWalk& w,
                                          const Pos (&p)[V], float (&acc)[K],
                                          int passes, int depth, Ring& ring) {
  const char* src[V];
  bool ok[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ok[k] = w.valid(p[k]);
    src[k] = x + (ok[k] ? w.offset(p[k]) : 0);
  }
  if constexpr (MIX == kLoadOnly) {
    bool first[V];
    uint4 r[V], nxt[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      first[k] = ok[k] && p[k].col == 0;
      if (first[k]) r[k] = ld16(src[k]);
    }
    for (int q = 0; q < passes; q += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool more = q + u + 1 < passes;
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (first[k] && more) nxt[k] = ld16(src[k]);
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (ok[k] && !first[k]) ring.put(src[k]);
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (first[k]) {
            acc[0] += elem0<T>(r[k]);                      // element [0,0]
            r[k] = nxt[k];
          }
        pass_barrier();
      }
    }
  } else {
    constexpr bool ahead = kAhead<V, K>;
    uint4 r[V][K], nxt[V][K];
    auto load = [&](uint4 (&v)[V][K]) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (ok[k]) {
#pragma unroll
          for (int j = 0; j < K; ++j) v[k][j] = ld16(src[k] + j * w.chunk());
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
          for (int j = 0; j < K; ++j) {
            acc[j] += MIX == kLoadSum ? vec_sum<T>(r[k][j])
                                      : fma_chain<T>(r[k][j], depth);
            if (ahead) r[k][j] = nxt[k][j];
          }
        }
        pass_barrier();
      }
    }
  }
}

// acc_linear's indices stay below n + grid x block x r (n vectors a pass,
// blocks of `block`, r of them a group): int where that fits
__host__ __device__ constexpr bool linear_fits_int(long long n,
                                                   long long grid,
                                                   long long block,
                                                   long long r) {
  return n + grid * block * r <= 0x7fffffffLL;
}

// the persistent loop where a CTA takes several blocks a pass, in the main
// path's case (interleave 1, streams 1: position q is vector q of the
// buffer, so no cursor is carried): a thread issues the loads of R of its
// blocks (c, c + G, ...) before it uses any, as a CTA that owned whole
// tiles issued four; I is int where linear_fits_int says so
template <typename T, int U, int MIX, int THREADS, int V, typename I>
__device__ __forceinline__ void acc_linear(const char* x, I n, float& acc,
                                           int passes, int depth) {
  constexpr int R = walk_group<V, 1>;
  const I span = (I)gridDim.x * (THREADS * V);
  const I q0 = (I)blockIdx.x * (THREADS * V) + (I)threadIdx.x;
  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (I q = q0; q < n; q += span * R) {
        uint4 r[R * V];
        bool ok[R * V];
#pragma unroll
        for (int i = 0; i < R * V; ++i) {
          const I qi = q + (I)(i / V) * span + (i % V) * THREADS;
          ok[i] = qi < n;
          if (ok[i]) r[i] = ld16(x + (size_t)qi * 16);
        }
#pragma unroll
        for (int i = 0; i < R * V; ++i)
          if (ok[i])
            acc += MIX == kLoadSum ? vec_sum<T>(r[i])
                                   : fma_chain<T>(r[i], depth);
      }
      pass_barrier();
    }
  }
}

// the persistent loop where a CTA takes several blocks a pass, in general:
// a thread issues the loads of R of its blocks (R x V x K <= 4 vectors)
// before it uses any (blocks past the last have no valid position)
template <typename T, int U, int K, int MIX, int THREADS, int V,
          typename Ring>
__device__ __forceinline__ void acc_walk(const char* x, const VecWalk& w,
                                         const WinCursor<THREADS, V>& cur,
                                         float (&acc)[K], int passes,
                                         int depth, Ring& ring) {
  constexpr int R = walk_group<V, K>;
  Pos group;                                     // R blocks of the CTA
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
        acc_positions<T, K, MIX, R * V>(x, w, q, acc, depth, ring);
#pragma unroll
        for (int i = 0; i < R * V; ++i) q[i].add(group, w.nv);
      }
      pass_barrier();
    }
  }
}

template <int K, int THREADS>
__device__ __forceinline__ float cta_total(float (&acc)[K]) {
  float s = acc[0];
#pragma unroll
  for (int j = 1; j < K; ++j) s += acc[j];      // the chains combined last
  return block_sum_n<THREADS>(s);
}

// persistent: one partial a CTA
// K >= 4 holds K vectors a position and their addresses: compiled for half
// the resident CTAs (twice the registers), and launched so
// (acc_launch_plan)
template <typename T, int U, int K, int MIX, int THREADS, int V, int CTAS>
__global__ void __launch_bounds__(THREADS, K >= 4 ? CTAS / 2 : CTAS)
acc_win(const char* x, float* partials, int n_tiles, int tile_vecs,
        int streams, int passes, int depth) {
  const VecWalk w(n_tiles, tile_vecs, streams, K);
  CopyRing<THREADS, ring_stages(kLoadOnlyStages, THREADS)> ring;
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.0f;
  using Cursor = WinCursor<THREADS, V>;
  const bool fixed = Cursor::fixed(w);
  bool linear = false;
  if constexpr (K == 1 && MIX != kLoadOnly) {
    linear = streams == 1 && !fixed;
    const long long n = w.positions();
    if (linear &&
        linear_fits_int(n, gridDim.x, THREADS * V, walk_group<V, 1>))
      acc_linear<T, U, MIX, THREADS, V>(x, (int)n, acc[0], passes, depth);
    else if (linear)
      acc_linear<T, U, MIX, THREADS, V>(x, n, acc[0], passes, depth);
  }
  if (!linear) {
    const Cursor cur(w);
    if (fixed)
      acc_fixed<T, U, K, MIX, V>(x, w, cur.first, acc, passes, depth, ring);
    else
      acc_walk<T, U, K, MIX>(x, w, cur, acc, passes, depth, ring);
  }
  if constexpr (MIX == kLoadOnly) ring.drain();
  const float s = cta_total<K, THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// non-persistent: one partial per (block, pass); compiled for CTAS
// resident CTAs an SM, so that some load while others compute (one where
// the V x K vectors of a thread need more registers)
template <typename T, int K, int MIX, int THREADS, int V, int CTAS>
__global__ void __launch_bounds__(THREADS, V * K <= 4 ? CTAS : 1)
acc_np(const char* x, float* partials, int n_tiles, int tile_vecs,
       int streams, int depth, int pass0) {
  const VecWalk w(n_tiles, tile_vecs, streams, K);
  Pos q[V];
  np_positions<THREADS, V>(w, q);
  CopyRing<THREADS, ring_stages(V, THREADS)> ring;   // a slot a copy
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.0f;
  acc_positions<T, K, MIX, V>(x, w, q, acc, depth, ring);
  if constexpr (MIX == kLoadOnly) ring.drain();
  const float s = cta_total<K, THREADS>(acc);
  if (threadIdx.x == 0)
    partials[(size_t)(pass0 + blockIdx.y) * gridDim.x + blockIdx.x] = s;
}

// ---- host side --------------------------------------------------------------

struct AccArgs {
  const char* x;
  float* partials;
  int n_tiles, tile_vecs, streams, passes, depth, grid;
  cudaStream_t st;
};

template <typename T, int U, int K, int MIX, int THREADS, int V, int CTAS>
static void launch_win(const AccArgs& a) {
  acc_win<T, U, K, MIX, THREADS, V, CTAS><<<a.grid, THREADS, 0, a.st>>>(
      a.x, a.partials, a.n_tiles, a.tile_vecs, a.streams, a.passes,
      a.depth);
}

// a.grid must be the blocks of a pass; the passes go on grid.y, 65535 a
// launch
template <typename T, int K, int MIX, int THREADS, int V, int CTAS>
static int launch_np(const AccArgs& a) {
  const long long per = (long long)THREADS * V;
  const long long pos = (long long)a.n_tiles * (a.tile_vecs / K);
  if (a.grid < 1 || (long long)a.grid * per < pos ||
      (long long)(a.grid - 1) * per >= pos)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < a.passes; p += 65535) {
    const int n = a.passes - p < 65535 ? a.passes - p : 65535;
    acc_np<T, K, MIX, THREADS, V, CTAS><<<
        dim3((unsigned)a.grid, (unsigned)n), THREADS, 0, a.st>>>(
        a.x, a.partials, a.n_tiles, a.tile_vecs, a.streams, a.depth, p);
  }
  return 0;
}

// out[0] = the fixed-order sum of partials[0 .. n); partials holds n +
// ceil(n / kFoldChunk) floats (the second part is the first stage's output)
static int fold(float* partials, long long n, float* out, cudaStream_t st) {
  if (n <= kFoldChunk) {
    fold_chunks<<<1, kThreads, 0, st>>>(partials, n, n, out);
  } else {
    const long long m = (n + kFoldChunk - 1) / kFoldChunk;
    float* mid = partials + n;
    fold_chunks<<<(unsigned)m, kThreads, 0, st>>>(partials, n, kFoldChunk,
                                                  mid);
    fold_chunks<<<1, kThreads, 0, st>>>(mid, m, m, out);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_acc(int mix, int shape, int unroll, int interleave,
                      const AccArgs& a, float* out) {
  if (mix != kLoadSum && interleave != 1) return (int)cudaErrorInvalidValue;
  if (shape == 0) {
#define MB_WIN(U, K, M) \
  launch_win<T, U, K, M, kAccWinThreads, kAccWinVecs, kAccWinCtas>(a)
#define MB_WIN_SUM(U)                                                       \
  switch (interleave) {                                                     \
    case 1: MB_WIN(U, 1, kLoadSum); break;                                  \
    case 2: MB_WIN(U, 2, kLoadSum); break;                                  \
    case 4: MB_WIN(U, 4, kLoadSum); break;                                  \
    case 8: MB_WIN(U, 8, kLoadSum); break;                                  \
    default: return (int)cudaErrorInvalidValue;                             \
  }
#define MB_WIN_ONLY(U) MB_WIN(U, 1, kLoadOnly)
#define MB_WIN_FMA(U) MB_WIN(U, 1, kFma)
    if (mix == kLoadSum) { MB_UNROLL_CASES(MB_WIN_SUM) }
    else if (mix == kLoadOnly) { MB_UNROLL_CASES(MB_WIN_ONLY) }
    else if (mix == kFma) { MB_UNROLL_CASES(MB_WIN_FMA) }
    else return (int)cudaErrorInvalidValue;
#undef MB_WIN
#undef MB_WIN_SUM
#undef MB_WIN_ONLY
#undef MB_WIN_FMA
  } else if (shape == 1) {
#define MB_NP(K, M) \
  launch_np<T, K, M, kAccNpThreads, kAccNpVecs, kAccNpCtas>(a)
    int err = (int)cudaErrorInvalidValue;
    if (mix == kLoadSum) {
      switch (interleave) {
        case 1: err = MB_NP(1, kLoadSum); break;
        case 2: err = MB_NP(2, kLoadSum); break;
        case 4: err = MB_NP(4, kLoadSum); break;
        case 8: err = MB_NP(8, kLoadSum); break;
      }
    } else if (mix == kLoadOnly) {
      err = MB_NP(1, kLoadOnly);
    } else if (mix == kFma) {
      err = MB_NP(1, kFma);
    }
#undef MB_NP
    if (err) return err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = shape == 0 ? a.grid : (long long)a.grid * a.passes;
  return fold(a.partials, n, out, a.st);
}

}  // namespace mb

// mix: 0 load_sum, 1 load_only, 2 fma.  dtype: 0 float32, 1 bfloat16.
// shape: 0 persistent (grid resident CTAs, the pass loop inside, unrolled
// `unroll` times), 1 non-persistent (grid = the blocks of a pass, the passes
// on grid.y; `unroll` unused).  partials: float scratch of n + ceil(n /
// kFoldChunk) for n = grid (shape 0) or grid * passes (shape 1); out:
// float[1].  Returns cudaGetLastError().
extern "C" int membench_acc(int mix, int dtype, const void* x, float* partials,
                            float* out, int n_tiles, int block_rows,
                            int streams, int passes, int unroll,
                            int interleave, int depth, int shape, int grid,
                            void* stream) {
  const size_t esize = dtype == 0 ? 4 : 2;
  const mb::AccArgs a{static_cast<const char*>(x), partials, n_tiles,
                      (int)((size_t)block_rows * mb::kLanes * esize / 16),
                      streams, passes, depth, grid,
                      static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return mb::launch_acc<float>(mix, shape, unroll, interleave, a, out);
  if (dtype == 1)
    return mb::launch_acc<__nv_bfloat16>(mix, shape, unroll, interleave, a,
                                         out);
  return (int)cudaErrorInvalidValue;
}
