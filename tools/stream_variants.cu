// Design variants of the streaming membench kernels (csrc/copy.cu,
// csrc/rw.cu and csrc/triad.cu), for timing on the card by
// tools/stream_variants.py, which builds this file with
// -I src/repro_torch/kernels/membench/csrc: once per cache-hint pair
// (-DSV_LD=n -DSV_ST=n) for the first sweep, with -DSV_LEAN once per hint
// set (-DSV_HINT=n) for the second and third, and with -DSV_TRIAD for the
// triad sweep (its variants are described at SV_TRIAD below).
//
// Second and third sweeps (SV_LEAN): sv_lean<T, R, V, CTAS> runs the pass
// body of csrc/stream.cuh (the one rw.cu runs) with V vectors a thread in
// flight, compiled for CTAS resident CTAs an SM (__launch_bounds__), cache
// hints SV_HINT (bits: 1 st.global.cs stores, 2 ld.global.L2::256B loads),
// over every (R, V, CTAS) of SV_LEAN_LIST, with rw.cu's tile walk or one of
// two other work splits (sv_lean below).
//
// First sweep:
// Every variant computes rw_RtoW: per 16-byte vector v = s0 + 1.5*s1 + ...
// (one rounding per operation, as rw.cu), stored to each of W outputs, over
// a (rows, 128) buffer cut into n_tiles tiles of tile_vecs vectors, `passes`
// times in one launch (streams 1, interleave 1, unroll 1).  R = 1 is copy.
//
//  sv_rw<T, R, V>   V vectors per thread in flight (V x R loads issued
//                   before the first store), 256 threads a CTA.
//  sv_bulk<T, R>    cp.async.bulk global -> shared -> global with an
//                   mbarrier ring; one thread issues the copies.
//
// Work split (split = 0): CTA c of G walks tiles c, c+G, ... (the last
// round leaves CTAs idle when G does not divide n_tiles).  split = 1: the
// n_tiles / G whole rounds as before, then the remaining tiles' vectors cut
// into G contiguous ranges of equal length (+-1 vector), one per CTA.
//
// Load hints (SV_LD): 0 ld.global, 1 ld.global.nc.L1::no_allocate,
// 2 ld.global.L2::cache_hint with an L2 evict_first policy, 3 ld.global.nc,
// 4 ld.global.L1::no_allocate.  Store hints (SV_ST): 0 st.global,
// 1 st.global.cs, 2 st.global.L2::cache_hint with an evict_first policy.
#include "membench_common.cuh"
#include "stream.cuh"

#ifndef SV_LD
#define SV_LD 0
#endif
#ifndef SV_ST
#define SV_ST 0
#endif

namespace sv {
using namespace mb;

template <typename T, int R>
__device__ __forceinline__ uint4 fold(const uint4* in) {
  if (R == 1) return in[0];
  float v[Vec<T>::N], s[Vec<T>::N];
  Vec<T>::unpack(in[0], v);
#pragma unroll
  for (int r = 1; r < R; ++r) {
    Vec<T>::unpack(in[r], s);
#pragma unroll
    for (int e = 0; e < Vec<T>::N; ++e)
      v[e] = round_to<T>(__fadd_rn(v[e], round_to<T>(__fmul_rn(1.5f, s[e]))));
  }
  return Vec<T>::pack(v);
}

}  // namespace sv

#if defined(SV_TRIAD)

namespace sv {

// Triad variants (SV_TRIAD): out = b + 1.5 c per 16-byte vector, as
// csrc/triad.cu computes it (fold<T, 2>: the product rounded, then the sum),
// over the tiles in walk_tile order.  Vector q of the walk (q = step *
// tile_vecs + i) lies at walk_tile(step) * tile_vecs + i; a block of the
// grid takes THREADS x V consecutive vectors of the walk, thread t the
// vectors t, t + THREADS, ... of it, all V x 2 loads issued before its V
// stores.
//
//  triad_np<T, V, THREADS>   (a) non-persistent: one block per THREADS x V
//                            vectors in address order, the pass the slow
//                            grid dimension (blockIdx.y): the resident
//                            blocks cover one compact moving window.
//  triad_win<T, V, THREADS>  (b) persistent, compact window: G resident
//                            CTAs take blocks c, c + G, ... of the same
//                            THREADS x V vectors, so the G CTAs in flight
//                            cover G x THREADS x V consecutive vectors (a
//                            few MiB) instead of G tiles spread over the
//                            buffer; the pass loop inside.
// THREADS 256, 512 or 1024: (c), the CTA size.

__device__ __forceinline__ size_t walk_vec(long long q, int tile_vecs,
                                           int streams, int seg) {
  if (streams == 1) return (size_t)q * 16;
  const long long step = q / tile_vecs;
  return ((size_t)mb::walk_tile((int)step, streams, seg) * tile_vecs +
          (size_t)(q - step * tile_vecs)) * 16;
}

template <typename T, int V, int THREADS>
__device__ __forceinline__ void triad_block(const char* b, const char* c,
                                            char* out, long long blk,
                                            long long total, int tile_vecs,
                                            int streams, int seg) {
  const long long q0 = blk * THREADS * V + threadIdx.x;
  uint4 in[V][2];
  size_t off[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long q = q0 + (long long)k * THREADS;
    off[k] = walk_vec(q, tile_vecs, streams, seg);
    if (q < total) {
      in[k][0] = mb::ld16(b + off[k]);
      in[k][1] = mb::ld16(c + off[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (q0 + (long long)k * THREADS < total)
      mb::st16(out + off[k], fold<T, 2>(in[k]));
}

template <typename T, int V, int THREADS>
__global__ void __launch_bounds__(THREADS)
triad_np(const char* b, const char* c, char* out, int n_tiles, int tile_vecs,
         int streams) {
  triad_block<T, V, THREADS>(b, c, out, blockIdx.x,
                             (long long)n_tiles * tile_vecs, tile_vecs,
                             streams, n_tiles / streams);
}

template <typename T, int V, int THREADS>
__global__ void __launch_bounds__(THREADS)
triad_win(const char* b, const char* c, char* out, int n_tiles, int tile_vecs,
          int streams, int passes) {
  const long long total = (long long)n_tiles * tile_vecs;
  const long long blocks = (total + THREADS * V - 1) / (THREADS * V);
  for (int p = 0; p < passes; ++p) {
    for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x)
      triad_block<T, V, THREADS>(b, c, out, blk, total, tile_vecs, streams,
                                 n_tiles / streams);
    mb::pass_barrier();
  }
}

template <typename T, int V, int THREADS>
static int triad_launch_t(int kind, const void* b, const void* c, void* out,
                          int n_tiles, int tile_vecs, int streams, int passes,
                          int grid, cudaStream_t s, int occupancy_only) {
  if (occupancy_only) {
    int n = 0;
    if (kind == 0)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, triad_np<T, V, THREADS>, THREADS, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, triad_win<T, V, THREADS>, THREADS, 0);
    return -n;
  }
  const char* bp = static_cast<const char*>(b);
  const char* cp = static_cast<const char*>(c);
  char* op = static_cast<char*>(out);
  if (kind == 0) {
    const long long total = (long long)n_tiles * tile_vecs;
    const long long blocks = (total + THREADS * V - 1) / (THREADS * V);
    if (blocks > 0x7fffffffLL || passes > 65535)
      return (int)cudaErrorInvalidValue;
    triad_np<T, V, THREADS><<<dim3((unsigned)blocks, passes), THREADS, 0, s>>>(
        bp, cp, op, n_tiles, tile_vecs, streams);
  } else {
    triad_win<T, V, THREADS><<<grid, THREADS, 0, s>>>(
        bp, cp, op, n_tiles, tile_vecs, streams, passes);
  }
  return (int)cudaGetLastError();
}

}  // namespace sv

// (V, THREADS) of the triad variants
#define SV_TRIAD_LIST(X)                                                    \
  X(1, 256) X(2, 256) X(4, 256) X(8, 256) X(1, 512) X(2, 512) X(4, 512)     \
  X(1, 1024) X(2, 1024) X(4, 1024)

// kind 0: triad_np (grid: blocks x passes, computed here; `grid` unused),
// kind 1: triad_win on `grid` CTAs.  dtype 0 float32, 1 bfloat16.
// occupancy_only != 0: launch nothing, return minus the resident CTAs an SM.
// A (V, THREADS) not in the list: cudaErrorInvalidValue.
extern "C" int sv_triad_launch(int kind, int dtype, int vecs, int threads,
                               const void* b, const void* c, void* out,
                               int n_tiles, int tile_vecs, int streams,
                               int passes, int grid, int occupancy_only,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SV_TRIAD_CASE(V, TH)                                                \
  if (vecs == V && threads == TH)                                           \
    return dtype == 0                                                       \
        ? sv::triad_launch_t<float, V, TH>(kind, b, c, out, n_tiles,        \
                                           tile_vecs, streams, passes,      \
                                           grid, s, occupancy_only)         \
        : sv::triad_launch_t<__nv_bfloat16, V, TH>(                         \
              kind, b, c, out, n_tiles, tile_vecs, streams, passes, grid,   \
              s, occupancy_only);
  SV_TRIAD_LIST(SV_TRIAD_CASE)
#undef SV_TRIAD_CASE
  return (int)cudaErrorInvalidValue;
}

#elif defined(SV_LEAN)

#ifndef SV_HINT
#define SV_HINT 0
#endif

namespace sv {

// the pass loop of rw.cu (interleave 1, streams 1) with two work splits
// beside rw.cu's: split = 1 cuts the last round's tiles over all CTAs in
// granules of kGranule units (128 bytes: one line of the row), and rot = 1
// has CTA c start every tile at unit (c mod units/32) * 32 and wrap round
constexpr int kGranule = 8;

template <typename T, int R, int V, int CTAS>
__global__ void __launch_bounds__(mb::kThreads, CTAS)
sv_lean(const __grid_constant__ mb::StreamPtrs p, int writes, int n_tiles,
        int units, int split, int rot, int passes) {
  const auto f = [](const uint4* in) { return fold<T, R>(in); };
  const auto piece = [&](long long tile, int a, int b) {
    mb::stream_piece<R, V, SV_HINT, true>(p, writes,
                                          (size_t)tile * units * 16, units,
                                          1, a, b, f);
  };
  const int G = gridDim.x, c = blockIdx.x;
  const int rounds = split ? n_tiles / G : (n_tiles - c + G - 1) / G;
  const int r0 = rot ? c % (units / 32) * 32 : 0;
  const long long base = (long long)rounds * G * units;
  const long long granules = ((long long)n_tiles * units - base) / kGranule;
  for (int pass = 0; pass < passes; ++pass) {
    for (int j = 0; j < rounds; ++j) {
      const long long t = (long long)j * G + c;
      if (r0) {
        piece(t, r0, units);
        piece(t, 0, r0);
      } else {
        piece(t, 0, units);
      }
    }
    if (split) {
      long long u = base + granules * c / G * kGranule;
      const long long end = base + granules * (c + 1) / G * kGranule;
      while (u < end) {
        const int a = (int)(u % units);
        const int b = (int)min((long long)units, a + (end - u));
        piece(u / units, a, b);
        u += b - a;
      }
    }
    mb::pass_barrier();
  }
}

template <typename T, int R, int V, int CTAS>
static int lean(const mb::StreamPtrs& p, int writes, int n_tiles, int units,
                int split, int rot, int passes, int grid, cudaStream_t s,
                int occupancy_only) {
  if (occupancy_only) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sv_lean<T, R, V, CTAS>,
                                                  mb::kThreads, 0);
    return -n;
  }
  sv_lean<T, R, V, CTAS><<<grid, mb::kThreads, 0, s>>>(
      p, writes, n_tiles, units, split, rot, passes);
  return (int)cudaGetLastError();
}

// R = 1 moves bits: one float32 kernel serves both dtypes
template <int R, int V, int CTAS>
static int lean_any(int dtype, const mb::StreamPtrs& p, int writes,
                    int n_tiles, int units, int split, int rot, int passes,
                    int grid, cudaStream_t s, int occupancy_only) {
  if constexpr (R == 1)
    return lean<float, R, V, CTAS>(p, writes, n_tiles, units, split, rot,
                                   passes, grid, s, occupancy_only);
  else if (dtype == 0)
    return lean<float, R, V, CTAS>(p, writes, n_tiles, units, split, rot,
                                   passes, grid, s, occupancy_only);
  else
    return lean<__nv_bfloat16, R, V, CTAS>(p, writes, n_tiles, units, split,
                                           rot, passes, grid, s,
                                           occupancy_only);
}

}  // namespace sv

// (R, V, CTAS) of the second and third sweeps: V x R x 16 bytes of data
// registers a thread within what CTAS resident CTAs leave it, and a few
// beyond
#define SV_LEAN_LIST(X)                                                     \
  X(1, 1, 8) X(1, 2, 8) X(1, 1, 4) X(1, 2, 4) X(1, 4, 4) X(1, 8, 4)         \
  X(1, 4, 2) X(1, 8, 2) X(1, 8, 1)                                          \
  X(2, 1, 8) X(2, 1, 4) X(2, 2, 4) X(2, 4, 4) X(2, 4, 2) X(2, 8, 2)         \
  X(2, 8, 1)                                                                \
  X(3, 1, 4) X(3, 2, 4) X(3, 4, 4) X(3, 4, 2) X(3, 8, 2) X(3, 8, 1)         \
  X(4, 1, 4) X(4, 2, 4) X(4, 4, 4) X(4, 2, 2) X(4, 4, 2) X(4, 8, 1)

// dtype 0 float32, 1 bfloat16.  occupancy_only != 0: launch nothing, return
// minus the resident CTAs an SM.  An (R, V, CTAS) not in the list:
// cudaErrorInvalidValue.
extern "C" int sv_lean_launch(int dtype, int reads, int vecs, int ctas,
                              const void* const* ins, void* const* outs,
                              int writes, int n_tiles, int units, int split,
                              int rot, int passes, int grid,
                              int occupancy_only, void* stream) {
  if (writes < 1 || writes > mb::kMaxStreams)
    return (int)cudaErrorInvalidValue;
  mb::StreamPtrs p = {};
  for (int r = 0; r < reads; ++r) p.in[r] = static_cast<const char*>(ins[r]);
  for (int w = 0; w < writes; ++w) p.out[w] = static_cast<char*>(outs[w]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SV_LEAN_CASE(R, V, C)                                               \
  if (reads == R && vecs == V && ctas == C)                                 \
    return sv::lean_any<R, V, C>(dtype, p, writes, n_tiles, units, split,   \
                                 rot, passes, grid, s, occupancy_only);
  SV_LEAN_LIST(SV_LEAN_CASE)
#undef SV_LEAN_CASE
  return (int)cudaErrorInvalidValue;
}

#else  // the first sweep

namespace sv {

constexpr int kMaxRw = 8;
constexpr int kMaxStages = 8;

struct Streams {
  const char* in[kMaxRw];
  char* out[kMaxRw];
};

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p = 0;
#if SV_LD == 2 || SV_ST == 2
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
#endif
  return p;
}

__device__ __forceinline__ uint4 ld(const void* p, uint64_t pol) {
  uint4 v;
#if SV_LD == 0
  asm volatile("ld.global.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
#elif SV_LD == 1
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
#elif SV_LD == 2
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0,%1,%2,%3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
#elif SV_LD == 3
  asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
#else
  asm volatile("ld.global.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
#endif
  return v;
}

__device__ __forceinline__ void st(void* p, uint4 v, uint64_t pol) {
#if SV_ST == 0
  asm volatile("st.global.v4.u32 [%0], {%1,%2,%3,%4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
#elif SV_ST == 1
  asm volatile("st.global.cs.v4.u32 [%0], {%1,%2,%3,%4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
#else
  asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1,%2,%3,%4}, %5;"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol)
               : "memory");
#endif
}

// this CTA's share of one pass: whole tiles j*G + c for j < rounds, then
// the vector range [tail_b, tail_e) (global vector indices)
struct Share {
  int rounds;
  long long tail_b, tail_e;
};

__device__ __forceinline__ Share share(int n_tiles, int tile_vecs, int split) {
  const int G = gridDim.x, c = blockIdx.x;
  Share s;
  if (!split) {
    s.rounds = (n_tiles - c + G - 1) / G;
    s.tail_b = s.tail_e = 0;
    return s;
  }
  s.rounds = n_tiles / G;
  const long long base = (long long)s.rounds * G * tile_vecs;
  const long long tail = (long long)n_tiles * tile_vecs - base;
  s.tail_b = base + tail * c / G;
  s.tail_e = base + tail * (c + 1) / G;
  return s;
}

template <typename T, int R, int V>
__device__ __forceinline__ void range(const Streams& sp, int writes,
                                      long long v0, int n, uint64_t pol) {
  for (int i0 = threadIdx.x; i0 < n; i0 += V * kThreads) {
    uint4 in[V][R];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long off = (v0 + i0 + j * kThreads) * 16;
      if (i0 + j * kThreads < n) {
#pragma unroll
        for (int r = 0; r < R; ++r) in[j][r] = ld(sp.in[r] + off, pol);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long off = (v0 + i0 + j * kThreads) * 16;
      if (i0 + j * kThreads < n) {
        const uint4 v = fold<T, R>(in[j]);
#pragma unroll
        for (int w = 0; w < kMaxRw; ++w)
          if (w < writes) st(sp.out[w] + off, v, pol);
      }
    }
  }
}

template <typename T, int R, int V>
__global__ void __launch_bounds__(kThreads)
sv_rw(Streams sp, int writes, int n_tiles, int tile_vecs, int split,
      int passes) {
  const uint64_t pol = evict_first_policy();
  const Share s = share(n_tiles, tile_vecs, split);
  for (int p = 0; p < passes; ++p) {
    for (int j = 0; j < s.rounds; ++j)
      range<T, R, V>(sp, writes,
                     (long long)(j * gridDim.x + blockIdx.x) * tile_vecs,
                     tile_vecs, pol);
    if (s.tail_e > s.tail_b)
      range<T, R, V>(sp, writes, s.tail_b, (int)(s.tail_e - s.tail_b), pol);
    pass_barrier();
  }
}

// ---- bulk copies ----------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wait for the phase of the given parity; trap (a launch error, not a hang)
// if it never completes
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(saddr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (i == (1ll << 24)) __trap();
  }
}

__device__ __forceinline__ void bulk_store(char* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(saddr(src)), "r"(bytes) : "memory");
}

// chunk k of this CTA's share of a pass -> (global byte offset, bytes)
__device__ __forceinline__ void chunk_at(const Share& s, long long k,
                                         long long tile_bytes, int chunk,
                                         int per_tile, long long* off,
                                         int* bytes) {
  const long long n_full = (long long)s.rounds * per_tile;
  if (k < n_full) {
    const long long tile = (k / per_tile) * gridDim.x + blockIdx.x;
    const long long in_tile = (k % per_tile) * chunk;
    *off = tile * tile_bytes + in_tile;
    *bytes = (int)min((long long)chunk, tile_bytes - in_tile);
  } else {
    *off = s.tail_b * 16 + (k - n_full) * chunk;
    *bytes = (int)min((long long)chunk, s.tail_e * 16 - *off);
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
sv_bulk(Streams sp, int writes, int n_tiles, long long tile_bytes, int split,
        int passes, int chunk, int stages) {
  extern __shared__ __align__(128) char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  const Share s = share(n_tiles, (int)(tile_bytes / 16), split);
  const int per_tile = (int)((tile_bytes + chunk - 1) / chunk);
  const long long tail_bytes = (s.tail_e - s.tail_b) * 16;
  const long long per_pass = (long long)s.rounds * per_tile
                             + (tail_bytes + chunk - 1) / chunk;
  const long long total = per_pass * passes;
  char* out_buf = smem + (size_t)stages * R * chunk;   // 2 chunks (R > 1)
  const int ahead = stages - 2;                        // loads in flight
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(saddr(&bars[i])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (R == 1 && threadIdx.x != 0) return;   // copy: thread 0 does it all

  auto issue = [&](long long g) {           // thread 0: loads of chunk g
    long long off;
    int bytes;
    chunk_at(s, g % per_pass, tile_bytes, chunk, per_tile, &off, &bytes);
    const int stage = (int)(g % stages);
    uint64_t* bar = &bars[stage];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(saddr(bar)), "r"(bytes * R) : "memory");
#pragma unroll
    for (int r = 0; r < R; ++r)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(saddr(smem + ((size_t)stage * R + r) * chunk)),
             "l"(sp.in[r] + off), "r"(bytes), "r"(saddr(bar))
          : "memory");
  };

  if (threadIdx.x == 0)
    for (long long g = 0; g < ahead && g < total; ++g) issue(g);
  for (long long g = 0; g < total; ++g) {
    const int stage = (int)(g % stages);
    if (threadIdx.x == 0 && g + ahead < total) {
      // the stage of chunk g + ahead last held chunk g - 2: its stores
      // must have read it (at most one newer group pending)
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue(g + ahead);
    }
    long long off;
    int bytes;
    chunk_at(s, g % per_pass, tile_bytes, chunk, per_tile, &off, &bytes);
    const char* src = smem + (size_t)stage * R * chunk;
    if (R == 1) {
      if (threadIdx.x == 0) {
        mbar_wait(&bars[stage], (uint32_t)((g / stages) & 1));
#pragma unroll
        for (int w = 0; w < kMaxRw; ++w)
          if (w < writes) bulk_store(sp.out[w] + off, src, bytes);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
      mbar_wait(&bars[stage], (uint32_t)((g / stages) & 1));
      char* ob = out_buf + (size_t)(g & 1) * chunk;
      if (threadIdx.x == 0)        // ob's stores (chunk g - 2) have read it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncthreads();
      for (int i = threadIdx.x; i < bytes / 16; i += kThreads) {
        uint4 in[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          in[r] = reinterpret_cast<const uint4*>(src + (size_t)r * chunk)[i];
        reinterpret_cast<uint4*>(ob)[i] = fold<T, R>(in);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 0; w < kMaxRw; ++w)
          if (w < writes) bulk_store(sp.out[w] + off, ob, bytes);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace sv

// ---- C interface -----------------------------------------------------------

#define SV_R_CASES(CALL)                                                    \
  switch (reads) {                                                          \
    case 1: CALL(1); break;                                                 \
    case 2: CALL(2); break;                                                 \
    case 3: CALL(3); break;                                                 \
    case 4: CALL(4); break;                                                 \
    case 8: CALL(8); break;                                                 \
    default: return (int)cudaErrorInvalidValue;                             \
  }

static sv::Streams make_streams(const void* const* ins, int reads,
                                void* const* outs, int writes) {
  sv::Streams sp = {};
  for (int r = 0; r < reads; ++r) sp.in[r] = static_cast<const char*>(ins[r]);
  for (int w = 0; w < writes; ++w) sp.out[w] = static_cast<char*>(outs[w]);
  return sp;
}

template <typename T, int R>
static int rw_v(int vecs, const sv::Streams& sp, int writes, int n_tiles,
                int tile_vecs, int split, int passes, int grid,
                cudaStream_t s, int occupancy_only) {
#define SV_V(V)                                                             \
  if (occupancy_only) {                                                     \
    int n = 0;                                                              \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                          \
        &n, sv::sv_rw<T, R, V>, mb::kThreads, 0);                           \
    return -n;                                                              \
  }                                                                         \
  sv::sv_rw<T, R, V><<<grid, mb::kThreads, 0, s>>>(sp, writes, n_tiles,     \
                                                   tile_vecs, split, passes)
  switch (vecs) {
    case 1: SV_V(1); break;
    case 4: SV_V(4); break;
    case 8:
      if constexpr (R <= 4) { SV_V(8); break; }
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SV_V
  return (int)cudaGetLastError();
}

// dtype 0 float32, 1 bfloat16.  occupancy_only != 0: launch nothing and
// return minus the resident CTAs per SM.  Otherwise cudaGetLastError().
extern "C" int sv_rw_launch(int dtype, int reads, int vecs,
                            const void* const* ins, void* const* outs,
                            int writes, int n_tiles, int tile_vecs, int split,
                            int passes, int grid, int occupancy_only,
                            void* stream) {
  if (writes < 1 || writes > sv::kMaxRw) return (int)cudaErrorInvalidValue;
  const sv::Streams sp = make_streams(ins, reads, outs, writes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SV_CALL(R)                                                          \
  return dtype == 0                                                         \
      ? rw_v<float, R>(vecs, sp, writes, n_tiles, tile_vecs, split,         \
                       passes, grid, s, occupancy_only)                     \
      : rw_v<__nv_bfloat16, R>(vecs, sp, writes, n_tiles, tile_vecs, split, \
                               passes, grid, s, occupancy_only)
  SV_R_CASES(SV_CALL)
#undef SV_CALL
}

template <typename T, int R>
static int bulk_r(const sv::Streams& sp, int writes, int n_tiles,
                  long long tile_bytes, int split, int passes, int grid,
                  int chunk, int stages, int smem, cudaStream_t s,
                  int occupancy_only) {
  cudaFuncSetAttribute(sv::sv_bulk<T, R>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (occupancy_only) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sv::sv_bulk<T, R>,
                                                  mb::kThreads, smem);
    return -n;
  }
  sv::sv_bulk<T, R><<<grid, mb::kThreads, smem, s>>>(
      sp, writes, n_tiles, tile_bytes, split, passes, chunk, stages);
  return (int)cudaGetLastError();
}

// smem = stages * reads * chunk (+ 2 * chunk when reads > 1) bytes.
extern "C" int sv_bulk_launch(int dtype, int reads, const void* const* ins,
                              void* const* outs, int writes, int n_tiles,
                              long long tile_bytes, int split, int passes,
                              int grid, int chunk, int stages,
                              int occupancy_only, void* stream) {
  if (writes < 1 || writes > sv::kMaxRw || stages < 3 ||
      stages > sv::kMaxStages || chunk % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = (stages * reads + (reads > 1 ? 2 : 0)) * chunk;
  const sv::Streams sp = make_streams(ins, reads, outs, writes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SV_CALL(R)                                                          \
  return dtype == 0                                                         \
      ? bulk_r<float, R>(sp, writes, n_tiles, tile_bytes, split, passes,    \
                         grid, chunk, stages, smem, s, occupancy_only)      \
      : bulk_r<__nv_bfloat16, R>(sp, writes, n_tiles, tile_bytes, split,    \
                                 passes, grid, chunk, stages, smem, s,      \
                                 occupancy_only)
  SV_R_CASES(SV_CALL)
#undef SV_CALL
}

#endif  // SV_LEAN
