// Scalar-accumulating membench kernels: load_sum, load_only, fma.
//
// Replaces _acc_kernel + _mix_body("load_sum" | "load_only" | "fma") of
// src/repro/kernels/membench/membench.py.  Each returns, through a scratch
// vector of per-CTA partials and fold_partials, the float32 sum over all
// passes and tiles of the tile's contribution:
//   load_sum   sum of every element (interleave = K: K row chunks of the
//              tile summed by K independent accumulators, combined per tile)
//   load_only  element [0,0] of the tile; the whole tile is still moved
//   fma        sum over elements of a depth-long chain v = fma(v, a, b)
//
// Bound on an H100: bytes (each buffer byte read once per pass) except fma
// at large depth, which is bound by float32 FMA throughput.  What the design does
// about it: 16-byte accesses, four (or K) loads in flight per thread before
// the first use, 4 CTAs of 256 threads per SM.
//
// load_only is pure data movement: every 16-byte vector goes global -> shared
// memory by cp.async, so no loaded value passes through a register and no
// arithmetic runs, and the copies cannot be deleted (they write shared
// memory).  Each thread runs its own 8-stage ring (7 copies in flight), over
// the vectors t, t + 256, ... of its CTA's share of the pass, whatever the
// element type or tile height.  The thread that copied the first vector of a
// tile reads element [0,0] from its own slot; its own wait_group orders that
// read, so the kernel has no CTA barrier.
#include "membench_common.cuh"

namespace mb {

template <typename T, int K>
__device__ __forceinline__ float tile_sum(const char* tile, int nv) {
  // nv = 16-byte vectors per row chunk (K chunks per tile)
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.0f;
  if (K == 1) {
    for (int i0 = threadIdx.x; i0 < nv; i0 += 4 * kThreads) {
      uint4 r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * kThreads;
        r[j] = make_uint4(0u, 0u, 0u, 0u);       // +0.0 in either type
        if (i < nv) r[j] = ld16(tile + (size_t)i * 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0] += vec_sum<T>(r[j]);
    }
  } else {
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 r[K];
#pragma unroll
      for (int j = 0; j < K; ++j)               // K independent chains
        r[j] = ld16(tile + ((size_t)j * nv + i) * 16);
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] += vec_sum<T>(r[j]);
    }
  }
  float s = acc[0];
#pragma unroll
  for (int j = 1; j < K; ++j) s += acc[j];      // combined at the tile's end
  return s;
}

template <typename T>
__device__ __forceinline__ float tile_fma(const char* tile, int nv, int depth) {
  const float a = 1.0000001f, b = 1e-9f;
  float acc = 0.0f;
  for (int i0 = threadIdx.x; i0 < nv; i0 += 4 * kThreads) {
    uint4 r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * kThreads;
      r[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nv) r[j] = ld16(tile + (size_t)i * 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j * kThreads < nv) {             // chain(0) is not 0: skip pads
        float f[Vec<T>::N];
        Vec<T>::unpack(r[j], f);
        for (int d = 0; d < depth; ++d) {
#pragma unroll
          for (int e = 0; e < Vec<T>::N; ++e) f[e] = fmaf(f[e], a, b);
        }
#pragma unroll
        for (int e = 0; e < Vec<T>::N; ++e) acc += f[e];
      }
    }
  }
  return acc;
}

// MIX: 0 = load_sum, 2 = fma
template <typename T, int U, int K, int MIX>
__global__ void __launch_bounds__(kThreads)
acc_kernel(const char* x, float* partials, int n_tiles, int block_rows,
           int streams, int passes, int depth) {
  const int seg = n_tiles / streams;
  const size_t tile_bytes = (size_t)block_rows * kLanes * sizeof(T);
  const int nv = (int)(tile_bytes / 16) / K;
  float total = 0.0f;
  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int step = blockIdx.x; step < n_tiles; step += gridDim.x) {
        const char* tile = x + walk_tile(step, streams, seg) * tile_bytes;
        if (MIX == 0) total += tile_sum<T, K>(tile, nv);
        else total += tile_fma<T>(tile, nv, depth);
      }
      pass_barrier();
    }
  }
  total = block_sum(total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// ---- load_only: cp.async ring ---------------------------------------------

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

// element 0 of a ring stage, read past the compiler's view of shared memory
template <typename T>
__device__ __forceinline__ float smem_elem0(const unsigned char* p);
template <>
__device__ __forceinline__ float smem_elem0<float>(const unsigned char* p) {
  return *reinterpret_cast<const volatile float*>(p);
}
template <>
__device__ __forceinline__ float smem_elem0<__nv_bfloat16>(
    const unsigned char* p) {
  const uint32_t h = *reinterpret_cast<const volatile unsigned short*>(p);
  return __uint_as_float(h << 16);
}

// where a thread's next 16-byte vector lies in its CTA's share of a pass:
// vector `off` of the CTA's `tile`-th tile.  Advancing by the CTA's width
// needs no division (a tile holds at least kThreads / 2 vectors).
struct Cursor {
  int tile, off;
  __device__ __forceinline__ void start(int tile_vecs) {
    tile = 0;
    off = threadIdx.x;
    settle(tile_vecs);
  }
  __device__ __forceinline__ void advance(int tile_vecs) {
    off += kThreads;
    settle(tile_vecs);
  }
  __device__ __forceinline__ void settle(int tile_vecs) {
    while (off >= tile_vecs) { off -= tile_vecs; ++tile; }
  }
};

template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
load_only_kernel(const char* x, float* partials, int n_tiles, int block_rows,
                 int streams, int passes) {
  constexpr int kStages = 8;
  // one 16-byte slot per thread and stage: every thread runs its own ring
  __shared__ __align__(16) unsigned char ring[kStages][kThreads][16];

  const int seg = n_tiles / streams;
  const size_t tile_bytes = (size_t)block_rows * kLanes * sizeof(T);
  const int tile_vecs = (int)(tile_bytes / 16);
  const int my_tiles =
      (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // slots per pass: slot q holds vectors q * kThreads .. of the CTA's share
  const long long n_slots =
      ((long long)my_tiles * tile_vecs + kThreads - 1) / kThreads;

  float total = 0.0f;
  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Cursor put, get;            // next vector to request / to retire
      put.start(tile_vecs);
      get.start(tile_vecs);
      auto request = [&](long long q) {
        if (put.tile < my_tiles) {
          const int step = blockIdx.x + put.tile * gridDim.x;
          const char* src = x + walk_tile(step, streams, seg) * tile_bytes +
                            (size_t)put.off * 16;
          cp_async16(ring[q % kStages][threadIdx.x], src);
          put.advance(tile_vecs);
        }
        cp_async_commit();        // one group per slot, empty or not
      };
      for (int s = 0; s < kStages - 1; ++s) request(s);
      for (long long q = 0; q < n_slots; ++q) {
        cp_async_wait<kStages - 2>();            // this thread's slot q landed
        if (get.tile < my_tiles) {
          if (get.off == 0)                      // element [0,0] of a tile
            total += smem_elem0<T>(ring[q % kStages][threadIdx.x]);
          get.advance(tile_vecs);
        }
        request(q + kStages - 1);
      }
      cp_async_wait<0>();
      pass_barrier();
    }
  }
  total = block_sum(total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

}  // namespace mb

using mb::kThreads;

template <typename T>
static int launch_acc(int mix, const void* x, float* partials, float* out,
                      int n_tiles, int block_rows, int streams, int passes,
                      int unroll, int interleave, int depth, int grid,
                      cudaStream_t st) {
  const char* xc = static_cast<const char*>(x);
#define MB_SUM(U)                                                           \
  switch (interleave) {                                                     \
    case 1: mb::acc_kernel<T, U, 1, 0><<<grid, kThreads, 0, st>>>(          \
                xc, partials, n_tiles, block_rows, streams, passes, depth); \
      break;                                                                \
    case 2: mb::acc_kernel<T, U, 2, 0><<<grid, kThreads, 0, st>>>(          \
                xc, partials, n_tiles, block_rows, streams, passes, depth); \
      break;                                                                \
    case 4: mb::acc_kernel<T, U, 4, 0><<<grid, kThreads, 0, st>>>(          \
                xc, partials, n_tiles, block_rows, streams, passes, depth); \
      break;                                                                \
    case 8: mb::acc_kernel<T, U, 8, 0><<<grid, kThreads, 0, st>>>(          \
                xc, partials, n_tiles, block_rows, streams, passes, depth); \
      break;                                                                \
    default: return (int)cudaErrorInvalidValue;                             \
  }
#define MB_ONLY(U)                                                          \
  mb::load_only_kernel<T, U><<<grid, kThreads, 0, st>>>(                    \
      xc, partials, n_tiles, block_rows, streams, passes)
#define MB_FMA(U)                                                           \
  mb::acc_kernel<T, U, 1, 2><<<grid, kThreads, 0, st>>>(                    \
      xc, partials, n_tiles, block_rows, streams, passes, depth)
  if (mix == 0) { MB_UNROLL_CASES(MB_SUM) }
  else if (mix == 1) { MB_UNROLL_CASES(MB_ONLY) }
  else if (mix == 2) { MB_UNROLL_CASES(MB_FMA) }
  else return (int)cudaErrorInvalidValue;
#undef MB_SUM
#undef MB_ONLY
#undef MB_FMA
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mb::fold_partials<<<1, kThreads, 0, st>>>(partials, grid, out);
  return (int)cudaGetLastError();
}

// mix: 0 load_sum, 1 load_only, 2 fma.  dtype: 0 float32, 1 bfloat16.
// partials: float[grid] scratch; out: float[1].  Returns cudaGetLastError().
extern "C" int membench_acc(int mix, int dtype, const void* x, float* partials,
                            float* out, int n_tiles, int block_rows,
                            int streams, int passes, int unroll,
                            int interleave, int depth, int grid,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_acc<float>(mix, x, partials, out, n_tiles, block_rows,
                             streams, passes, unroll, interleave, depth, grid,
                             st);
  if (dtype == 1)
    return launch_acc<__nv_bfloat16>(mix, x, partials, out, n_tiles,
                                     block_rows, streams, passes, unroll,
                                     interleave, depth, grid, st);
  return (int)cudaErrorInvalidValue;
}
