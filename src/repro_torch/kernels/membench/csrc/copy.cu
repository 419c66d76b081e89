// STREAM-copy membench kernel: out[tile] = x[tile], once per pass.
//
// Replaces _copy_kernel of src/repro/kernels/membench/membench.py.  With
// interleave = K the tile is split into K row chunks that are copied as K
// independent load/store streams (K loads in flight, then K stores).
//
// Bound on an H100: bytes (each byte read once and written once per pass).
// What the design does about it: 16-byte accesses, 4 (or K) loads in flight
// per thread before the first store, 4 CTAs of 256 threads per SM.  The copy
// moves bytes, so one kernel serves every element type.  Each pass rewrites
// the same output with the same values; the stores are volatile inline PTX,
// so no pass's stores are merged away.  The reference carries one output slot
// per unrolled sweep only to keep XLA from narrowing the sweeps; one output
// buffer is enough here.
#include "membench_common.cuh"

namespace mb {

template <int K>
__device__ __forceinline__ void tile_copy(const char* src, char* dst, int nv) {
  // nv = 16-byte vectors per row chunk (K chunks per tile)
  if (K == 1) {
    for (int i0 = threadIdx.x; i0 < nv; i0 += 4 * kThreads) {
      uint4 r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * kThreads;
        if (i < nv) r[j] = ld16(src + (size_t)i * 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * kThreads;
        if (i < nv) st16(dst + (size_t)i * 16, r[j]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 r[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        r[j] = ld16(src + ((size_t)j * nv + i) * 16);
#pragma unroll
      for (int j = 0; j < K; ++j)               // K separate store streams
        st16(dst + ((size_t)j * nv + i) * 16, r[j]);
    }
  }
}

template <int U, int K>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const char* x, char* out, int n_tiles, long long tile_bytes,
            int streams, int passes) {
  const int seg = n_tiles / streams;
  const int nv = (int)(tile_bytes / 16) / K;
  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int step = blockIdx.x; step < n_tiles; step += gridDim.x) {
        const long long off = walk_tile(step, streams, seg) * tile_bytes;
        tile_copy<K>(x + off, out + off, nv);
      }
      pass_barrier();
    }
  }
}

}  // namespace mb

// tile_bytes = block_rows * 128 * element size.  Returns cudaGetLastError().
extern "C" int membench_copy(const void* x, void* out, int n_tiles,
                             long long tile_bytes, int streams, int passes,
                             int unroll, int interleave, int grid,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const char* xc = static_cast<const char*>(x);
  char* oc = static_cast<char*>(out);
#define MB_COPY(U)                                                          \
  switch (interleave) {                                                     \
    case 1: mb::copy_kernel<U, 1><<<grid, mb::kThreads, 0, st>>>(           \
                xc, oc, n_tiles, tile_bytes, streams, passes); break;       \
    case 2: mb::copy_kernel<U, 2><<<grid, mb::kThreads, 0, st>>>(           \
                xc, oc, n_tiles, tile_bytes, streams, passes); break;       \
    case 4: mb::copy_kernel<U, 4><<<grid, mb::kThreads, 0, st>>>(           \
                xc, oc, n_tiles, tile_bytes, streams, passes); break;       \
    case 8: mb::copy_kernel<U, 8><<<grid, mb::kThreads, 0, st>>>(           \
                xc, oc, n_tiles, tile_bytes, streams, passes); break;       \
    default: return (int)cudaErrorInvalidValue;                             \
  }
  MB_UNROLL_CASES(MB_COPY)
#undef MB_COPY
  return (int)cudaGetLastError();
}
