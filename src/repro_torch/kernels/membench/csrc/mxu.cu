// The matrix-unit membench kernel: per tile (block_rows,128) @ w(128,128)
// with float32 accumulation; y[0,0] of every tile is added up.
//
// Replaces _acc_kernel + _mix_body("mxu") of
// src/repro/kernels/membench/membench.py (operand eye(128) built by the
// caller, as the reference's membench_call does).
//
// Bound on an H100: operations (2*128 flops per element against 4 or 2 bytes).
// This first version is right and simple: the tile is staged through shared
// memory 8 rows at a time (widened to float32), each of the 256 threads owns
// one output column and 4 of the 8 rows, reads x as broadcast float4 from
// shared memory and w through the L1-cached global path, and runs plain
// float32 FMAs.  bfloat16 inputs take the same path (exact: the products of
// bfloat16 values are exact in float32).  Tensor cores (wgmma) are left to a
// later change.
//
// All of y is computed, not only y[0,0]: every output is also folded into a
// checksum that the kernel returns beside the y[0,0] sum, so no part of the
// product is dead code.  With w = eye the checksum equals the sum of x.
#include "membench_common.cuh"

namespace mb {

template <typename T> __device__ __forceinline__ float w_elem(const T* w, int i);
template <> __device__ __forceinline__ float w_elem<float>(const float* w, int i) {
  return __ldg(w + i);
}
template <>
__device__ __forceinline__ float w_elem<__nv_bfloat16>(const __nv_bfloat16* w,
                                                       int i) {
  const uint32_t h = __ldg(reinterpret_cast<const unsigned short*>(w) + i);
  return __uint_as_float(h << 16);
}

template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
mxu_kernel(const char* x, const T* w, float* partials, int n_tiles,
           int block_rows, int streams, int passes) {
  constexpr int kRows = 8;                       // rows staged per chunk
  constexpr int kChunkBytes = kRows * kLanes * sizeof(T);
  constexpr int kChunkVecs = kChunkBytes / 16;
  __shared__ __align__(16) float xs[kRows][kLanes];

  const int seg = n_tiles / streams;
  const size_t tile_bytes = (size_t)block_rows * kLanes * sizeof(T);
  const int cpt = block_rows / kRows;
  const int col = threadIdx.x % kLanes;
  const int r0 = (threadIdx.x / kLanes) * 4;     // rows r0 .. r0+3
  float y00 = 0.0f, checksum = 0.0f;

  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int step = blockIdx.x; step < n_tiles; step += gridDim.x) {
        const char* tile = x + walk_tile(step, streams, seg) * tile_bytes;
        for (int c = 0; c < cpt; ++c) {
          const char* chunk = tile + (size_t)c * kChunkBytes;
          __syncthreads();                       // xs free to overwrite
          for (int i = threadIdx.x; i < kChunkVecs; i += kThreads) {
            float f[Vec<T>::N];
            Vec<T>::unpack(ld16(chunk + (size_t)i * 16), f);
            float* dst = &xs[0][0] + i * Vec<T>::N;
#pragma unroll
            for (int e = 0; e < Vec<T>::N; ++e) dst[e] = f[e];
          }
          __syncthreads();
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int k = 0; k < kLanes; k += 4) {
            float wv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) wv[i] = w_elem<T>(w, (k + i) * kLanes + col);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float4 xv =
                  *reinterpret_cast<const float4*>(&xs[r0 + r][k]);
              acc[r] = fmaf(xv.x, wv[0], acc[r]);
              acc[r] = fmaf(xv.y, wv[1], acc[r]);
              acc[r] = fmaf(xv.z, wv[2], acc[r]);
              acc[r] = fmaf(xv.w, wv[3], acc[r]);
            }
          }
          checksum += (acc[0] + acc[1]) + (acc[2] + acc[3]);
          if (c == 0 && threadIdx.x == 0) y00 += acc[0];   // y[0,0] of the tile
        }
      }
      pass_barrier();
    }
  }
  y00 = block_sum(y00);
  if (threadIdx.x == 0) partials[blockIdx.x] = y00;
  checksum = block_sum(checksum);
  if (threadIdx.x == 0) partials[gridDim.x + blockIdx.x] = checksum;
}

}  // namespace mb

template <typename T>
static int launch_mxu(const void* x, const void* w, float* partials,
                      float* out, int n_tiles, int block_rows, int streams,
                      int passes, int unroll, int grid, cudaStream_t st) {
#define MB_MXU(U)                                                           \
  mb::mxu_kernel<T, U><<<grid, mb::kThreads, 0, st>>>(                      \
      static_cast<const char*>(x), static_cast<const T*>(w), partials,      \
      n_tiles, block_rows, streams, passes)
  MB_UNROLL_CASES(MB_MXU)
#undef MB_MXU
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mb::fold_partials<<<2, mb::kThreads, 0, st>>>(partials, grid, out);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16 (x and w alike).  partials: float[2 * grid];
// out: float[2] = {sum of y[0,0] per tile, checksum of all of y}.
extern "C" int membench_mxu(int dtype, const void* x, const void* w,
                            float* partials, float* out, int n_tiles,
                            int block_rows, int streams, int passes,
                            int unroll, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mxu<float>(x, w, partials, out, n_tiles, block_rows,
                             streams, passes, unroll, grid, st);
  if (dtype == 1)
    return launch_mxu<__nv_bfloat16>(x, w, partials, out, n_tiles, block_rows,
                                     streams, passes, unroll, grid, st);
  return (int)cudaErrorInvalidValue;
}
