// STREAM-triad membench kernel: out = b + 1.5 * c per tile, once per pass
// (2 read streams, 1 write stream).
//
// Replaces _triad_kernel of src/repro/kernels/membench/membench.py.
//
// Bound on an H100: bytes (two buffers read, one written per pass).  What the
// design does about it: 16-byte accesses, 2 x 2 loads in flight per thread
// before the first store, 4 CTAs of 256 threads per SM.
//
// Arithmetic is done in the working type, one rounding per operation, as the
// reference does it: the product is rounded, then the sum (for bfloat16 both
// are computed in float32 and rounded to bfloat16; for float32 the multiply
// and the add are kept apart, not contracted into one FMA), so the kernel
// agrees with the plain version bit for bit.
#include "membench_common.cuh"

namespace mb {

template <typename T>
__device__ __forceinline__ uint4 triad_vec(uint4 bv, uint4 cv) {
  float b[Vec<T>::N], c[Vec<T>::N];
  Vec<T>::unpack(bv, b);
  Vec<T>::unpack(cv, c);
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e)
    b[e] = __fadd_rn(b[e], round_to<T>(__fmul_rn(1.5f, c[e])));
  return Vec<T>::pack(b);
}

template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
triad_kernel(const char* b, const char* c, char* out, int n_tiles,
             int block_rows, int streams, int passes) {
  const int seg = n_tiles / streams;
  const size_t tile_bytes = (size_t)block_rows * kLanes * sizeof(T);
  const int nv = (int)(tile_bytes / 16);
  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int step = blockIdx.x; step < n_tiles; step += gridDim.x) {
        const size_t off = walk_tile(step, streams, seg) * tile_bytes;
        for (int i0 = threadIdx.x; i0 < nv; i0 += 2 * kThreads) {
          uint4 rb[2], rc[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int i = i0 + j * kThreads;
            if (i < nv) {
              rb[j] = ld16(b + off + (size_t)i * 16);
              rc[j] = ld16(c + off + (size_t)i * 16);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int i = i0 + j * kThreads;
            if (i < nv)
              st16(out + off + (size_t)i * 16, triad_vec<T>(rb[j], rc[j]));
          }
        }
      }
      pass_barrier();
    }
  }
}

}  // namespace mb

template <typename T>
static int launch_triad(const void* b, const void* c, void* out, int n_tiles,
                        int block_rows, int streams, int passes, int unroll,
                        int grid, cudaStream_t st) {
#define MB_TRIAD(U)                                                         \
  mb::triad_kernel<T, U><<<grid, mb::kThreads, 0, st>>>(                    \
      static_cast<const char*>(b), static_cast<const char*>(c),             \
      static_cast<char*>(out), n_tiles, block_rows, streams, passes)
  MB_UNROLL_CASES(MB_TRIAD)
#undef MB_TRIAD
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError().
extern "C" int membench_triad(int dtype, const void* b, const void* c,
                              void* out, int n_tiles, int block_rows,
                              int streams, int passes, int unroll, int grid,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_triad<float>(b, c, out, n_tiles, block_rows, streams,
                               passes, unroll, grid, st);
  if (dtype == 1)
    return launch_triad<__nv_bfloat16>(b, c, out, n_tiles, block_rows,
                                       streams, passes, unroll, grid, st);
  return (int)cudaErrorInvalidValue;
}
