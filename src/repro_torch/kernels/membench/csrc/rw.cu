// R:W-ratio membench kernel (rw_RtoW): per tile, v = s0 + 1.5*s1 + ... +
// 1.5*s_{R-1}, stored to each of W output tiles, once per pass; R, W in 1..8.
//
// Replaces _rw_kernel of src/repro/kernels/membench/membench.py.  With
// interleave = K the tile is split into K row chunks; a thread walks its
// vectors chunk by chunk (K independent fold / store streams), which gives
// the same values as K = 1, as the reference's chunked folds do.
//
// Bound on an H100: bytes, (R + W) buffers per pass; the 2(R-1) flops per
// element are far under the float32 peak.  What the design does about it:
// 16-byte accesses, all R loads of a vector issued before its fold, 4 CTAs
// of 256 threads per SM.
//
// R, W and K are run-time arguments and the stream pointers travel in one
// by-value struct of kMaxRw read and kMaxRw write pointers (kernel parameter
// space): templating over them as well as over the element type and unroll
// would compile 2048 kernels.  The loops over streams run to kMaxRw and are
// unrolled, with a run-time guard, so the R loaded vectors stay in
// registers.
//
// Arithmetic is done in the working type, one rounding per operation, as
// the plain version does it: the product is rounded, then the sum, after
// every stream (float32: __fmul_rn / __fadd_rn, never contracted into an
// FMA; bfloat16: computed in float32 and rounded to bfloat16 after each
// operation), so the kernel agrees with the plain version bit for bit and
// rw_1to1 / rw_2to1 with copy / triad.  The W stores of one vector hold the
// same value; they are volatile inline PTX, so none is merged away.
#include "membench_common.cuh"

namespace mb {

constexpr int kMaxRw = 8;

struct RwStreams {
  const char* in[kMaxRw];
  char* out[kMaxRw];
};

template <typename T>
__device__ __forceinline__ uint4 rw_fold(const uint4* in, int reads) {
  if (reads == 1) return in[0];           // nothing to fold: the bits as read
  float v[Vec<T>::N], s[Vec<T>::N];
  Vec<T>::unpack(in[0], v);
#pragma unroll
  for (int r = 1; r < kMaxRw; ++r) {
    if (r < reads) {
      Vec<T>::unpack(in[r], s);
#pragma unroll
      for (int e = 0; e < Vec<T>::N; ++e)
        v[e] = round_to<T>(__fadd_rn(v[e], round_to<T>(__fmul_rn(1.5f, s[e]))));
    }
  }
  return Vec<T>::pack(v);
}

template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
rw_kernel(RwStreams st, int reads, int writes, int n_tiles, int block_rows,
          int streams, int passes, int interleave) {
  const int seg = n_tiles / streams;
  const size_t tile_bytes = (size_t)block_rows * kLanes * sizeof(T);
  const int nv = (int)(tile_bytes / 16) / interleave;   // vectors per chunk
  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int step = blockIdx.x; step < n_tiles; step += gridDim.x) {
        const size_t tile = walk_tile(step, streams, seg) * tile_bytes;
        for (int i = threadIdx.x; i < nv; i += kThreads) {
          for (int c = 0; c < interleave; ++c) {
            const size_t off = tile + ((size_t)c * nv + i) * 16;
            uint4 in[kMaxRw];
#pragma unroll
            for (int r = 0; r < kMaxRw; ++r)
              if (r < reads) in[r] = ld16(st.in[r] + off);
            const uint4 v = rw_fold<T>(in, reads);
#pragma unroll
            for (int w = 0; w < kMaxRw; ++w)
              if (w < writes) st16(st.out[w] + off, v);
          }
        }
      }
      pass_barrier();
    }
  }
}

}  // namespace mb

template <typename T>
static int launch_rw(const mb::RwStreams& st, int reads, int writes,
                     int n_tiles, int block_rows, int streams, int passes,
                     int unroll, int interleave, int grid, cudaStream_t s) {
#define MB_RW(U)                                                            \
  mb::rw_kernel<T, U><<<grid, mb::kThreads, 0, s>>>(                        \
      st, reads, writes, n_tiles, block_rows, streams, passes, interleave)
  MB_UNROLL_CASES(MB_RW)
#undef MB_RW
  return (int)cudaGetLastError();
}

// ins: `reads` read-stream pointers; outs: `writes` write-stream pointers;
// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError().
extern "C" int membench_rw(int dtype, const void* const* ins, int reads,
                           void* const* outs, int writes, int n_tiles,
                           int block_rows, int streams, int passes,
                           int unroll, int interleave, int grid,
                           void* stream) {
  if (reads < 1 || reads > mb::kMaxRw || writes < 1 || writes > mb::kMaxRw)
    return (int)cudaErrorInvalidValue;
  mb::RwStreams st = {};
  for (int r = 0; r < reads; ++r) st.in[r] = static_cast<const char*>(ins[r]);
  for (int w = 0; w < writes; ++w) st.out[w] = static_cast<char*>(outs[w]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rw<float>(st, reads, writes, n_tiles, block_rows, streams,
                            passes, unroll, interleave, grid, s);
  if (dtype == 1)
    return launch_rw<__nv_bfloat16>(st, reads, writes, n_tiles, block_rows,
                                    streams, passes, unroll, interleave, grid,
                                    s);
  return (int)cudaErrorInvalidValue;
}
