// R:W-ratio membench kernel (rw_RtoW): per tile, v = s0 + 1.5*s1 + ... +
// 1.5*s_{R-1}, stored to each of W output tiles, once per pass; R, W in 1..8.
//
// Replaces _rw_kernel of src/repro/kernels/membench/membench.py.  With
// interleave = K the tile is split into K row chunks, walked side by side
// (K independent fold / store streams), which gives the same values as
// K = 1, as the reference's chunked folds do.
//
// Bound on an H100: bytes, (R + W) buffers per pass; the 2(R-1) flops per
// element are far under the float32 peak.  What the design does about it
// (stream.cuh): the kernel is a template over R, so the R loads of a vector
// are straight-line code and its operands stay in registers, and each
// thread keeps kRwVecs[R] 16-byte vectors of each read stream in flight
// before its first store (about four loads in all), in CTAs compiled to
// stay kRwCtas an SM.  The work split is the tile walk of the other
// membench kernels.  Timed against the alternatives (more vectors in
// flight, other CTA counts, the last round's tiles cut over all CTAs, cache
// hints, bulk copies through shared memory) by tools/stream_variants.py;
// PERF.md has the numbers.
//
// The kernel is a template over the element type, R and unroll (60
// kernels: R = 1 moves bits, one element type serves); W and K are run-time
// arguments, and the stream pointers travel in one by-value
// __grid_constant__ struct of 8 read and 8 write pointers (kernel parameter
// space).
//
// Arithmetic is done in the working type, one rounding per operation, as
// the plain version does it: the product is rounded, then the sum, after
// every stream (float32: __fmul_rn / __fadd_rn, never contracted into an
// FMA; bfloat16: computed in float32 and rounded to bfloat16 after each
// operation), so the kernel agrees with the plain version bit for bit and
// rw_1to1 / rw_2to1 with copy / triad.  The W stores of one vector hold the
// same value; they are volatile inline PTX, so none is merged away.
#include "stream.cuh"

namespace mb {

// per R (index 1..8): 16-byte vectors a thread keeps in flight per read
// stream, about four loads in all (V = max(1, 4 / R)); with 4 resident CTAs
// of 256 threads an SM (the grid's membench.CTAS_PER_SM; __launch_bounds__
// holds a thread to the 64 registers that leaves it)
constexpr int kRwVecs[kMaxStreams + 1] = {0, 4, 2, 1, 1, 1, 1, 1, 1};
constexpr int kRwCtas = 4;

template <typename T, int R>
__device__ __forceinline__ uint4 rw_fold(const uint4* in) {
  if (R == 1) return in[0];               // nothing to fold: the bits as read
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

template <typename T, int R, int U>
__global__ void __launch_bounds__(kThreads, kRwCtas)
rw_kernel(const __grid_constant__ StreamPtrs st, int writes, int n_tiles,
          int units, int K, int streams, int passes) {
  stream_passes<R, kRwVecs[R], 0, U>(
      st, writes, n_tiles, units, K, streams, passes,
      [](const uint4* in) { return rw_fold<T, R>(in); });
}

}  // namespace mb

template <typename T, int R>
static int launch_rw(const mb::StreamPtrs& st, int writes, int n_tiles,
                     int units, int K, int streams, int passes, int unroll,
                     int grid, cudaStream_t s) {
#define MB_RW(U)                                                            \
  mb::rw_kernel<T, R, U><<<grid, mb::kThreads, 0, s>>>(                     \
      st, writes, n_tiles, units, K, streams, passes)
  MB_UNROLL_CASES(MB_RW)
#undef MB_RW
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_rw_r(int reads, const mb::StreamPtrs& st, int writes,
                       int n_tiles, int units, int K, int streams,
                       int passes, int unroll, int grid, cudaStream_t s) {
  switch (reads) {
#define MB_RW_R(R)                                                          \
    case R: return launch_rw<T, R>(st, writes, n_tiles, units, K, streams,  \
                                   passes, unroll, grid, s);
    // R = 1 folds nothing: the bits as read, one kernel for both dtypes
    case 1: return launch_rw<float, 1>(st, writes, n_tiles, units, K,
                                       streams, passes, unroll, grid, s);
    MB_RW_R(2) MB_RW_R(3) MB_RW_R(4)
    MB_RW_R(5) MB_RW_R(6) MB_RW_R(7) MB_RW_R(8)
#undef MB_RW_R
    default: return (int)cudaErrorInvalidValue;
  }
}

// ins: `reads` read-stream pointers; outs: `writes` write-stream pointers;
// dtype: 0 float32, 1 bfloat16; grid from membench.grid_size.  Returns
// cudaGetLastError().
extern "C" int membench_rw(int dtype, const void* const* ins, int reads,
                           void* const* outs, int writes, int n_tiles,
                           int block_rows, int streams, int passes,
                           int unroll, int interleave, int grid,
                           void* stream) {
  if (reads < 1 || reads > mb::kMaxStreams || writes < 1 ||
      writes > mb::kMaxStreams ||
      (interleave != 1 && interleave != 2 && interleave != 4 &&
       interleave != 8))
    return (int)cudaErrorInvalidValue;
  mb::StreamPtrs st = {};
  for (int r = 0; r < reads; ++r) st.in[r] = static_cast<const char*>(ins[r]);
  for (int w = 0; w < writes; ++w) st.out[w] = static_cast<char*>(outs[w]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rw_r<float>(reads, st, writes, n_tiles,
                              block_rows * mb::kLanes * 4 / 16 / interleave,
                              interleave, streams, passes, unroll, grid, s);
  if (dtype == 1)
    return launch_rw_r<__nv_bfloat16>(
        reads, st, writes, n_tiles,
        block_rows * mb::kLanes * 2 / 16 / interleave, interleave, streams,
        passes, unroll, grid, s);
  return (int)cudaErrorInvalidValue;
}
