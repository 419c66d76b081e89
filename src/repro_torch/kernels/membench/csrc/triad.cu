// STREAM-triad membench kernel: out = b + 1.5 * c per tile, once per pass
// (2 read streams, 1 write stream).
//
// Replaces _triad_kernel of src/repro/kernels/membench/membench.py.
//
// Bound on an H100: bytes (two buffers read, one written per pass).  The
// walk is cut into blocks of consecutive 16-byte vectors (vector q of the
// walk is vector q % tile_vecs of tile walk_tile(q / tile_vecs)), one vector
// a thread, the two loads issued before the store.  Two grid shapes; the
// wrapper picks one by the working set against the card's L2
// (membench.triad_launch_plan):
//
//  * Above the L2 (the three buffers do not fit): non-persistent.  One
//    block of kTriadNpThreads threads per kTriadNpThreads vectors, in
//    address order, the pass the slow grid dimension: the blocks resident
//    at any moment cover one compact window that moves through the
//    buffers, and a block retires as soon as its vectors are stored.  The
//    persistent grid it replaces (4 CTAs of 256 an SM, each owning whole
//    tiles c, c + G, ...) streamed from 528 tiles spread over the buffers
//    and stayed at 86-88.5 % of 3.35 TB/s whatever its depth of loads in
//    flight; a persistent grid that takes the same blocks as this shape
//    (a compact window) stayed there too, so it is the retiring blocks, not
//    the window, that gain (PERF.md: 2 GiB 2.1588 -> 2.0663 ms f32 against
//    torch.add's 2.0762 by device time, NVIDIA H100 80GB HBM3, 700.00 W,
//    tools/stream_variants.py --sweep triad).
//  * At and below the L2: persistent, so that a CTA reads the same vectors
//    in every pass and L1/L2 reuse across passes is what is measured.  As
//    many CTAs of 256 threads as stay resident (kTriadWinCtas an SM) take
//    blocks c, c + G, ... of 256 vectors in every pass: the work is cut
//    finer than whole tiles, so a 32 KiB buffer (one tile) is no longer one
//    CTA's.
//
// Arithmetic is done in the working type, one rounding per operation, as the
// reference does it: the product is rounded, then the sum (for bfloat16 both
// are computed in float32 and rounded to bfloat16; for float32 the multiply
// and the add are kept apart, not contracted into one FMA), so the kernel
// agrees with the plain version bit for bit.
#include "membench_common.cuh"

namespace mb {

constexpr int kTriadNpThreads = 1024;     // threads (= vectors) a block
constexpr int kTriadWinCtas = 8;          // persistent CTAs of kThreads an SM

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

// vector q of block blk (THREADS vectors a block) of the walk, if it exists
template <typename T, int THREADS>
__device__ __forceinline__ void triad_block(const char* b, const char* c,
                                            char* out, long long blk,
                                            long long total, int tile_vecs,
                                            int streams, int seg) {
  const long long q = blk * THREADS + threadIdx.x;
  if (q >= total) return;
  size_t off = (size_t)q * 16;
  if (streams > 1) {
    const long long step = q / tile_vecs;
    off = ((size_t)walk_tile((int)step, streams, seg) * tile_vecs +
           (size_t)(q - step * tile_vecs)) * 16;
  }
  const uint4 bv = ld16(b + off);
  const uint4 cv = ld16(c + off);
  st16(out + off, triad_vec<T>(bv, cv));
}

template <typename T>
__global__ void __launch_bounds__(kTriadNpThreads)
triad_np(const char* b, const char* c, char* out, int n_tiles, int tile_vecs,
         int streams) {
  triad_block<T, kTriadNpThreads>(b, c, out, blockIdx.x,
                                  (long long)n_tiles * tile_vecs, tile_vecs,
                                  streams, n_tiles / streams);
}

template <typename T, int U>
__global__ void __launch_bounds__(kThreads, kTriadWinCtas)
triad_win(const char* b, const char* c, char* out, int n_tiles, int tile_vecs,
          int streams, int passes) {
  const long long total = (long long)n_tiles * tile_vecs;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int seg = n_tiles / streams;
  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x)
        triad_block<T, kThreads>(b, c, out, blk, total, tile_vecs, streams,
                                 seg);
      pass_barrier();
    }
  }
}

}  // namespace mb

template <typename T>
static int launch_triad(const void* b, const void* c, void* out, int n_tiles,
                        int block_rows, int streams, int passes, int unroll,
                        int shape, int grid, cudaStream_t st) {
  const char* bp = static_cast<const char*>(b);
  const char* cp = static_cast<const char*>(c);
  char* op = static_cast<char*>(out);
  const int tile_vecs = (int)((size_t)block_rows * mb::kLanes * sizeof(T) / 16);
  if (shape == 1) {                      // non-persistent: passes on grid.y
    const long long blocks =
        ((long long)n_tiles * tile_vecs + mb::kTriadNpThreads - 1) /
        mb::kTriadNpThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    for (int p = 0; p < passes; p += 65535) {
      const int n = passes - p < 65535 ? passes - p : 65535;
      mb::triad_np<T><<<dim3((unsigned)blocks, (unsigned)n),
                        mb::kTriadNpThreads, 0, st>>>(bp, cp, op, n_tiles,
                                                      tile_vecs, streams);
    }
    return (int)cudaGetLastError();
  }
  if (shape != 0) return (int)cudaErrorInvalidValue;
#define MB_TRIAD(U)                                                         \
  mb::triad_win<T, U><<<grid, mb::kThreads, 0, st>>>(bp, cp, op, n_tiles,   \
                                                     tile_vecs, streams,    \
                                                     passes)
  MB_UNROLL_CASES(MB_TRIAD)
#undef MB_TRIAD
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16.  shape: 0 persistent (grid CTAs of
// mb::kThreads, the pass loop inside, unrolled `unroll` times), 1
// non-persistent (grid computed here; `grid` and `unroll` unused).
// Returns cudaGetLastError().
extern "C" int membench_triad(int dtype, const void* b, const void* c,
                              void* out, int n_tiles, int block_rows,
                              int streams, int passes, int unroll, int shape,
                              int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_triad<float>(b, c, out, n_tiles, block_rows, streams,
                               passes, unroll, shape, grid, st);
  if (dtype == 1)
    return launch_triad<__nv_bfloat16>(b, c, out, n_tiles, block_rows,
                                       streams, passes, unroll, shape, grid,
                                       st);
  return (int)cudaErrorInvalidValue;
}
