// The matrix-unit membench kernel: per tile (block_rows,128) @ w(128,128)
// with float32 accumulation; y[0,0] of every tile is added up.
//
// Replaces _acc_kernel + _mix_body("mxu") of
// src/repro/kernels/membench/membench.py (operand eye(128) built by the
// caller, as the reference's membench_call does; any dense w is taken as it
// is — no identity shortcut).
//
// All of y is computed, not only y[0,0]: every output is also folded into a
// checksum that the kernel returns beside the y[0,0] sum, so no part of the
// product is dead code.  With w = eye the checksum equals the sum of x.
//
// Both routes share one pipeline: the CTA's tiles (walk steps c, c+G, ... of
// every pass) are cut into chunks of rows, and the chunks stream through a
// ring of kStages shared-memory slots with cp.async (16 bytes a thread, the
// copies of the next kStages-1 chunks in flight while one chunk computes).
// The ring runs on across tile and pass boundaries, so a pass starts with its
// first chunks already in flight; every chunk of every pass is still copied
// once (volatile inline PTX), and pass_barrier() closes each pass.
//
// bfloat16 route — the tensor cores.  The products of bfloat16 values are
// exact in float32, so mma.sync.m16n8k16 (bf16 in, float32 accumulators)
// computes the function the float32 FMAs computed.  Bound on an H100: bytes
// (2.75e11 flops at 2 GiB take 0.28 ms at the bf16 tensor rate against 0.64
// ms for the bytes).  8 warps; warp w owns the 32 columns 32 (w % 4) .. +31
// of y and keeps its slice of w in registers as mma B fragments for the whole
// kernel (64 registers a thread, read once from global memory, so w needs no
// shared memory); warps w < 4 and w >= 4 take alternate pairs of 16-row
// slabs of a chunk (two independent accumulator chains a warp, the next
// k-step's A fragments loaded while the current one's products run).  Only
// x goes through shared memory: 128-row chunks (32 KiB) in 2 slots, each
// row's 16-byte pieces XOR-swizzled by (row % 8) so that an ldmatrix of 8
// rows touches 8 distinct bank groups.  A tile whose rows are an odd
// multiple of 8 ends in a half slab: its rows 8..15 enter the product as
// zeros.  64 KiB of dynamic shared memory, 2 CTAs per SM.  It runs at
// ~1.3x the byte bound (PERF.md, PR 14); what may hold it there, not yet
// measured apart: every column warp reads the whole slab through ldmatrix
// (4x the bytes of x in shared-memory reads), and the ring synchronises the
// CTA once per chunk.
//
// float32 route — exact float32 on the CUDA cores (TF32 would round x to 10
// mantissa bits: another function).  Bound on an H100: operations (2.05 ms at
// 2 GiB at 67 TFLOP/s).  w (64 KiB) is copied once per CTA into shared
// memory; x arrives in 128-row chunks (64 KiB) in 2 slots.  Each of the 256
// threads owns an 8 x 8 block of y — rows 8i..8i+7 of the chunk, columns
// 4j..4j+3 and 64+4j..64+4j+3 — and per 4 steps of k reads 8 float4 of x (2
// distinct rows per warp: broadcast) and 8 float4 of w (256 contiguous bytes
// per warp: no bank conflict) for 256 FMAs.  192 KiB of dynamic shared
// memory, 1 CTA per SM.
//
// The launch plan (CTAs per SM, shared memory) is mirrored by
// membench.mxu_launch_plan.
#include "membench_common.cuh"
#include "../../tensor_core.cuh"

namespace mb {

struct MxuBf16 {
  using T = __nv_bfloat16;
  static constexpr int kRowBytes = kLanes * 2;                  // 256
  static constexpr int kChunkRows = 128;
  static constexpr int kStages = 2;
  static constexpr int kChunkBytes = kChunkRows * kRowBytes;    // 32 KiB
  static constexpr int kWBytes = 0;                             // w in registers
  static constexpr int kMinBlocks = 2;                          // CTAs per SM

  uint32_t b[4][8][2];   // B fragments: [n-tile of 8 columns][k-step][reg]
  int slab0;             // first 16-row slab of a chunk this warp takes

  __device__ __forceinline__ void init(const T* w, char*) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int col0 = (warp % 4) * 32;
    slab0 = warp / 4;
    const unsigned short* wh = reinterpret_cast<const unsigned short*>(w);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = col0 + nt * 8 + g;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int k = kk * 16 + 2 * t;
        b[nt][kk][0] = (uint32_t)__ldg(wh + k * kLanes + n) |
                       ((uint32_t)__ldg(wh + (k + 1) * kLanes + n) << 16);
        b[nt][kk][1] = (uint32_t)__ldg(wh + (k + 8) * kLanes + n) |
                       ((uint32_t)__ldg(wh + (k + 9) * kLanes + n) << 16);
      }
    }
  }

  // 16-byte piece c of chunk row r sits at piece c ^ (r % 8) of its row
  __device__ static __forceinline__ int piece(int r, int c) {
    return r * kRowBytes + ((c ^ (r & 7)) << 4);
  }

  __device__ static __forceinline__ void stage(char* dst, const char* src,
                                               int rows) {
    for (int i = threadIdx.x; i < rows * (kRowBytes / 16); i += kThreads)
      tc::cp_async16(dst + piece(i / 16, i % 16), src + (size_t)i * 16);
  }

  // Warps w < 4 take slab pairs (0, 1), (4, 5), ... of the chunk, warps w
  // >= 4 the pairs (2, 3), (6, 7), ...: two independent accumulator chains
  // per warp, and the A fragments of k-step kk+1 are loaded while the
  // products of k-step kk run.  A slab past the chunk's end enters as zeros.
  __device__ __forceinline__ void compute(const char* chunk, int rows,
                                          bool tile_start, float& checksum,
                                          float& y00) const {
    const int lane = threadIdx.x % 32;
    const int n_slabs = (rows + 15) / 16;
    for (int sl = 2 * slab0; sl < n_slabs; sl += 4) {
      // rows past the chunk's end: all 16 of slab sl+1 when it lies beyond,
      // rows 8..15 of the last slab when the tile ends in a half slab
      const bool full1 = (sl + 1) * 16 < rows;
      const bool half0 = sl * 16 + 8 == rows;
      const bool half1 = (sl + 1) * 16 + 8 == rows;
      const int r0 = sl * 16 + lane % 16, r1 = r0 + 16;
      float acc[2][4][4] = {};
      uint32_t a[2][2][4];                     // [buffer][slab][reg]
      auto load = [&](int buf, int kk) {
        tc::ldmatrix_x4(a[buf][0], chunk + piece(r0, 2 * kk + lane / 16));
        tc::ldmatrix_x4(a[buf][1], chunk + piece(r1, 2 * kk + lane / 16));
        if (half0) a[buf][0][1] = a[buf][0][3] = 0u;
        if (half1) a[buf][1][1] = a[buf][1][3] = 0u;
        if (!full1) a[buf][1][0] = a[buf][1][1] = a[buf][1][2] = a[buf][1][3] = 0u;
      };
      load(0, 0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk + 1 < 8) load((kk + 1) & 1, kk + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            tc::mma_bf16(acc[h][nt], a[kk & 1][h], b[nt][kk][0], b[nt][kk][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          checksum += (acc[h][nt][0] + acc[h][nt][1]) +
                      (acc[h][nt][2] + acc[h][nt][3]);
      // lane 0 of warp 0 holds y[0,0] of slab 0 in acc[0][0][0]
      if (tile_start && sl == 0 && threadIdx.x == 0) y00 += acc[0][0][0];
    }
  }
};

struct MxuF32 {
  using T = float;
  static constexpr int kRowBytes = kLanes * 4;                  // 512
  static constexpr int kChunkRows = 128;
  static constexpr int kStages = 2;
  static constexpr int kChunkBytes = kChunkRows * kRowBytes;    // 64 KiB
  static constexpr int kWBytes = kLanes * kRowBytes;            // 64 KiB
  static constexpr int kMinBlocks = 1;

  const float* ws;       // w in shared memory, row-major
  int r0, c0;            // first of this thread's 8 rows; first column

  __device__ __forceinline__ void init(const T* w, char* smem) {
    float* dst = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < kLanes * kLanes / 4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] =
          __ldg(reinterpret_cast<const float4*>(w) + i);
    ws = dst;            // visible after the pipeline's first __syncthreads
    const int lane = threadIdx.x % 32;
    r0 = ((threadIdx.x / 32) * 2 + lane / 16) * 8;
    c0 = (lane % 16) * 4;
  }

  __device__ static __forceinline__ void stage(char* dst, const char* src,
                                               int rows) {
    for (int i = threadIdx.x; i < rows * (kRowBytes / 16); i += kThreads)
      tc::cp_async16(dst + (size_t)i * 16, src + (size_t)i * 16);
  }

  __device__ __forceinline__ void compute(const char* chunk, int rows,
                                          bool tile_start, float& checksum,
                                          float& y00) const {
    if (r0 >= rows) return;                    // rows past the tile's end
    const float* xs = reinterpret_cast<const float*>(chunk) + r0 * kLanes;
    float acc[8][8] = {};
#pragma unroll 2
    for (int k = 0; k < kLanes; k += 4) {
      float4 xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + i * kLanes + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = ws + (k + kk) * kLanes + c0;
        const float4 wa = *reinterpret_cast<const float4*>(wr);
        const float4 wb = *reinterpret_cast<const float4*>(wr + 64);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xk = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y
                           : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xk, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += acc[i][j];
      checksum += s;
    }
    if (tile_start && threadIdx.x == 0) y00 += acc[0][0];   // y[0,0]
  }
};

template <typename R, int U>
__global__ void __launch_bounds__(kThreads, R::kMinBlocks)
mxu_kernel(const char* x, const typename R::T* w, float* partials,
           int n_tiles, int block_rows, int streams, int passes) {
  extern __shared__ __align__(128) char smem[];
  char* ring = smem + R::kWBytes;
  R route;
  route.init(w, smem);

  const int seg = n_tiles / streams;
  const size_t tile_bytes = (size_t)block_rows * R::kRowBytes;
  const int cpt = (block_rows + R::kChunkRows - 1) / R::kChunkRows;

  // the copy side walks (pass, walk step, chunk) kStages-1 chunks ahead of
  // the compute side; past the last chunk it commits empty groups, so that
  // the group count stays uniform
  int c_pass = 0, c_step = blockIdx.x, c_chunk = 0;
  auto issue = [&](int slot) {
    if (c_pass < passes) {
      const int row = c_chunk * R::kChunkRows;
      R::stage(ring + slot * R::kChunkBytes,
               x + walk_tile(c_step, streams, seg) * tile_bytes +
                   (size_t)row * R::kRowBytes,
               min(R::kChunkRows, block_rows - row));
      if (++c_chunk == cpt) {
        c_chunk = 0;
        c_step += gridDim.x;
        if (c_step >= n_tiles) {
          c_step = blockIdx.x;
          ++c_pass;
        }
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) issue(s);

  int slot = 0;
  float y00 = 0.0f, checksum = 0.0f;
  for (int p = 0; p < passes; p += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int step = blockIdx.x; step < n_tiles; step += gridDim.x) {
        for (int c = 0; c < cpt; ++c) {
          tc::cp_async_wait<R::kStages - 2>();   // this chunk has landed
          __syncthreads();                       // ... for every thread, and
                                                 // the last slot is consumed
          issue((slot + R::kStages - 1) % R::kStages);
          route.compute(ring + slot * R::kChunkBytes,
                        min(R::kChunkRows, block_rows - c * R::kChunkRows),
                        c == 0, checksum, y00);
          slot = (slot + 1) % R::kStages;
        }
      }
      pass_barrier();
    }
  }
  tc::cp_async_wait<0>();
  y00 = block_sum(y00);
  if (threadIdx.x == 0) partials[blockIdx.x] = y00;
  checksum = block_sum(checksum);
  if (threadIdx.x == 0) partials[gridDim.x + blockIdx.x] = checksum;
}

}  // namespace mb

template <typename R>
static int launch_mxu(const void* x, const void* w, float* partials,
                      float* out, int n_tiles, int block_rows, int streams,
                      int passes, int unroll, int grid, cudaStream_t st) {
  constexpr int smem = R::kWBytes + R::kStages * R::kChunkBytes;
#define MB_MXU(U)                                                           \
  do {                                                                      \
    cudaError_t e = cudaFuncSetAttribute(                                   \
        mb::mxu_kernel<R, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
        smem);                                                              \
    if (e != cudaSuccess) return (int)e;                                    \
    mb::mxu_kernel<R, U><<<grid, mb::kThreads, smem, st>>>(                 \
        static_cast<const char*>(x), static_cast<const typename R::T*>(w),  \
        partials, n_tiles, block_rows, streams, passes);                    \
  } while (0)
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
    return launch_mxu<mb::MxuF32>(x, w, partials, out, n_tiles, block_rows,
                                  streams, passes, unroll, grid, st);
  if (dtype == 1)
    return launch_mxu<mb::MxuBf16>(x, w, partials, out, n_tiles, block_rows,
                                   streams, passes, unroll, grid, st);
  return (int)cudaErrorInvalidValue;
}
