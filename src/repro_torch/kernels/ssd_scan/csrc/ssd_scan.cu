// Mamba-2 SSD (state-space duality), forward: per row bh of (B*H) and per
// chunk of Q steps, in order,
//   cum   = prefix sum of dA over the chunk
//   y     = ((C B^T) o L) x + exp(cum) (C state),  L[i,j] = i >= j ? exp(cum_i - cum_j) : 0
//   state = exp(cum_last) state + (B o exp(cum_last - cum))^T x
// with y written per chunk and the state after the last chunk.
//
// Replaces _ssd_kernel of src/repro/kernels/ssd_scan/ssd_scan.py (the Pallas
// kernel behind ssd_scan(), grid (B*H, n_chunks) with the state in VMEM
// scratch across the sequential chunk axis).  Blocks on a GPU run in no
// order, so the carry cannot go through the grid as on the TPU: a CTA walks
// its row's chunks in order and keeps the state itself.
//
// Layout: x (BH, S, P) contiguous, float32 or bfloat16, already dt-weighted;
// dA (BH, S) float32 contiguous; B and C (BH, S, N) of x's type given by
// strides: row bh reads outer index bh / heads and inner index bh % heads,
// so (batch, head) views that repeat one group's B over its heads with
// stride 0 need no copy; y (BH, S, P) in x's type; state (BH, N, P) float32.
//
// Bound on an H100: at the serving shape (BH 320, S 512, P 64, N 64, Q 256,
// bf16 x/B/C, B and C shared by the 80 heads of a batch row) the function
// needs 4.74 GFLOP a call (ops.work_flops: the causal half of a chunk's
// pairs, C B^T once a batch row, no C state in the first chunk; the
// reference's chunked algorithm counts 13.4, whole squares and C B^T a
// head), 4.8 us at the bf16 tensor-core rate, against ~48 MB of x, dA, B,
// C, y and state, 14.4 us at HBM's rate and 1.4 us at the SMs' load/store
// rate while they stay in the 50 MB L2: operations bound where they stay.
//
// Three routes; the wrapper picks one (ssd_scan.launch_plan) and passes it.
//
// route 1, tensor cores (bfloat16 x/B/C, P and N multiples of 8, N <= 64,
// Q a multiple of 16, 16-byte aligned rows): every product is an
// mma.sync.m16n8k16 with bf16 operands and float32 accumulators.
//  * C B^T: both operands are bf16, so the products are exact.
//  * (C B^T o L) x, C state and (w o x)^T B: one operand is float32.  It is
//    split into two bf16 halves, hi = bf16(a), lo = bf16(a - hi), and both
//    are multiplied: hi + lo keeps 16 bits of a (a - hi - lo <= 2**-17 |a|),
//    where one bf16 rounding would keep 8 (a rounding the Pallas kernel
//    does not make).  The lo products double those three products' work.
//  * Grid: columns of y and of the state are independent (y[:, p] needs
//    x[:, p] and state[:, p] only), so a CTA owns one row bh and 16 columns
//    of P: a grid of (P / 16) x BH CTAs, the slices of a row neighbours,
//    1280 CTAs at the serving shape.  Each recomputes C B^T o L for its row
//    (4 times per row at P 64; the cheapest of its products).  2 CTAs of 256 threads are resident an SM (shared
//    memory, below; __launch_bounds__ caps registers at 128), so the 1280
//    CTAs run in 4.85 waves of 264 on 132 SMs: the last wave holds 224 CTAs
//    (85 % of the slots).
//  * A chunk's C and B rows (Q x N) and its 16 columns of x (Q x 16) are
//    staged whole in shared memory as bf16, by 16-byte cp.async (zero-fill
//    past N and P), rows padded by 8 elements so that every ldmatrix of 8
//    rows is conflict-free: 96 KiB at the serving shape.  The copies of a
//    chunk are in flight while warp 0 scans dA; the other CTA on the SM
//    computes meanwhile.  (Two chunks in flight would take 192 KiB and one
//    CTA an SM.)
//  * Warps: the chunk's Q / 16 query tiles of 16 rows are dealt to the 8
//    warps in snake order (warp w takes tiles w and 15 - w at Q 256: 17 key
//    tiles each under the causal mask).  A warp keeps its tile's C
//    fragments in registers, starts y with exp(cum_i) (C state) and adds, per
//    key tile of 16 at or below the diagonal, S = C B^T (ldmatrix of B),
//    S o L in registers (base 2: exp2(log2e (cum_i - cum_j)), ex2.approx;
//    L is chosen with a select on the diagonal tile, never multiplied by a
//    0/1 mask: exp(cum_i - cum_j) overflows above it and inf * 0 = NaN),
//    then (S o L) x with S o L split into hi/lo straight from the
//    accumulators (their layout is the A layout) and x through
//    ldmatrix.trans.  Key tiles above the diagonal are skipped.
//  * The state: warp w owns state columns n = 8w .. 8w + 7 (N <= 64: at
//    most one n-tile a warp) for the CTA's 16 columns of P, in float32
//    accumulators that stay in its registers across chunks: st =
//    exp(cum_last) st + (w o x)^T B, with (w o x)^T from ldmatrix.trans of
//    x, scaled and split once per key step, and B through ldmatrix.trans.
//    The hi/lo halves of
//    the state that the next chunk's C state reads go to a second shared
//    buffer, so the state update needs no barrier against the y tiles.
//
// route 2, tensor cores at N up to 128 (mamba2's d_state; route 1's
// conditions, N padded up to 64 or 128 with zero columns): route 1's
// products and roundings, laid out again for 16 n-tiles of state (8 at
// width 64, which takes only the chunks too long for route 1 to stage).
// Bound at mamba2's prefill shape (BH 320, S 512, P 64, N 128, Q 256, B and
// C shared by the 80 heads of a batch row): the function needs 6.79 GFLOP
// (counted as above; the reference counts 21.47), 6.9 us at the bf16
// tensor-core rate, against 54.1 MB, more than the L2 holds, 16.2 us at
// HBM's rate: bytes bound.
//  * The C B^T recompute: at N 128 C B^T is the largest product (16 mma a
//    key tile, against 4 for (S o L) x over 16 columns).  A CTA owns one
//    row and 32 columns of P, so a row computes it twice at P 64, not four
//    times as with route 1's 16 columns: 25.2 GFLOP of split-operand mma
//    work a call, against 36.6 with 16 columns a CTA and 19.5 with 64
//    (which would hold 32 more accumulators a thread for y and the state,
//    and leave 320 CTAs for 264 slots: 1.21 waves).  Sharing C B^T over the
//    heads of a group (one pass a (group, chunk), its Q x Q float32 product
//    read back by every head's CTA: 136 KiB a CTA and chunk through the L2)
//    is not taken: a second kernel and a buffer for a product that 32
//    columns already halve, and the per-head layout would still need this.
//  * Grid: (P / 32) x BH CTAs, the slices of a row neighbours, 640 at
//    mamba2's shape.  2 CTAs of 256 threads are resident an SM (shared
//    memory, below; __launch_bounds__ caps registers at 128), so the 640
//    CTAs run in 2.42 waves of 264 on 132 SMs: the last wave holds 112 CTAs
//    (42 % of the slots).  CTAs start as slots free up: 112 SMs run 5 and
//    20 run 4, the fifth alone on its SM.
//  * Shared memory, 110,592 B at Q 256 (2 CTAs an SM): the chunk's B rows
//    (Q x 128, padded by 8: 69.6 KB) and its 32 columns of x (20.5 KB) by
//    16-byte cp.async, and one buffer of the state's hi/lo halves (17.4
//    KB).  C is not staged: a warp loads its query tile's C fragments from
//    global memory into registers (each C row is read once a CTA, and a
//    group's heads share it, so it comes from the L2).  B is staged whole,
//    not through a ring of key tiles: each warp walks the key tiles of its
//    own query tiles, so the warps stand at different key tiles at once; a
//    ring the warps consume in step would cost the causal balance (24 steps
//    of work for 17 at Q 256).  The copies of a chunk overlap the other
//    resident CTA's compute and warp 0's scan of dA.  The state buffer is
//    single: the next chunk's hi/lo halves are written after a barrier that
//    follows every warp's C state.
//  * Registers: a warp holds its query tile's C fragments (8 k-slices: 32),
//    y over 32 columns (16), the state (16), S (8) and its split halves (8),
//    under the launch bound's 128.
//  * The state at N 128: 16 n-tiles of 8 columns; warp w owns n-tiles 2w and
//    2w + 1 (n = 16w .. 16w + 15) over the CTA's 32 columns of P, in float32
//    accumulators that stay in its registers across chunks; one
//    ldmatrix.trans of B feeds both (at width 64: n-tile w, as on route
//    1).  The first chunk skips C state (no state enters it).
//
// route 0, float32 FMAs (float32 inputs, where the tensor cores have no
// exact product; bfloat16 inputs of a shape routes 1 and 2 do not take
// come here widened to float32 by the wrapper, which is exact): one CTA of
// 256 threads per bh row walks its chunks in order, with the (N, P) state
// in shared memory.  The Q x Q block of a chunk (256 KiB at Q = 256 in
// float32) does not fit in the 227 KB a block may use, so the chunk is
// tiled: 64 query rows at a time against key tiles of 64, and key tiles
// above the diagonal are skipped; L is chosen with a select.  Each thread
// computes 4 x 4 outputs per tile product (register blocking), reading
// shared memory twice per four FMAs.  All math in float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../tensor_core.cuh"

namespace ssd {

constexpr int kThreads = 256;
constexpr int kTile = 64;                  // rows per query / key tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

struct Strided {            // B or C: element (bh, s, n)
  const void* p;
  int heads;
  long long so, si, ss;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Strided& m, int bh, int s) {
  return static_cast<const T*>(m.p) + (long long)(bh / m.heads) * m.so +
         (long long)(bh % m.heads) * m.si + (long long)s * m.ss;
}

// rows [s0, s0 + rows) of a (S, width) matrix into dst (stride ld), as float;
// rows past `rows` (up to kTile) are zero
template <typename T>
__device__ void load_rows(float* dst, int ld, int width, int rows,
                          const Strided& m, int bh, int s0) {
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width, c = e % width;
    dst[r * ld + c] = r < rows ? to_f(row_ptr<T>(m, bh, s0 + r)[c]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// route 0: float32 FMAs
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dA, Strided Bm,
        Strided Cm, T* __restrict__ y, float* __restrict__ state_out, int S,
        int P, int N, int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1;                   // padded: thread j reads row j
  float* cum = smem;                       // Q
  float* w = cum + Q;                      // Q: exp(cum_last - cum_j)
  float* Cs = w + Q;                       // kTile x ldn
  float* Bs = Cs + kTile * ldn;            // kTile x ldn
  float* Xs = Bs + kTile * ldn;            // kTile x P
  float* Ss = Xs + kTile * P;              // kTile x (kTile + 1): (C B^T) o L
  float* Ys = Ss + kTile * (kTile + 1);    // kTile x P
  float* st = Ys + kTile * P;              // N x P
  const int lds = kTile + 1;
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const Strided X{x, 1, (long long)S * P, 0, P};

  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();
    // cum: inclusive prefix sum of dA over the chunk (warp 0: each lane a
    // run of consecutive steps, then a scan of the run totals)
    if (tid < 32) {
      const int per = (Q + 31) / 32, lo = tid * per;
      const int hi = lo + per < Q ? lo + per : Q;
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += dA[(long long)bh * S + c0 + i];
        cum[i] = run;
      }
      float off = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, off, d);
        if (tid >= d) off += o;
      }
      off -= run;                          // sum of the runs before this lane
      for (int i = lo; i < hi; ++i) cum[i] += off;
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) w[i] = expf(cum_last - cum[i]);

    // ---- y, one tile of query rows at a time (reads the entering state)
    for (int i0 = 0; i0 < Q; i0 += kTile) {
      const int ti = Q - i0 < kTile ? Q - i0 : kTile;
      __syncthreads();
      load_rows<T>(Cs, ldn, N, ti, Cm, bh, c0 + i0);
      for (int e = tid; e < kTile * P; e += kThreads) Ys[e] = 0.f;
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int tj = Q - j0 < kTile ? Q - j0 : kTile;
        __syncthreads();                   // Bs, Xs, Ss free
        load_rows<T>(Bs, ldn, N, tj, Bm, bh, c0 + j0);
        load_rows<T>(Xs, P, P, tj, X, bh, c0 + j0);
        __syncthreads();
        // Ss = (C B^T) o L on the tile: thread owns rows r + 16a, cols
        // cc + 16b
        {
          const int r = tid / 16, cc = tid % 16;
          float a4[4][4] = {};
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) cv[a] = Cs[(r + 16 * a) * ldn + n];
#pragma unroll
            for (int b = 0; b < 4; ++b) bv[b] = Bs[(cc + 16 * b) * ldn + n];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b) a4[a][b] = fmaf(cv[a], bv[b], a4[a][b]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int i = r + 16 * a, j = cc + 16 * b;
              const int gi = i0 + i, gj = j0 + j;
              const bool ok = i < ti && j < tj && gj <= gi;
              Ss[i * lds + j] = ok ? a4[a][b] * expf(cum[gi] - cum[gj]) : 0.f;
            }
        }
        __syncthreads();
        // Ys += Ss Xs: item (r, pc) owns rows r + 16a, cols pc + (P/4) b
        const int pq = P / 4;
        for (int it = tid; it < 16 * pq; it += kThreads) {
          const int r = it / pq, pc = it % pq;
          float a4[4][4] = {};
          for (int j = 0; j < tj; ++j) {
            float sv[4], xv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) sv[a] = Ss[(r + 16 * a) * lds + j];
#pragma unroll
            for (int b = 0; b < 4; ++b) xv[b] = Xs[j * P + pc + pq * b];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b) a4[a][b] = fmaf(sv[a], xv[b], a4[a][b]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              Ys[(r + 16 * a) * P + pc + pq * b] += a4[a][b];
        }
      }
      // y = Ys + exp(cum_i) (C_i state), written out
      const int pq = P / 4;
      for (int it = tid; it < 16 * pq; it += kThreads) {
        const int r = it / pq, pc = it % pq;
        float a4[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], sv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(r + 16 * a) * ldn + n];
#pragma unroll
          for (int b = 0; b < 4; ++b) sv[b] = st[n * P + pc + pq * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) a4[a][b] = fmaf(cv[a], sv[b], a4[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = r + 16 * a;
          if (i >= ti) continue;
          const float dec = expf(cum[i0 + i]);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = pc + pq * b;
            y[((long long)bh * S + c0 + i0 + i) * P + p] =
                from_f<T>(Ys[i * P + p] + dec * a4[a][b]);
          }
        }
      }
    }

    // ---- state = exp(cum_last) state + (B o w)^T x, after every row tile
    // has read the entering state
    __syncthreads();
    const float decay = expf(cum_last);
    for (int e = tid; e < N * P; e += kThreads) st[e] *= decay;
    const int nq = N / 4, pq = P / 4;
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      const int tj = Q - j0 < kTile ? Q - j0 : kTile;
      __syncthreads();
      load_rows<T>(Bs, ldn, N, tj, Bm, bh, c0 + j0);
      load_rows<T>(Xs, P, P, tj, X, bh, c0 + j0);
      __syncthreads();
      for (int it = tid; it < nq * pq; it += kThreads) {
        const int rn = it / pq, pc = it % pq;
        float a4[4][4] = {};
        for (int j = 0; j < tj; ++j) {
          const float wj = w[j0 + j];
          float bv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) bv[a] = Bs[j * ldn + rn + nq * a] * wj;
#pragma unroll
          for (int b = 0; b < 4; ++b) xv[b] = Xs[j * P + pc + pq * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) a4[a][b] = fmaf(bv[a], xv[b], a4[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            st[(rn + nq * a) * P + pc + pq * b] += a4[a][b];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * P; e += kThreads)
    state_out[(long long)bh * N * P + e] = st[e];
}

// ---------------------------------------------------------------------------
// route 1: the tensor cores (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;  // 256
constexpr int kTcCtas = 2;                 // CTAs an SM registers are cut for
constexpr int kTcCols = 16;                // columns of P per CTA
constexpr int kXStride = kTcCols + 8;      // x rows in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// bf16 elements of a padded C / B row for N padded to 16 * NK
__host__ __device__ constexpr int tc_row(int NK) { return 16 * NK + 8; }

// bytes of dynamic shared memory: C and B (Q rows each), x (Q rows of 16),
// two state buffers of hi and lo halves (16 rows of N each), and cum * log2e,
// exp(cum_last - cum) and exp(cum) (Q floats each)
__host__ __device__ constexpr long long tc_smem_bytes(int NK, int Q) {
  return 2LL * (2LL * Q * tc_row(NK) + (long long)Q * kXStride +
                4LL * kTcCols * tc_row(NK)) +
         4LL * 3 * Q;
}

// a and b (float32) -> hi = bf16(a), bf16(b) in one register, and lo =
// bf16(a - hi_a), bf16(b - hi_b) in another (a - hi is exact in float32)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tc::pack_bf16(a, b);
  lo = tc::pack_bf16(a - __uint_as_float(hi << 16),
                     b - __uint_as_float(hi & 0xffff0000u));
}

// one register of two bf16 (x) scaled by two floats, split as above
__device__ __forceinline__ void scale_split(uint32_t x, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  split_bf16(__uint_as_float(x << 16) * w0,
             __uint_as_float(x & 0xffff0000u) * w1, hi, lo);
}

// warp 0 of a CTA: cum, the prefix sum of the chunk's dA (da[0 .. Q)),
// each lane a run of consecutive steps, then a scan of the run totals;
// stored as cum * log2e in c2, with exp(cum_last - cum) in wv and exp(cum)
// in ec
__device__ __forceinline__ void chunk_decays(const float* da, int Q, int lane,
                                             float* c2, float* wv,
                                             float* ec) {
  const int per = (Q + 31) / 32, lo = lane * per;
  const int hi = lo + per < Q ? lo + per : Q;
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += da[i];
    c2[i] = run;
  }
  float off = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, off, d);
    if (lane >= d) off += o;
  }
  const float last = __shfl_sync(0xffffffffu, off, 31) * kLog2e;
  off -= run;                              // sum of the runs before this lane
  for (int i = lo; i < hi; ++i) {
    const float v = (c2[i] + off) * kLog2e;
    c2[i] = v;
    wv[i] = tc::exp2_approx(last - v);
    ec[i] = tc::exp2_approx(v);
  }
}

// S = C B^T on a 16 x 16 tile (accumulators, query rows g / g + 8) times
// L = exp(cum_i - cum_j) in base 2 (ex2.approx), cj the key tile's cum *
// log2e; on the diagonal tile L is chosen with a select, never multiplied by
// a 0/1 mask (exp(cum_i - cum_j) overflows above it and inf * 0 = NaN).
// The result leaves split into hi / lo A fragments (the accumulators'
// layout is the A layout).
__device__ __forceinline__ void apply_L_split(float (&sa)[2][4],
                                              const float* cj, float ci0,
                                              float ci1, int g, int t,
                                              bool diagonal, uint32_t (&ah)[4],
                                              uint32_t (&al)[4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int key = 8 * n + 2 * t;
    const float cj0 = cj[key], cj1 = cj[key + 1];
    sa[n][0] *= tc::exp2_approx(ci0 - cj0);
    sa[n][1] *= tc::exp2_approx(ci0 - cj1);
    sa[n][2] *= tc::exp2_approx(ci1 - cj0);
    sa[n][3] *= tc::exp2_approx(ci1 - cj1);
    if (diagonal) {                        // L = 0 above the diagonal
      sa[n][0] = key <= g ? sa[n][0] : 0.f;
      sa[n][1] = key + 1 <= g ? sa[n][1] : 0.f;
      sa[n][2] = key <= g + 8 ? sa[n][2] : 0.f;
      sa[n][3] = key + 1 <= g + 8 ? sa[n][3] : 0.f;
    }
  }
  split_bf16(sa[0][0], sa[0][1], ah[0], al[0]);
  split_bf16(sa[0][2], sa[0][3], ah[1], al[1]);
  split_bf16(sa[1][0], sa[1][1], ah[2], al[2]);
  split_bf16(sa[1][2], sa[1][3], ah[3], al[3]);
}

template <int NK>
__global__ void __launch_bounds__(kTcThreads, kTcCtas)
ssd_fwd_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dA,
           Strided Bm, Strided Cm, __nv_bfloat16* __restrict__ y,
           float* __restrict__ state_out, int S, int P, int N, int Q) {
  constexpr int SN = tc_row(NK);           // padded C / B row
  constexpr int PIECES = 2 * NK;           // 16-byte pieces of a C / B row
  constexpr int NT = 2 * NK;               // state n-tiles of 8: warp w < NT
  static_assert(NT <= kTcWarps, "one state n-tile a warp");   // owns tile w
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = Cs + Q * SN;
  __nv_bfloat16* Xs = Bs + Q * SN;
  __nv_bfloat16* St = Xs + Q * kXStride;   // [buffer][hi, lo][16][SN]
  float* c2 = reinterpret_cast<float*>(St + 4 * kTcCols * SN);
  float* wv = c2 + Q;                      // exp(cum_last - cum_j)
  float* ec = wv + Q;                      // exp(cum_i)
  // CTA -> (row bh, column slice): the slices of one row are neighbours
  const int slices = (P + kTcCols - 1) / kTcCols;
  const int bh = blockIdx.x / slices, p0 = (blockIdx.x % slices) * kTcCols;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* bb = row_ptr<__nv_bfloat16>(Bm, bh, 0);
  const __nv_bfloat16* cb = row_ptr<__nv_bfloat16>(Cm, bh, 0);
  const __nv_bfloat16* xb = x + (size_t)bh * S * P + p0;
  const float* da = dA + (size_t)bh * S;

  // the entering state of chunk 0: zeros (buffer 0, hi and lo)
  for (int e = tid; e < kTcCols * SN; e += kTcThreads)
    reinterpret_cast<uint32_t*>(St)[e] = 0u;
  float st[4] = {};                        // this warp's state tile

  int cur = 0;
  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();                       // the last chunk is consumed
    for (int e = tid; e < Q * PIECES; e += kTcThreads) {
      const int r = e / PIECES, pc = e % PIECES;
      const bool ok = pc * 8 < N;
      const size_t off = (size_t)(c0 + r) * Bm.ss + pc * 8;
      const size_t offc = (size_t)(c0 + r) * Cm.ss + pc * 8;
      tc::cp_async16(Bs + r * SN + pc * 8, ok ? bb + off : bb, ok ? 16 : 0);
      tc::cp_async16(Cs + r * SN + pc * 8, ok ? cb + offc : cb, ok ? 16 : 0);
    }
    for (int e = tid; e < 2 * Q; e += kTcThreads) {
      const int r = e >> 1, pc = e & 1;
      const bool ok = p0 + pc * 8 < P;
      tc::cp_async16(Xs + r * kXStride + pc * 8,
                     ok ? xb + (size_t)(c0 + r) * P + pc * 8 : xb,
                     ok ? 16 : 0);
    }
    tc::cp_async_commit();
    // meanwhile warp 0: cum * log2e and the decays
    if (warp == 0) chunk_decays(da + c0, Q, lane, c2, wv, ec);
    tc::cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* sth = St + cur * 2 * kTcCols * SN;
    const __nv_bfloat16* stl = sth + kTcCols * SN;

    // ---- y: this warp's query tiles, snake order over the warps
    const int nqt = Q / 16;
    for (int u = 0; u * kTcWarps < nqt; ++u) {
      const int qt = u * kTcWarps + ((u & 1) ? kTcWarps - 1 - warp : warp);
      if (qt >= nqt) continue;
      const int i0 = qt * 16;
      uint32_t cf[NK][4];
#pragma unroll
      for (int k = 0; k < NK; ++k)
        tc::ldmatrix_x4(cf[k], Cs + (i0 + (lane & 15)) * SN + k * 16 +
                                   (lane >> 4) * 8);
      // exp(cum_i) (C state): the state's hi and lo halves, rows p
      float ya[2][4] = {};
      const int soff = ((lane & 7) + ((lane >> 4) << 3)) * SN +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        uint32_t h[4], l[4];
        tc::ldmatrix_x4(h, sth + soff + k * 16);
        tc::ldmatrix_x4(l, stl + soff + k * 16);
        tc::mma_bf16(ya[0], cf[k], h[0], h[1]);
        tc::mma_bf16(ya[1], cf[k], h[2], h[3]);
        tc::mma_bf16(ya[0], cf[k], l[0], l[1]);
        tc::mma_bf16(ya[1], cf[k], l[2], l[3]);
      }
      const float e0 = ec[i0 + g], e1 = ec[i0 + g + 8];
      const float ci0 = c2[i0 + g], ci1 = c2[i0 + g + 8];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        ya[n][0] *= e0; ya[n][1] *= e0;
        ya[n][2] *= e1; ya[n][3] *= e1;
      }
      // + (C B^T o L) x over the key tiles at or below the diagonal
      const __nv_bfloat16* brow = Bs + ((lane & 7) + ((lane >> 4) << 3)) * SN +
                                  ((lane >> 3) & 1) * 8;
      const __nv_bfloat16* xrow = Xs + ((lane & 7) + (((lane >> 3) & 1) << 3)) *
                                           kXStride + ((lane >> 4) << 3);
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * 16;
        float sa[2][4] = {};
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          uint32_t r[4];
          tc::ldmatrix_x4(r, brow + j0 * SN + k * 16);
          tc::mma_bf16(sa[0], cf[k], r[0], r[1]);
          tc::mma_bf16(sa[1], cf[k], r[2], r[3]);
        }
        uint32_t ah[4], al[4], r[4];
        apply_L_split(sa, c2 + j0, ci0, ci1, g, t, kt == qt, ah, al);
        tc::ldmatrix_x4_trans(r, xrow + j0 * kXStride);
        tc::mma_bf16(ya[0], ah, r[0], r[1]);
        tc::mma_bf16(ya[1], ah, r[2], r[3]);
        tc::mma_bf16(ya[0], al, r[0], r[1]);
        tc::mma_bf16(ya[1], al, r[2], r[3]);
      }
      __nv_bfloat16* yrow = y + ((size_t)bh * S + c0 + i0 + g) * P + p0 + 2 * t;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (p0 + 8 * n >= P) continue;
        *reinterpret_cast<uint32_t*>(yrow + 8 * n) =
            tc::pack_bf16(ya[n][0], ya[n][1]);
        *reinterpret_cast<uint32_t*>(yrow + 8 * P + 8 * n) =
            tc::pack_bf16(ya[n][2], ya[n][3]);
      }
    }

    // ---- the state: st = exp(cum_last) st + (w o x)^T B on this warp's
    // n-tile (columns n = 8 warp ..), rows p
    if (warp < NT) {
      const float decay = tc::exp2_approx(c2[Q - 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) st[e] *= decay;
      const __nv_bfloat16* xt = Xs + ((lane & 7) + ((lane >> 4) << 3)) *
                                         kXStride + (((lane >> 3) & 1) << 3);
      for (int j0 = 0; j0 < Q; j0 += 16) {
        uint32_t xa[4], ah[4], al[4];
        tc::ldmatrix_x4_trans(xa, xt + j0 * kXStride);
        const int j = j0 + 2 * t;
        const float w0 = wv[j], w1 = wv[j + 1], w2 = wv[j + 8],
                    w3 = wv[j + 9];
        scale_split(xa[0], w0, w1, ah[0], al[0]);
        scale_split(xa[1], w0, w1, ah[1], al[1]);
        scale_split(xa[2], w2, w3, ah[2], al[2]);
        scale_split(xa[3], w2, w3, ah[3], al[3]);
        uint32_t b[2];
        tc::ldmatrix_x2_trans(b, Bs + (j0 + (lane & 15)) * SN + warp * 8);
        tc::mma_bf16(st, ah, b[0], b[1]);
        tc::mma_bf16(st, al, b[0], b[1]);
      }
      // hi / lo halves for the next chunk's C state
      __nv_bfloat16* nh = St + (cur ^ 1) * 2 * kTcCols * SN;
      __nv_bfloat16* nl = nh + kTcCols * SN;
      const int o = g * SN + warp * 8 + 2 * t;
      uint32_t h, l;
      split_bf16(st[0], st[1], h, l);
      *reinterpret_cast<uint32_t*>(nh + o) = h;
      *reinterpret_cast<uint32_t*>(nl + o) = l;
      split_bf16(st[2], st[3], h, l);
      *reinterpret_cast<uint32_t*>(nh + o + 8 * SN) = h;
      *reinterpret_cast<uint32_t*>(nl + o + 8 * SN) = l;
    }
    cur ^= 1;
  }
  // the final state, (N, P) per row
  const int n = warp * 8 + 2 * t;
  if (warp < NT && n < N) {
    float* o = state_out + ((size_t)bh * N + n) * P + p0 + g;
    if (p0 + g < P) {
      o[0] = st[0];
      o[P] = st[1];
    }
    if (p0 + g + 8 < P) {
      o[8] = st[2];
      o[P + 8] = st[3];
    }
  }
}

// ---------------------------------------------------------------------------
// route 2: the tensor cores at N up to 128 (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kWideCols = 32;              // columns of P per CTA
constexpr int kWideCtas = 2;               // CTAs an SM registers are cut for
constexpr int kWideXStride = kWideCols + 8;  // x rows in shared memory

// padded B / state row (bf16) of the width WN (N padded up to it)
__host__ __device__ constexpr int wide_row(int WN) { return WN + 8; }

// bytes of dynamic shared memory: B (Q rows), x (Q rows of 32), one buffer
// of the state's hi and lo halves (32 rows of WN each), and cum * log2e,
// exp(cum_last - cum) and exp(cum) (Q floats each)
__host__ __device__ constexpr long long wide_smem_bytes(int WN, int Q) {
  return 2LL * ((long long)Q * wide_row(WN) + (long long)Q * kWideXStride +
                2LL * kWideCols * wide_row(WN)) +
         4LL * 3 * Q;
}

__device__ __forceinline__ uint32_t ldg_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <int WN>
__global__ void __launch_bounds__(kTcThreads, kWideCtas)
ssd_fwd_tc_wide(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dA, Strided Bm, Strided Cm,
                __nv_bfloat16* __restrict__ y, float* __restrict__ state_out,
                int S, int P, int N, int Q) {
  static_assert(WN == 64 || WN == 128, "route 2 is built for N 64 and 128");
  constexpr int NK = WN / 16;              // k-slices of C B^T and C state
  constexpr int NTW = WN / (8 * kTcWarps);  // state n-tiles a warp: 1 or 2
  constexpr int SN = wide_row(WN), XS = kWideXStride;
  constexpr int PIECES = WN / 8;           // 16-byte pieces of a B row
  constexpr int MT = kWideCols / 16;       // 16-column tiles of P (state)
  constexpr int XN = kWideCols / 8;        // 8-column n-tiles of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Xs = Bs + Q * SN;
  __nv_bfloat16* Sth = Xs + Q * XS;        // state hi: 32 rows p of SN
  __nv_bfloat16* Stl = Sth + kWideCols * SN;
  float* c2 = reinterpret_cast<float*>(Stl + kWideCols * SN);
  float* wv = c2 + Q;                      // exp(cum_last - cum_j)
  float* ec = wv + Q;                      // exp(cum_i)
  // CTA -> (row bh, column slice): the slices of one row are neighbours
  const int slices = (P + kWideCols - 1) / kWideCols;
  const int bh = blockIdx.x / slices, p0 = (blockIdx.x % slices) * kWideCols;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* bb = row_ptr<__nv_bfloat16>(Bm, bh, 0);
  const __nv_bfloat16* cb = row_ptr<__nv_bfloat16>(Cm, bh, 0);
  const __nv_bfloat16* xb = x + (size_t)bh * S * P + p0;
  const float* da = dA + (size_t)bh * S;

  // the entering state of chunk 0: zeros (hi and lo)
  for (int e = tid; e < kWideCols * SN; e += kTcThreads)
    reinterpret_cast<uint32_t*>(Sth)[e] = 0u;
  float st[MT][NTW][4] = {};               // 16 rows p x this warp's n-tiles

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();                       // the last chunk is consumed
    for (int e = tid; e < Q * PIECES; e += kTcThreads) {
      const int r = e / PIECES, pc = e % PIECES;
      const bool ok = pc * 8 < N;
      tc::cp_async16(Bs + r * SN + pc * 8,
                     ok ? bb + (size_t)(c0 + r) * Bm.ss + pc * 8 : bb,
                     ok ? 16 : 0);
    }
    for (int e = tid; e < Q * XN; e += kTcThreads) {
      const int r = e / XN, pc = e % XN;
      const bool ok = p0 + pc * 8 < P;
      tc::cp_async16(Xs + r * XS + pc * 8,
                     ok ? xb + (size_t)(c0 + r) * P + pc * 8 : xb,
                     ok ? 16 : 0);
    }
    tc::cp_async_commit();
    if (warp == 0) chunk_decays(da + c0, Q, lane, c2, wv, ec);
    tc::cp_async_wait<0>();
    __syncthreads();

    // ---- y: this warp's query tiles, snake order over the warps
    const int nqt = Q / 16;
    for (int u = 0; u * kTcWarps < nqt; ++u) {
      const int qt = u * kTcWarps + ((u & 1) ? kTcWarps - 1 - warp : warp);
      if (qt >= nqt) continue;
      const int i0 = qt * 16;
      // the tile's C fragments from global memory (the A layout: rows g,
      // g + 8, columns 2t and 2t + 8 of each k-slice; zero past N)
      uint32_t cf[NK][4];
      const __nv_bfloat16* cg = cb + (size_t)(c0 + i0 + g) * Cm.ss + 2 * t;
      const __nv_bfloat16* cg8 = cg + 8 * Cm.ss;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const bool a = 16 * k < N, b = 16 * k + 8 < N;
        cf[k][0] = a ? ldg_pair(cg + 16 * k) : 0u;
        cf[k][1] = a ? ldg_pair(cg8 + 16 * k) : 0u;
        cf[k][2] = b ? ldg_pair(cg + 16 * k + 8) : 0u;
        cf[k][3] = b ? ldg_pair(cg8 + 16 * k + 8) : 0u;
      }
      // exp(cum_i) (C state): the state's hi and lo halves, rows p (none
      // enters the first chunk)
      float ya[XN][4] = {};
      if (c0 > 0) {
        const int soff = ((lane & 7) + ((lane >> 4) << 3)) * SN +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int k = 0; k < NK; ++k)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            uint32_t h[4], l[4];
            tc::ldmatrix_x4(h, Sth + soff + m * 16 * SN + k * 16);
            tc::ldmatrix_x4(l, Stl + soff + m * 16 * SN + k * 16);
            tc::mma_bf16(ya[2 * m], cf[k], h[0], h[1]);
            tc::mma_bf16(ya[2 * m + 1], cf[k], h[2], h[3]);
            tc::mma_bf16(ya[2 * m], cf[k], l[0], l[1]);
            tc::mma_bf16(ya[2 * m + 1], cf[k], l[2], l[3]);
          }
        const float e0 = ec[i0 + g], e1 = ec[i0 + g + 8];
#pragma unroll
        for (int n = 0; n < XN; ++n) {
          ya[n][0] *= e0; ya[n][1] *= e0;
          ya[n][2] *= e1; ya[n][3] *= e1;
        }
      }
      // + (C B^T o L) x over the key tiles at or below the diagonal
      const float ci0 = c2[i0 + g], ci1 = c2[i0 + g + 8];
      const __nv_bfloat16* brow = Bs + ((lane & 7) + ((lane >> 4) << 3)) * SN +
                                  ((lane >> 3) & 1) * 8;
      const __nv_bfloat16* xrow = Xs + ((lane & 7) + (((lane >> 3) & 1) << 3)) *
                                           XS + ((lane >> 4) << 3);
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * 16;
        float sa[2][4] = {};
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          uint32_t r[4];
          tc::ldmatrix_x4(r, brow + j0 * SN + k * 16);
          tc::mma_bf16(sa[0], cf[k], r[0], r[1]);
          tc::mma_bf16(sa[1], cf[k], r[2], r[3]);
        }
        uint32_t ah[4], al[4];
        apply_L_split(sa, c2 + j0, ci0, ci1, g, t, kt == qt, ah, al);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(r, xrow + j0 * XS + m * 16);
          tc::mma_bf16(ya[2 * m], ah, r[0], r[1]);
          tc::mma_bf16(ya[2 * m + 1], ah, r[2], r[3]);
          tc::mma_bf16(ya[2 * m], al, r[0], r[1]);
          tc::mma_bf16(ya[2 * m + 1], al, r[2], r[3]);
        }
      }
      __nv_bfloat16* yrow = y + ((size_t)bh * S + c0 + i0 + g) * P + p0 + 2 * t;
#pragma unroll
      for (int n = 0; n < XN; ++n) {
        if (p0 + 8 * n >= P) continue;
        *reinterpret_cast<uint32_t*>(yrow + 8 * n) =
            tc::pack_bf16(ya[n][0], ya[n][1]);
        *reinterpret_cast<uint32_t*>(yrow + 8 * P + 8 * n) =
            tc::pack_bf16(ya[n][2], ya[n][3]);
      }
    }

    // ---- the state: st = exp(cum_last) st + (w o x)^T B on this warp's
    // n-tiles (columns n = 8 NTW warp ..), rows p
    const float decay = tc::exp2_approx(c2[Q - 1]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[m][nt][e] *= decay;
    const __nv_bfloat16* xt = Xs + ((lane & 7) + ((lane >> 4) << 3)) * XS +
                              (((lane >> 3) & 1) << 3);
    const __nv_bfloat16* bt = Bs + (lane & 15) * SN + warp * 8 * NTW +
                              (NTW == 2 ? (lane >> 4) * 8 : 0);
    for (int j0 = 0; j0 < Q; j0 += 16) {
      const int j = j0 + 2 * t;
      const float w0 = wv[j], w1 = wv[j + 1], w2 = wv[j + 8], w3 = wv[j + 9];
      uint32_t b[2 * NTW];
      if constexpr (NTW == 2)
        tc::ldmatrix_x4_trans(b, bt + j0 * SN);
      else
        tc::ldmatrix_x2_trans(b, bt + j0 * SN);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t xa[4], ah[4], al[4];
        tc::ldmatrix_x4_trans(xa, xt + j0 * XS + m * 16);
        scale_split(xa[0], w0, w1, ah[0], al[0]);
        scale_split(xa[1], w0, w1, ah[1], al[1]);
        scale_split(xa[2], w2, w3, ah[2], al[2]);
        scale_split(xa[3], w2, w3, ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          tc::mma_bf16(st[m][nt], ah, b[2 * nt], b[2 * nt + 1]);
          tc::mma_bf16(st[m][nt], al, b[2 * nt], b[2 * nt + 1]);
        }
      }
    }
    if (c0 + Q < S) {
      // hi / lo halves for the next chunk's C state, once every warp has
      // read the entering ones
      __syncthreads();
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const int o = (m * 16 + g) * SN + (warp * NTW + nt) * 8 + 2 * t;
          uint32_t h, l;
          split_bf16(st[m][nt][0], st[m][nt][1], h, l);
          *reinterpret_cast<uint32_t*>(Sth + o) = h;
          *reinterpret_cast<uint32_t*>(Stl + o) = l;
          split_bf16(st[m][nt][2], st[m][nt][3], h, l);
          *reinterpret_cast<uint32_t*>(Sth + o + 8 * SN) = h;
          *reinterpret_cast<uint32_t*>(Stl + o + 8 * SN) = l;
        }
    }
  }
  // the final state, (N, P) per row
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int n = (warp * NTW + nt) * 8 + 2 * t, p = p0 + m * 16 + g;
      if (n >= N) continue;
      float* o = state_out + ((size_t)bh * N + n) * P + p;
      if (p < P) {
        o[0] = st[m][nt][0];
        o[P] = st[m][nt][1];
      }
      if (p + 8 < P) {
        o[8] = st[m][nt][2];
        o[P + 8] = st[m][nt][3];
      }
    }
}

}  // namespace ssd

// Bytes of dynamic shared memory route 0 needs for (P, N, Q).
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Q) {
  const long long f = 2LL * Q + 2LL * ssd::kTile * (N + 1) +
                      2LL * ssd::kTile * P + (long long)ssd::kTile * (ssd::kTile + 1) +
                      (long long)N * P;
  return f * (long long)sizeof(float);
}

namespace {

template <typename T>
int launch_fma(const void* x, const float* dA, const ssd::Strided& Bm,
               const ssd::Strided& Cm, void* y, float* state, int BH, int S,
               int P, int N, int Q, cudaStream_t stream) {
  const long long smem = ssd_scan_smem_bytes(P, N, Q);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd::ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd::ssd_fwd<T><<<BH, ssd::kThreads, smem, stream>>>(
      static_cast<const T*>(x), dA, Bm, Cm, static_cast<T*>(y), state, S, P,
      N, Q);
  return (int)cudaGetLastError();
}

template <int NK>
int launch_tc(const void* x, const float* dA, const ssd::Strided& Bm,
              const ssd::Strided& Cm, void* y, float* state, int BH, int S,
              int P, int N, int Q, cudaStream_t stream) {
  const long long smem = ssd::tc_smem_bytes(NK, Q);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd::ssd_fwd_tc<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = (P + ssd::kTcCols - 1) / ssd::kTcCols;
  ssd::ssd_fwd_tc<NK><<<(unsigned)slices * BH, ssd::kTcThreads, smem,
                        stream>>>(
      static_cast<const __nv_bfloat16*>(x), dA, Bm, Cm,
      static_cast<__nv_bfloat16*>(y), state, S, P, N, Q);
  return (int)cudaGetLastError();
}

template <int WN>
int launch_wide(const void* x, const float* dA, const ssd::Strided& Bm,
                const ssd::Strided& Cm, void* y, float* state, int BH, int S,
                int P, int N, int Q, cudaStream_t stream) {
  const long long smem = ssd::wide_smem_bytes(WN, Q);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd::ssd_fwd_tc_wide<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = (P + ssd::kWideCols - 1) / ssd::kWideCols;
  ssd::ssd_fwd_tc_wide<WN><<<(unsigned)slices * BH, ssd::kTcThreads, smem,
                             stream>>>(
      static_cast<const __nv_bfloat16*>(x), dA, Bm, Cm,
      static_cast<__nv_bfloat16*>(y), state, S, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y).  B/C: pointer, heads and
// the strides (in elements) of the outer index, the inner index and the
// step.  route: 0 float32 FMAs (float32 only), 1 tensor cores (bfloat16
// only; P and N multiples of 8, N <= 64, Q a multiple of 16), 2 tensor
// cores at N <= 128 (the same conditions; built for N 64 and 128).  Returns cudaGetLastError() of
// the launch (cudaErrorInvalidValue for what no route takes).
extern "C" int ssd_scan_fwd(int dtype, const void* x, const float* dA,
                            const void* b, int b_heads, long long b_so,
                            long long b_si, long long b_ss, const void* c,
                            int c_heads, long long c_so, long long c_si,
                            long long c_ss, void* y, float* state, int BH,
                            int S, int P, int N, int Q, int route,
                            cudaStream_t stream) {
  const ssd::Strided Bm{b, b_heads, b_so, b_si, b_ss};
  const ssd::Strided Cm{c, c_heads, c_so, c_si, c_ss};
  if (route == 0 && dtype == 0)
    return launch_fma<float>(x, dA, Bm, Cm, y, state, BH, S, P, N, Q, stream);
  if (dtype != 1 || P % 8 || N % 8 || Q % 16)
    return (int)cudaErrorInvalidValue;
#define SSD_WIDE(WN) \
  launch_wide<WN>(x, dA, Bm, Cm, y, state, BH, S, P, N, Q, stream)
  if (route == 2) {
    if (N <= 64) return SSD_WIDE(64);
    if (N <= 128) return SSD_WIDE(128);
    return (int)cudaErrorInvalidValue;
  }
#undef SSD_WIDE
  if (route != 1) return (int)cudaErrorInvalidValue;
#define SSD_TC(NK) \
  launch_tc<NK>(x, dA, Bm, Cm, y, state, BH, S, P, N, Q, stream)
  if (N <= 16) return SSD_TC(1);
  if (N <= 32) return SSD_TC(2);
  if (N <= 64) return SSD_TC(4);
#undef SSD_TC
  return (int)cudaErrorInvalidValue;
}
