// Mamba-2 SSD (state-space duality), forward: per row bh of (B*H) and per
// chunk of Q steps, in order,
//   cum   = prefix sum of dA over the chunk
//   y     = ((C B^T) o L) x + exp(cum) (C state),  L[i,j] = i >= j ? exp(cum_i - cum_j) : 0
//   state = exp(cum_last) state + (B o exp(cum_last - cum))^T x
// with y written per chunk and the state after the last chunk.
//
// Replaces _ssd_kernel of src/repro/kernels/ssd_scan/ssd_scan.py (the Pallas
// kernel behind ssd_scan(), grid (B*H, n_chunks) with the state in VMEM
// scratch across the sequential chunk axis).
//
// Layout: x (BH, S, P) contiguous, float32 or bfloat16, already dt-weighted;
// dA (BH, S) float32 contiguous; B and C (BH, S, N) of x's type given by
// strides: row bh reads outer index bh / heads and inner index bh % heads,
// so (batch, head) views that repeat one group's B over its heads with
// stride 0 need no copy; y (BH, S, P) in x's type; state (BH, N, P) float32.
// All math in float32.
//
// Grid: one CTA of 256 threads per bh row walks its chunks in order, with the
// (N, P) state in shared memory: blocks on a GPU run in no order, so the
// carry cannot go through the grid as on the TPU.  The Q x Q block of a
// chunk (256 KiB at Q = 256 in float32) does not fit in the 227 KB a block
// may use, so the chunk is tiled: 64 query rows at a time against key tiles
// of 64, and key tiles above the diagonal are skipped (L is 0 there).  L is
// chosen with a select, never multiplied by a 0/1 mask (exp(cum_i - cum_j)
// overflows above the diagonal, and inf * 0 = NaN).  Each thread computes
// 4 x 4 outputs per tile product (register blocking), reading shared memory
// twice per four FMAs.
//
// Bound on an H100: at the serving shape (BH 320, S 512, P 64, N 64, Q 256,
// bf16 x/B/C, B and C shared by the 80 heads of a batch row) the reference's
// chunked algorithm counts 13.4 GFLOP per call, ~14 us at the bf16
// tensor-core rate, against ~48 MB of x, dA, B, C, y and state, ~14 us at
// the memory rate: operations and bytes weigh about the same.  This first
// kernel computes in plain float32 FMAs from shared memory (the causal skip
// leaves ~9.4 of the 13.4 GFLOP) and is bound by shared-memory reads and the
// float32 units; it is right first and simple, its time stands in PERF.md,
// and tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace ssd

// Bytes of dynamic shared memory the kernel needs for (P, N, Q).
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Q) {
  const long long f = 2LL * Q + 2LL * ssd::kTile * (N + 1) +
                      2LL * ssd::kTile * P + (long long)ssd::kTile * (ssd::kTile + 1) +
                      (long long)N * P;
  return f * (long long)sizeof(float);
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y).  B/C: pointer, heads and
// the strides (in elements) of the outer index, the inner index and the
// step.  Returns cudaGetLastError() of the launch.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const float* dA,
                            const void* b, int b_heads, long long b_so,
                            long long b_si, long long b_ss, const void* c,
                            int c_heads, long long c_so, long long c_si,
                            long long c_ss, void* y, float* state, int BH,
                            int S, int P, int N, int Q, cudaStream_t stream) {
  const ssd::Strided Bm{b, b_heads, b_so, b_si, b_ss};
  const ssd::Strided Cm{c, c_heads, c_so, c_si, c_ss};
  const long long smem = ssd_scan_smem_bytes(P, N, Q);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(ssd::ssd_fwd<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd::ssd_fwd<float><<<BH, ssd::kThreads, smem, stream>>>(
        static_cast<const float*>(x), dA, Bm, Cm, static_cast<float*>(y),
        state, S, P, N, Q);
  } else if (dtype == 1) {
    err = cudaFuncSetAttribute(ssd::ssd_fwd<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd::ssd_fwd<__nv_bfloat16><<<BH, ssd::kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), dA, Bm, Cm,
        static_cast<__nv_bfloat16*>(y), state, S, P, N, Q);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
