// Causal / non-causal GQA attention, forward: o = softmax(q k^T / sqrt(D)) v
// per query head, with an online softmax over key tiles.
//
// Replaces _attn_kernel of src/repro/kernels/flash_attention/flash_attention.py
// (the Pallas kernel behind flash_attention(), grid (B*KV, q_blocks,
// kv_blocks) with (m, l, acc) in VMEM scratch across the sequential kv axis).
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, KV, D), o (B, Sq, H, D), contiguous,
// float32 or bfloat16; math in float32, o rounded to the input type.  H = G*KV:
// query head h = kv*G + g reads kv head kv.
//
// Grid: one CTA per (b*KV + kv, tile of 64 query rows), where the rows of a kv
// head are its (position s, group member g) pairs in the order s*G + g, so a
// CTA carries the G query heads of its kv head, as the Pallas block
// (1, G, qb, D) does, and every key tile it stages in shared memory serves
// all of them.  The CTA loops over key tiles of 32 up to the causal limit of
// its last row (tiles that start after it are skipped, not run masked): the
// loop takes the place of the TPU's sequential kv grid axis, and (m, l, acc)
// live in registers.  Four threads share a row: each owns the head dims
// d = 4i + lane, the q.k dot is reduced across the four with two shuffles,
// and each keeps its share of acc.  A masked score is -1e30, never -inf (a
// fully masked row would give exp(-inf - -inf) = NaN); the final division is
// by max(l, 1e-30), as in the reference.
//
// Bound on an H100: at the serving shape (B 4, S 512, H 32, D 80, bf16) the
// useful work is 5.4 GFLOP per call against 42 MB of q, k, v and o, so the
// card could do it in ~12.5 us, bound by bytes.  This first kernel computes
// in plain float32 FMAs from shared memory, not on the tensor cores, and is
// bound by its shared-memory reads and the float32 units; it is right first
// and simple, its time stands in PERF.md, and moving it to wgmma is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa {

constexpr int kRows = 64;                  // query rows per CTA
constexpr int kLanes = 4;                  // threads per row
constexpr int kThreads = kRows * kLanes;   // 256
constexpr int kKeys = 32;                  // keys per shared-memory tile
constexpr float kMasked = -1e30f;

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KV, int causal, float scale) {
  static_assert(D % kLanes == 0, "head dim must be a multiple of 4");
  constexpr int DL = D / kLanes;           // head dims per thread
  __shared__ float ks[kKeys][D];
  __shared__ float vs[kKeys][D];

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int row = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long n_rows = (long long)Sq * G;
  const long long t0 = (long long)blockIdx.x * kRows;
  const long long t = t0 + row;
  const bool active = t < n_rows;
  const int s = active ? (int)(t / G) : 0;
  const int g = active ? (int)(t % G) : 0;
  const long long t_last = (t0 + kRows < n_rows ? t0 + kRows : n_rows) - 1;
  const int s_last = (int)(t_last / G);
  // causal skip: key tiles that start after the CTA's last row are not run
  const int k_end = causal ? (Sk < s_last + 1 ? Sk : s_last + 1) : Sk;

  const long long q_off = (((long long)b * Sq + s) * H + kvh * G + g) * D;
  float qr[DL], acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qr[i] = active ? to_f(q[q_off + i * kLanes + lane]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kMasked, l = 0.f;

  for (int j0 = 0; j0 < k_end; j0 += kKeys) {
    __syncthreads();                       // the previous tile is consumed
    for (int e = threadIdx.x; e < kKeys * D; e += kThreads) {
      const int j = e / D, d = e % D, jj = j0 + j;
      float kv = 0.f, vv = 0.f;
      if (jj < Sk) {
        const long long off = (((long long)b * Sk + jj) * KV + kvh) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float sc[kKeys];
    float tile_max = kMasked;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) part = fmaf(qr[i], ks[j][i * kLanes + lane], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int jj = j0 + j;
      const bool ok = jj < Sk && (!causal || jj <= s);
      sc[j] = ok ? part * scale : kMasked;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      sc[j] = expf(sc[j] - m_new);
      psum += sc[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int i = 0; i < DL; ++i)
        acc[i] = fmaf(sc[j], vs[j][i * kLanes + lane], acc[i]);
    }
    m = m_new;
  }

  if (active) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DL; ++i)
      o[q_off + i * kLanes + lane] = from_f<T>(acc[i] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  const long long n_rows = (long long)Sq * (H / KV);
  dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)(B * KV));
  flash_fwd<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Sk, int H, int KV, int causal, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 96: return launch<T, 96>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fa

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for a head dim it was not built for).
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, int B, int Sq, int Sk,
                              int H, int KV, int D, int causal, float scale,
                              cudaStream_t stream) {
  if (dtype == 0)
    return fa::dispatch<float>(D, q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
  if (dtype == 1)
    return fa::dispatch<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}
