// Shared device code of the membench CUDA kernels (sm_90a).
//
// The kernels in this directory replace the Pallas kernels of the JAX
// reference package (src/repro/kernels/membench/membench.py: _acc_kernel with
// its load_sum / load_only / fma / mxu bodies, _copy_kernel, _triad_kernel,
// and the _stream_index_map block walk).  They compute the same values; the
// structure is rebuilt for a GPU:
//
//  * The reference's grid runs in order on one core and adds into one
//    revisited (1,1) block.  Here CTAs run concurrently, so each CTA keeps a
//    float partial in registers over all its tiles and passes, writes it to a
//    scratch vector, and a second kernel (fold_chunks) folds the vector in
//    a fixed order.  No float atomics: the result is bit-identical
//    from run to run.
//  * The pass loop is inside the kernel (one launch moves passes x buffer),
//    because a launch costs far more than a cache-resident pass.  The
//    tile -> CTA assignment is fixed: CTA c of G owns walk steps c, c+G, ...
//    in every pass, so a share that fits an SM's L1 stays in that L1 and no
//    two CTAs ever write the same output tile.
//  * Nothing here may be deleted, hoisted or merged by the compiler: every
//    global load and store of the timed traffic is a volatile inline-PTX
//    statement (kept, in order, once per execution), and a compiler memory
//    barrier closes each pass.  The reference chains its passes through a
//    one-element `acc * 1e-30` write; that write is value-neutral at these
//    magnitudes and exists only to stop XLA hoisting the loop body, so it has
//    no counterpart here.
//  * unroll = U replicates the pass body U times per loop trip (template
//    parameter), interleave = K gives K independent accumulators / store
//    streams per tile, streams = S maps walk step i to tile
//    (i % S) * (n_tiles / S) + i / S.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mb {

constexpr int kThreads = 256;   // threads per CTA
constexpr int kLanes = 128;     // elements per buffer row

// walk step -> tile index (S interleaved address streams)
__device__ __forceinline__ long long walk_tile(int step, int streams, int seg) {
  return (long long)(step % streams) * seg + step / streams;
}

// 16-byte global load / store the compiler can neither delete nor hoist
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void st16(void* p, uint4 v) {
  asm volatile("st.global.v4.u32 [%0], {%1,%2,%3,%4};"
               :
               : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// the pass boundary: no memory access moves across it
__device__ __forceinline__ void pass_barrier() {
  asm volatile("" ::: "memory");
}

// element views of one 16-byte vector -------------------------------------
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(uint4 v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// bfloat16 is the upper half of a float: element 2i is the low half-word
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void unpack(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ uint32_t word(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(word(f[0], f[1]), word(f[2], f[3]), word(f[4], f[5]),
                      word(f[6], f[7]));
  }
};

// round a float to the working type and back (bfloat16: one rounding)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ float vec_sum(uint4 v) {
  float f[Vec<T>::N];
  Vec<T>::unpack(v, f);
  float s = f[0];
#pragma unroll
  for (int i = 1; i < Vec<T>::N; ++i) s += f[i];
  return s;
}

// fixed-order sum over the CTA; the result is valid in thread 0
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[kThreads / 32];
  __syncthreads();                       // warp_part may be in use
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kThreads / 32 ? warp_part[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// a fold stage: out[o] = sum of p[o * chunk ..) (at most chunk of them,
// fewer in the last CTA), in a fixed order; a thread's four loads are
// issued together
__global__ void __launch_bounds__(kThreads)
fold_chunks(const float* p, long long n, long long chunk, float* out) {
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long i = lo + threadIdx.x; i < hi; i += 4 * kThreads) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j * kThreads < hi) v[j] += p[i + j * kThreads];
  }
  const float s = block_sum((v[0] + v[1]) + (v[2] + v[3]));
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

}  // namespace mb

// dispatch helpers for the C entry points ---------------------------------
#define MB_UNROLL_CASES(CALL)                                               \
  switch (unroll) {                                                         \
    case 1: CALL(1); break;                                                 \
    case 2: CALL(2); break;                                                 \
    case 4: CALL(4); break;                                                 \
    case 8: CALL(8); break;                                                 \
    default: return (int)cudaErrorInvalidValue;                             \
  }
