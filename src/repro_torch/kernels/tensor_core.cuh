// Warp-level tensor-core and asynchronous-copy primitives (inline PTX) shared
// by the hand-written kernels of the port: mxu.cu (membench), flash_attn.cu
// (flash attention) and ssd_scan.cu (Mamba-2 SSD).  Compiled for sm_90a;
// every instruction here exists since sm_80 and runs on Hopper as it is.
//
//  * cp.async: one 16-byte copy from global to shared memory that the thread
//    does not wait for; copies are grouped by commit and waited for by
//    group count.  With src_bytes 0 the 16 bytes are zero-filled.
//  * ldmatrix: a warp loads four (or two) 8x8 bf16 matrices from shared
//    memory, each lane giving the address of one 16-byte row, into the
//    fragment layout of mma.sync (with .trans: transposed).
//  * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: D(16x8) =
//    A(16x16) B(16x8) + C in float32; the bf16 products are exact in float32.
//
// Fragment layout of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A: a0 (row g,   k 2t, 2t+1)  a1 (row g+8, k 2t, 2t+1)
//      a2 (row g,   k 2t+8, +9)  a3 (row g+8, k 2t+8, +9)
//   B: b0 (k 2t, 2t+1, col g)    b1 (k 2t+8, 2t+9, col g)
//   C: c0, c1 (row g, col 2t, 2t+1)   c2, c3 (row g+8, col 2t, 2t+1)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :
               : "r"(smem_addr(smem)), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two 8x8 matrices, transposed: lanes 0-15 give the row addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a b (16x8x16, bf16 in, float32 accumulators).  Registers only, so not
// volatile: the compiler may schedule it around the (volatile) loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2**x, one MUFU instruction (max relative error 2**-22; 2**-1e30 -> 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16 (lo in the low half), each
// rounded to nearest even: one cvt instruction
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

}  // namespace tc
