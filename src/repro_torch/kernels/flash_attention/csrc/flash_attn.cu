// Causal / non-causal GQA attention, forward: o = softmax(q k^T / sqrt(D)) v
// per query head, with an online softmax over key tiles.
//
// Replaces _attn_kernel of src/repro/kernels/flash_attention/flash_attention.py
// (the Pallas kernel behind flash_attention(), grid (B*KV, q_blocks,
// kv_blocks) with (m, l, acc) in VMEM scratch across the sequential kv axis).
//
// Layout: q (B, Sq, H, D), k (B, Sk, KV, D), v (B, Sk, KV, DV), o (B, Sq, H,
// DV), contiguous, float32 or bfloat16; math in float32, o rounded to the
// input type.  H = G*KV: query head h = kv*G + g reads kv head kv.  Both
// routes are templates over (D, DV), as _attn_kernel takes value heads of
// their own width: DV == D for the GQA models, (192, 128) for MLA's expanded
// prefill (q and k: 128 nope + 64 rope dims, v 128).  Where DV != D, K and V
// are staged with their own row widths and the output has DV columns.
//
// Two routes, chosen by dtype:
//
// bfloat16 — the tensor cores, FlashAttention-2 style on
// mma.sync.m16n8k16 (bf16 in, float32 accumulators).  Bound on an H100: at
// the serving shape (B 4, S 512, H 32, D 80) the useful work is 5.4 GFLOP
// per call against 42 MB of q, k, v and o, so the card could do it in ~12.5
// us, bound by bytes; the first version (float32 FMAs from shared memory,
// four threads a row) was bound by its shared-memory reads and the float32
// units at 49x that.  Design: one CTA of 4 warps per (b*KV + kv, tile of 64
// query rows), where the rows of a kv head are its (position s, group member
// g) pairs in the order s*G + g, so every staged key tile serves the G query
// heads of its kv head, as the Pallas block (1, G, qb, D) does.  Each warp
// owns 16 rows and takes its Q fragments from shared memory with ldmatrix
// (D/16 k-steps: every head dim of HEAD_DIMS is a multiple of 16, so D 80
// takes 5 with no padding).  Key and value tiles of 64 keys come through a
// two-slot cp.async ring (one barrier per tile) in shared memory whose rows
// are padded to D+8 elements, which makes every ldmatrix of 8 rows
// conflict-free for all five head dims (D 80 has no power-of-two row for an
// XOR swizzle); K goes through ldmatrix, V through ldmatrix.trans.  S = Q K^T
// sits in float32 fragments; the online softmax (m, l) works on them, base
// 2 with log2(e) folded into the scale (ex2.approx), with the row max
// reduced over the four lanes of a fragment row by shuffles.  P is rounded
// to bf16 in registers and used as the A operand of P V: the accumulator
// layout of S is the A layout, so P never touches shared memory.  l sums
// the float32 P; O accumulates in float32.  Key tiles past the causal limit
// of the CTA's last row are skipped, and only a tile that reaches past the
// CTA's first row (or past Sk) is masked.  Row indices are 32-bit (a 64-bit
// division is a long software routine).  At D <= 80 registers are capped at
// 128 a thread, so 4 CTAs (16 warps) share an SM.  What still holds it
// above its bound (PERF.md, PR 14, timed per phase on the card): a CTA never
// waits for a tile that was requested (0.02 us a tile), but issuing the next
// tile's copies takes ~0.7 us a tile, as long as Q K^T (~0.6 us), the
// softmax (~0.5 us) or P V (~0.8 us), and ~2.7 us per CTA go to issuing Q
// and the first tile: the copies stall on the memory pipeline (cutting their
// instructions by two thirds gained 1 %; copying whole rows with
// cp.async.bulk ran 2x slower).  The tensor work itself is 6 GFLOP: ~11 us
// at the ~530 TFLOP/s mma.sync reaches on the card.
// Numerics:
// P enters P V in bf16 (2**-9 relative), where the Pallas kernel's float32
// dot at default precision on the TPU multiplies in bf16 as well; held to
// the reference's bf16 tolerance (2e-2).
//
// float32 — the first version, kept for exact float32 (the tensor cores have
// no exact float32 product; this route serves the tests, never the serving
// path).  One CTA per (b*KV + kv, 64 query rows); four threads share a row:
// each owns the head dims d = 4i + lane, the q.k dot is reduced across the
// four with two shuffles, and key/value tiles of 32 are widened to float32 in
// shared memory.
//
// Both routes: the loop over key tiles takes the place of the TPU's
// sequential kv grid axis, with (m, l, acc) in registers.  A masked score is
// -1e30, never -inf (a fully masked row would give exp(-inf - -inf) = NaN);
// the final division is by max(l, 1e-30), as in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../tensor_core.cuh"

namespace fa {

constexpr int kRows = 64;                  // query rows per CTA
constexpr int kLanes = 4;                  // threads per row
constexpr int kThreads = kRows * kLanes;   // 256
constexpr int kKeys = 32;                  // keys per shared-memory tile
constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// float32: the exact route
// ---------------------------------------------------------------------------

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
          int KV, int causal, int q_offset, float scale) {
  static_assert(D % kLanes == 0 && DV % kLanes == 0,
                "head dims must be multiples of 4");
  constexpr int DL = D / kLanes;           // q / k head dims per thread
  constexpr int DVL = DV / kLanes;         // v / o head dims per thread
  __shared__ float ks[kKeys][D];
  __shared__ float vs[kKeys][DV];

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
  const int k_end = causal ? (Sk < s_last + 1 + q_offset ? Sk : s_last + 1 + q_offset)
                           : Sk;

  // this row's (position, head): q at head * D, o at head * DV
  const long long head = ((long long)b * Sq + s) * H + kvh * G + g;
  const long long q_off = head * D;
  float qr[DL], acc[DVL];
#pragma unroll
  for (int i = 0; i < DL; ++i) qr[i] = active ? q[q_off + i * kLanes + lane] : 0.f;
#pragma unroll
  for (int i = 0; i < DVL; ++i) acc[i] = 0.f;
  float m = kMasked, l = 0.f;

  for (int j0 = 0; j0 < k_end; j0 += kKeys) {
    __syncthreads();                       // the previous tile is consumed
    if constexpr (D == DV) {
      for (int e = threadIdx.x; e < kKeys * D; e += kThreads) {
        const int j = e / D, d = e % D, jj = j0 + j;
        float kv = 0.f, vv = 0.f;
        if (jj < Sk) {
          const long long off = (((long long)b * Sk + jj) * KV + kvh) * D + d;
          kv = k[off];
          vv = v[off];
        }
        ks[j][d] = kv;
        vs[j][d] = vv;
      }
    } else {
      for (int e = threadIdx.x; e < kKeys * D; e += kThreads) {
        const int j = e / D, d = e % D, jj = j0 + j;
        ks[j][d] = jj < Sk ? k[(((long long)b * Sk + jj) * KV + kvh) * D + d] : 0.f;
      }
      for (int e = threadIdx.x; e < kKeys * DV; e += kThreads) {
        const int j = e / DV, d = e % DV, jj = j0 + j;
        vs[j][d] = jj < Sk ? v[(((long long)b * Sk + jj) * KV + kvh) * DV + d] : 0.f;
      }
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
      const bool ok = jj < Sk && (!causal || jj <= s + q_offset);
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
    for (int i = 0; i < DVL; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int i = 0; i < DVL; ++i)
        acc[i] = fmaf(sc[j], vs[j][i * kLanes + lane], acc[i]);
    }
    m = m_new;
  }

  if (active) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DVL; ++i)
      o[head * DV + i * kLanes + lane] = acc[i] / den;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core route
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;               // 16 query rows each
// CTAs per SM the register budget is cut for: 4 up to D 80 (<= 128
// registers a thread), 2 above
constexpr int tc_min_blocks(int D) { return D <= 80 ? 4 : 2; }
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 16 * kTcWarps;     // query rows per CTA
constexpr int kTcKeys = 64;                // keys per tile
constexpr int kTcStages = 2;               // slots of (K, V) in the ring
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: Q, then kTcStages slots of (K, V); Q and K rows padded to
// D + 8 elements, V rows to DV + 8 (at (192, 128): 25,600 B of Q and a
// 86,016 B ring, 111,616 B a CTA, 2 an SM)
template <int D, int DV> struct TcSmem {
  static constexpr int kStride = D + 8;                  // Q and K rows
  static constexpr int kStrideV = DV + 8;                // V rows
  static constexpr int kTile = kTcKeys * kStride;        // elements of K
  static constexpr int kSlot = kTile + kTcKeys * kStrideV;  // K and V
  static constexpr int kBytes = (kTcRows * kStride + kTcStages * kSlot) * 2;
};

template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(D))
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             int Sq, int Sk, int H, int KV, int causal, int q_offset,
             float scale) {
  static_assert(D % 16 == 0 && DV % 16 == 0,
                "head dims must be multiples of 16");
  using Smem = TcSmem<D, DV>;
  constexpr int S = Smem::kStride, SV = Smem::kStrideV;
  constexpr int TILE = Smem::kTile, SLOT = Smem::kSlot;
  constexpr int NC = D / 8;                // 16-byte pieces per q / k row
  constexpr int NCV = DV / 8;              // ... per v row
  constexpr int KD = D / 16;               // k-steps of Q K^T
  constexpr int ND = DV / 8;               // n-tiles of O
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* qs = sm;
  __nv_bfloat16* kv0 = sm + kTcRows * S;   // slot s: K at kv0 + s SLOT, V after

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  // row indices in 32 bits (launch_tc checks Sq * G < 2**31): a 64-bit
  // division is a long software routine
  const int n_rows = Sq * G;
  // the last query tiles have the most keys under a causal mask: run first
  const int t0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int t_last = (t0 + kTcRows < n_rows ? t0 + kTcRows : n_rows) - 1;
  // the causal limit of query row s is key s + q_offset: the CTA's first
  // row's, and the keys up to its last row's
  const int lim_first = t0 / G + q_offset, lim_last = t_last / G + q_offset;
  const int k_end = causal ? (Sk < lim_last + 1 ? Sk : lim_last + 1) : Sk;
  const int n_kt = (k_end + kTcKeys - 1) / kTcKeys;

  // Q rows t0 .. t0+63 (zeros past n_rows), then key tile 0
  for (int e = threadIdx.x; e < kTcRows * NC; e += kTcThreads) {
    const int i = e / NC, c = e % NC;
    const int t = t0 + i;
    const bool ok = t < n_rows;
    const int s = ok ? t / G : 0, gm = ok ? t - s * G : 0;
    const size_t src = ((size_t)(b * Sq + s) * H + kvh * G + gm) * D + c * 8;
    tc::cp_async16(qs + i * S + c * 8, q + src, ok ? 16 : 0);
  }
  // key and value tiles: thread t < RPI * NC copies piece t % NC of rows
  // t / NC, + RPI, + 2 RPI, ...; its offsets are worked out once, so a tile
  // costs two cp.async and a few adds a row.  Where DV != D the values are
  // copied by a second such walk over their own row width.
  constexpr int RPI = kTcThreads / NC;     // rows a pass of the CTA copies
  const int pc = threadIdx.x % NC, pr = threadIdx.x / NC;
  const size_t row_elems = (size_t)KV * D;
  const size_t g0 = ((size_t)b * Sk + pr) * row_elems + kvh * D + pc * 8;
  constexpr int RPIV = kTcThreads / NCV;
  const int pcv = threadIdx.x % NCV, prv = threadIdx.x / NCV;
  const size_t row_elems_v = (size_t)KV * DV;
  const size_t g0v = ((size_t)b * Sk + prv) * row_elems_v + kvh * DV + pcv * 8;
  auto load_kv = [&](int slot, int j0) {
    if constexpr (D == DV) {
      if (pr >= RPI) return;
      __nv_bfloat16* dst = kv0 + SLOT * slot + pr * S + pc * 8;
      size_t src = g0 + (size_t)j0 * row_elems;
      for (int r = pr; r < kTcKeys; r += RPI) {
        const int sz = j0 + r < Sk ? 16 : 0;  // keys past Sk: zeros
        tc::cp_async16(dst, k + (sz ? src : 0), sz);
        tc::cp_async16(dst + TILE, v + (sz ? src : 0), sz);
        dst += RPI * S;
        src += RPI * row_elems;
      }
    } else {
      if (pr < RPI) {
        __nv_bfloat16* dst = kv0 + SLOT * slot + pr * S + pc * 8;
        size_t src = g0 + (size_t)j0 * row_elems;
        for (int r = pr; r < kTcKeys; r += RPI) {
          const int sz = j0 + r < Sk ? 16 : 0;
          tc::cp_async16(dst, k + (sz ? src : 0), sz);
          dst += RPI * S;
          src += RPI * row_elems;
        }
      }
      if (prv < RPIV) {
        __nv_bfloat16* dst = kv0 + SLOT * slot + TILE + prv * SV + pcv * 8;
        size_t src = g0v + (size_t)j0 * row_elems_v;
        for (int r = prv; r < kTcKeys; r += RPIV) {
          const int sz = j0 + r < Sk ? 16 : 0;
          tc::cp_async16(dst, v + (sz ? src : 0), sz);
          dst += RPIV * SV;
          src += RPIV * row_elems_v;
        }
      }
    }
  };
  // the ring: Q joins key tile 0's group; tiles 1 .. kTcStages-2 follow
#pragma unroll
  for (int j = 0; j < kTcStages - 1; ++j) {
    if (j < n_kt) load_kv(j, j * kTcKeys);
    tc::cp_async_commit();
  }
  // this warp's 16 rows; this thread's two: g and g + 8
  const int wrow = warp * 16;
  const __nv_bfloat16* qrow = qs + (wrow + lane % 16) * S + (lane / 16) * 8;
  const float sc = scale * kLog2e;
  int klim[2];                             // each row's last key: s + q_offset
  float oacc[ND][4], m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    klim[h] = (t0 + wrow + g + 8 * h) / G + q_offset;
    m[h] = kMasked;
    l[h] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  for (int jt = 0; jt < n_kt; ++jt) {
    tc::cp_async_wait<kTcStages - 2>();    // key tile jt (and Q) has landed
    __syncthreads();                       // ... for all; slot jt-1 is free
    const int nxt = jt + kTcStages - 1;
    if (nxt < n_kt) load_kv(nxt % kTcStages, nxt * kTcKeys);
    tc::cp_async_commit();
    const __nv_bfloat16* ks = kv0 + SLOT * (jt % kTcStages);
    const __nv_bfloat16* vs = ks + TILE;
    const int j0 = jt * kTcKeys;

    // S = Q K^T: 8 n-tiles of 8 keys; Q fragments from shared memory (kept
    // in registers they cost more occupancy than their reloads cost)
    float sacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qk[4];
      tc::ldmatrix_x4(qk, qrow + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        tc::ldmatrix_x4(r, ks + (np * 16 + (lane / 16) * 8 + lane % 8) * S +
                               kk * 16 + ((lane / 8) & 1) * 8);
        tc::mma_bf16(sacc[2 * np], qk, r[0], r[1]);
        tc::mma_bf16(sacc[2 * np + 1], qk, r[2], r[3]);
      }
    }

    // scale (base 2), mask, online softmax; row h of the thread holds
    // elements 2h and 2h+1 of each fragment
    const bool edge = (causal && j0 + kTcKeys - 1 > lim_first) ||
                      j0 + kTcKeys > Sk;
    // (the max is taken over the unscaled scores and scaled once; each p is
    // one FFMA and one ex2)
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int key = j0 + n * 8 + 2 * tq + (e & 1);
          if (key >= Sk || (causal && key > klim[e / 2])) sacc[n][e] = kMasked;
        }
        mx[e / 2] = fmaxf(mx[e / 2], sacc[n][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * sc);
      const float corr = tc::exp2_approx(m[h] - m_new);
      m[h] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sacc[n][2 * h] = tc::exp2_approx(fmaf(sacc[n][2 * h], sc, -m_new));
        sacc[n][2 * h + 1] =
            tc::exp2_approx(fmaf(sacc[n][2 * h + 1], sc, -m_new));
        ps += sacc[n][2 * h] + sacc[n][2 * h + 1];
      }
      l[h] = l[h] * corr + ps;             // this lane's share of the row sum
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        oacc[n][2 * h] *= corr;
        oacc[n][2 * h + 1] *= corr;
      }
    }

    // O += P V: P (bf16) straight from the S fragments, V through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          tc::pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          tc::pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          tc::pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          tc::pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(
            r, vs + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * SV +
                   dp * 16 + (lane / 16) * 8);
        tc::mma_bf16(oacc[2 * dp], pa, r[0], r[1]);
        tc::mma_bf16(oacc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lsum = l[h];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int t = t0 + wrow + g + 8 * h;
    if (t >= n_rows) continue;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    const int s = klim[h] - q_offset;
    __nv_bfloat16* dst =
        o + ((size_t)(b * Sq + s) * H + kvh * G + t - s * G) * DV + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          tc::pack_bf16(oacc[n][2 * h] * inv, oacc[n][2 * h + 1] * inv);
  }
}

template <int D, int DV>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int KV, int causal, int q_offset,
              float scale, cudaStream_t stream) {
  const long long n_rows = (long long)Sq * (H / KV);
  if (n_rows >= (1LL << 31) || (long long)B * Sq >= (1LL << 31) ||
      (long long)B * Sk >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n_rows + kTcRows - 1) / kTcRows), (unsigned)(B * KV));
  constexpr int smem = TcSmem<D, DV>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_tc<D, DV><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Sk, H, KV, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int causal, int q_offset,
               float scale, cudaStream_t stream) {
  const long long n_rows = (long long)Sq * (H / KV);
  dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)(B * KV));
  flash_fwd<D, DV><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace fa

// dtype: 0 float32 (the exact route), 1 bfloat16 (the tensor cores).
// q_offset: query row s is position s + q_offset of the keys' sequence, so
// under the causal mask it sees keys 0 .. s + q_offset (a block of the
// queries against every key up to the block's end: q_offset = Sk - Sq);
// 0 is the square causal mask.  Returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for a (D, Dv) pair it was not built for, or a
// negative q_offset).
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, int B, int Sq, int Sk,
                              int H, int KV, int D, int Dv, int causal,
                              int q_offset, float scale, cudaStream_t stream) {
  if ((dtype != 0 && dtype != 1) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
#define FA_CASE(DIM, DIMV)                                                    \
  if (D == DIM && Dv == DIMV)                                                 \
    return dtype ? fa::launch_tc<DIM, DIMV>(q, k, v, o, B, Sq, Sk, H, KV,     \
                                            causal, q_offset, scale, stream)  \
                 : fa::launch_f32<DIM, DIMV>(q, k, v, o, B, Sq, Sk, H, KV,    \
                                             causal, q_offset, scale, stream);
  FA_CASE(32, 32)
  FA_CASE(64, 64)
  FA_CASE(80, 80)
  FA_CASE(96, 96)
  FA_CASE(128, 128)
  FA_CASE(192, 128)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
