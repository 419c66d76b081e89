// Pointer-chase latency probe (latency_chase): one pass — for each tile in
// walk order, start at j = 0, follow j = tile[j] for block_rows * 128
// dependent steps and add the final j (as float32) to the pass's sum.
//
// Replaces _chase_kernel of src/repro/kernels/membench/membench.py (the
// probe of the loaded-latency composite, whose generator sweeps are
// acc.cu's load_sum; see ops.make_timed_kernel).
//
// Bound on an H100: the latency of one load, once per step — every load's
// address is the previous load's value.  No data-sheet rate states that
// latency, and the bytes rule (the buffer read once over the memory rate)
// gives a time orders of magnitude below it.
//
// What the design does about it: nothing may overlap two steps, or the
// Runner's latency_ns (the call's time over passes x n steps) would be the
// latency divided by the number of chains in flight.  The reference's TPU
// grid walks its tiles one after another; here ONE thread (a one-CTA,
// one-thread launch) walks every tile, one after another, so exactly one
// dependent chain runs at a time.  Each step is a volatile inline-PTX load,
// `ld.global.ca` (cache at all levels, L1 included): the walk reads its tile
// through the SM's L1, as the TPU kernel's walk reads its tile from VMEM
// after the pipeline has moved it on chip.  A 64 KiB tile (the default
// 128-row tiling) fits in L1, so after the first touch of each 128-byte line
// a step costs an L1 hit plus the address arithmetic; a point measures that
// near-cache latency whatever the working-set size.
//
// One launch is one pass: L1 keeps no global data from one launch to the
// next, so every pass starts from the same cache state, in the idle probe
// and in the loaded composite alike (whose passes are separated by the
// generator sweeps anyway).  The wrapper launches once per pass.
//
// The walk trusts its buffer: every entry must lie in [0, block_rows * 128)
// (a check on the timed path would sit in the chain; the wrapper runs
// check_chase_perm once per buffer).  The float32 fold follows the
// reference's order: per pass the tiles' final j in walk order from 0.0,
// then that pass's sum into the result, so the plain version can reproduce
// it bit for bit.
#include "membench_common.cuh"

namespace mb {

__device__ __forceinline__ int ld_chase(const int* p) {
  int v;
  asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void chase_kernel(const int* perm, float* out, int n_tiles,
                             int tile_elems, int streams, int accumulate) {
  const int seg = n_tiles / streams;
  float pass_sum = 0.0f;
  for (int step = 0; step < n_tiles; ++step) {
    const int* tile = perm + walk_tile(step, streams, seg) * tile_elems;
    int j = 0;
    for (int k = 0; k < tile_elems; ++k) j = ld_chase(tile + j);
    pass_sum = __fadd_rn(pass_sum, __int2float_rn(j));
  }
  *out = accumulate ? __fadd_rn(*out, pass_sum) : pass_sum;
}

}  // namespace mb

// perm: int32[n_tiles * tile_elems]; out: float[1], set to the pass's sum,
// or added to when accumulate != 0.  One thread walks every tile, once.
// Returns cudaGetLastError().
extern "C" int membench_chase(const void* perm, float* out, int n_tiles,
                              int tile_elems, int streams, int accumulate,
                              void* stream) {
  mb::chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(perm), out, n_tiles, tile_elems, streams,
      accumulate);
  return (int)cudaGetLastError();
}
