#!/usr/bin/env python3
"""Where the time of the bf16 flash-attention kernel goes, on one NVIDIA GPU.

    python3 tools/flash_phases.py

Builds a copy of ``src/repro_torch/kernels/flash_attention/csrc/flash_attn.cu``
in which warp 0 of every CTA stamps the global timer around the phases of
its key-tile loop (the wait for a tile, issuing the next tile's copies,
Q K^T, the softmax, P V), runs it once at the serving shape (4, 512, 32, 32,
80) bf16 causal, and prints the kernel's span, the mean phase times per key
tile by the CTA's tile count, and the CTAs resident per SM.  It also times a
kernel that only issues independent ``mma.sync.m16n8k16`` bf16 products, the
tensor rate this instruction reaches on the card.  Build outputs go to
``build/tools/``.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build as kb  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
OUT = ROOT / "build" / "tools"
FIELDS = ("start", "wait0", "wait", "issue", "qk", "softmax", "loop_end",
          "end", "n_kt", "smid")

# (anchor in flash_attn.cu, text put before it, text put after it)
STAMPS = [
    ("namespace fa {\n", "", """__device__ unsigned long long* g_stamps = nullptr;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""),
    ("  extern __shared__ __align__(16) __nv_bfloat16 sm[];\n", "", """
  const unsigned long long T0 = gtime();
  unsigned long long Tw0 = 0, Tw = 0, Tis = 0, Tqk = 0, Tsm = 0, ta_ = 0;
"""),
    ("    tc::cp_async_wait<kTcStages - 2>();", "    ta_ = gtime();\n", ""),
    ("    const int nxt = jt + kTcStages - 1;\n",
     "    { const unsigned long long t_ = gtime();\n"
     "      if (jt == 0) Tw0 = t_ - ta_; else Tw += t_ - ta_; ta_ = t_; }\n", ""),
    ("    const __nv_bfloat16* ks = kv0 + SLOT * (jt % kTcStages);\n",
     "    { const unsigned long long t_ = gtime(); Tis += t_ - ta_; ta_ = t_; }\n",
     ""),
    ("    // scale (base 2), mask, online softmax;",
     "    { const unsigned long long t_ = gtime(); Tqk += t_ - ta_; ta_ = t_; }\n",
     ""),
    ("    // O += P V: P (bf16) straight from the S fragments, V through",
     "    { const unsigned long long t_ = gtime(); Tsm += t_ - ta_; ta_ = t_; }\n",
     ""),
    ("  tc::cp_async_wait<0>();\n", "",
     "  const unsigned long long T2 = gtime();\n"),
    ("          tc::pack_bf16(oacc[n][2 * h] * inv, oacc[n][2 * h + 1] * inv);"
     "\n  }\n", "", """  if (threadIdx.x == 0 && g_stamps) {
    unsigned int smid;
    asm volatile("mov.u32 %0, %smid;" : "=r"(smid));
    unsigned long long* p = g_stamps + 10 * (blockIdx.y * gridDim.x + blockIdx.x);
    p[0] = T0; p[1] = Tw0; p[2] = Tw; p[3] = Tis; p[4] = Tqk; p[5] = Tsm;
    p[6] = T2; p[7] = gtime(); p[8] = n_kt; p[9] = smid;
  }
"""),
]

MMA_PEAK = r"""
#include "tensor_core.cuh"
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) tc::mma_bf16(acc[j], a, a[j & 3], a[(j + 1) & 3]);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_mma_peak(float* out, int blocks, int iters) {
  mma_peak<<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def build(name: str, text: str) -> ctypes.CDLL:
    """Compile ``text`` into build/tools/lib<name>.so (the port's headers on
    the include path)."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, out = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text.replace('#include "../../tensor_core.cuh"',
                                '#include "tensor_core.cuh"'))
    cmd = [kb.find_nvcc(), *kb.NVCC_FLAGS, "-I",
           str(ROOT / "src/repro_torch/kernels"), "-o", str(out), str(src)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stdout + p.stderr)
    return ctypes.CDLL(str(out))


def stamped_source() -> str:
    text = (CSRC / "flash_attn.cu").read_text()
    for anchor, before, after in STAMPS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in flash_attn.cu: {anchor!r}")
        text = text.replace(anchor, before + anchor + after)
    return text + """
extern "C" int set_stamps(unsigned long long* p) {
  return (int)cudaMemcpyToSymbol(fa::g_stamps, &p, sizeof(p));
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_phases: needs one CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = build("flash_stamped", stamped_source())
    lib.set_stamps.argtypes = [ctypes.c_void_p]
    fn = lib.flash_attn_fwd
    fn.argtypes = fa.LIBRARY.entries["flash_attn.cu"][1]
    fn.restype = ctypes.c_int
    fa.LIBRARY.libs["flash_attn.cu"] = lib      # the wrapper launches this copy
    g = torch.Generator(device=dev).manual_seed(80)
    q, k, v = (torch.randn((4, 512, 32, 80), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    n_cta = 4 * 32 * 512 // 64
    stamps = torch.zeros(n_cta * 10, dtype=torch.int64, device=dev)
    if lib.set_stamps(stamps.data_ptr()):
        raise RuntimeError("cudaMemcpyToSymbol failed")
    for _ in range(3):
        fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    stamps.zero_()
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    a = stamps.view(n_cta, 10).cpu().double()
    c = {f: a[:, i] for i, f in enumerate(FIELDS)}
    t0 = c["start"].min()
    loop = c["loop_end"] - c["start"]
    pv = loop - c["wait0"] - c["wait"] - c["issue"] - c["qk"] - c["softmax"]
    print(f"kernel span {(c['end'].max() - t0) / 1e3:.2f} us, {n_cta} CTAs on "
          f"{len(set(c['smid'].tolist()))} SMs")
    print("per CTA, mean us: life {:.2f}, first wait {:.2f}, epilogue {:.2f}"
          .format((c["end"] - c["start"]).mean() / 1e3,
                  c["wait0"].mean() / 1e3,
                  (c["end"] - c["loop_end"]).mean() / 1e3))
    for n in range(1, 9):
        m = c["n_kt"] == n
        if not m.any():
            continue
        per = lambda x: float((x[m] / n).mean()) / 1e3  # noqa: E731
        print(f"  {int(m.sum())} CTAs of {n} key tiles: per tile us: wait "
              f"{float((c['wait'][m] / max(n - 1, 1)).mean()) / 1e3:.3f}, issue "
              f"{per(c['issue']):.3f}, QK {per(c['qk']):.3f}, softmax "
              f"{per(c['softmax']):.3f}, PV and the rest {per(pv):.3f}")
    events = sorted([(float(s), 1) for s in c["start"]]
                    + [(float(e), -1) for e in c["end"]])
    live, area, last = 0, 0.0, events[0][0]
    for t, d in events:
        area += live * (t - last)
        live, last = live + d, t
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"mean CTAs resident per SM "
          f"{area / float(c['end'].max() - t0) / sms:.2f}")

    peak = build("mma_peak", MMA_PEAK)
    peak.run_mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    for ctas in (sms, 2 * sms, 4 * sms):
        buf = torch.empty(ctas * 256, device=dev)
        iters = 4096
        peak.run_mma_peak(buf.data_ptr(), ctas, iters)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        peak.run_mma_peak(buf.data_ptr(), ctas, iters)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        flops = ctas * 8 * iters * 8 * 2 * 16 * 8 * 16
        print(f"mma.sync m16n8k16 bf16, {ctas} CTAs of 8 warps: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
