#!/usr/bin/env python3
"""``flash_attn.cu`` of this checkout against another checkout's, on one
NVIDIA GPU in one process: for an A/B of two commits of the kernel.

    python3 tools/flash_ab.py --src DIR/src [--out-dir DIR]

Builds the other checkout's ``kernels/flash_attention/csrc/flash_attn.cu``
beside this one's (``build/flash_attention_other/``) and calls it through
its own C entry point (with or without the causal ``q_offset`` argument,
as its source declares it).  Then, at offset 0, every flash shape
``chip_smoke.py`` phase 2c holds (the reference test's, the five dense /
vlm serving shapes, the (D, Dv) = (192, 128) and Sq != Sk shapes and the
hybrid's serving shape), both dtypes where the float32 route is quick,
causal and not: the two outputs must be equal bit for bit.  Then device
time (the calls enqueued behind a device-side sleep) at the hybrid's,
granite-3-2b's and deepseek-v2-236b's serving shapes, in the order
other, this, this, other.  Prints each build's registers and spills of
its tensor-core instances, and writes ``<out-dir>/flash_ab.json`` with
the card's name and power limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels.build import KernelLibrary, launch, raise_on  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402

DEV = torch.device("cuda", 0)
#: (B, Sq, Sk, H, KV, D, Dv): the shapes of chip_smoke.py phase 2c
SHAPES = [(2, 128, 128, 8, 4, 64, 64), (1, 256, 256, 4, 4, 32, 32),
          (2, 128, 128, 8, 2, 64, 64), (1, 128, 128, 16, 16, 32, 32),
          (1, 128, 128, 4, 4, 80, 80), (2, 64, 64, 8, 2, 80, 80),
          (1, 128, 128, 4, 2, 128, 128),
          (4, 512, 512, 32, 8, 64, 64), (4, 512, 512, 32, 32, 80, 80),
          (4, 512, 512, 40, 10, 128, 128), (4, 512, 512, 48, 8, 128, 128),
          (4, 512, 512, 64, 8, 128, 128),
          (2, 128, 128, 8, 4, 192, 128), (1, 200, 200, 4, 4, 192, 128),
          (2, 300, 100, 4, 2, 192, 128), (2, 100, 300, 4, 2, 64, 64)]
#: the serving shapes timed: the hybrid's, granite-3-2b's, deepseek's mla
TIMED = {"zamba2-2.7b (D 80)": (4, 512, 512, 32, 32, 80, 80),
         "granite-3-2b (D 64)": (4, 512, 512, 32, 8, 64, 64),
         "deepseek-v2-236b (192, 128)": (4, 512, 512, 128, 128, 192, 128)}
_P, _I = ctypes.c_void_p, ctypes.c_int


def other_library(src: Path) -> tuple[KernelLibrary, bool]:
    """The other checkout's flash library and whether its entry point
    takes ``q_offset``."""
    csrc = src / "repro_torch" / "kernels" / "flash_attention" / "csrc"
    offset = "int q_offset" in (csrc / "flash_attn.cu").read_text()
    args = [_I, _P, _P, _P, _P] + [_I] * (8 + offset) + [ctypes.c_float, _P]
    return KernelLibrary("flash_attention_other", csrc,
                         {"flash_attn.cu": ("flash_attn_fwd", args)},
                         headers=("../../tensor_core.cuh",)), offset


def other_flash(lib, offset: bool, q, k, v, causal: bool = True):
    B, Sq, H, D = q.shape
    _, Sk, KV, Dv = v.shape
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    args = [{torch.float32: 0, torch.bfloat16: 1}[q.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, H, KV, D,
            Dv, int(causal)] + [0] * offset + [1.0 / math.sqrt(D)]
    raise_on(launch(lib.entry("flash_attn.cu"), q, *args), "other flash")
    return o


def qkv(shape, dtype):
    B, Sq, Sk, H, KV, D, Dv = shape
    g = torch.Generator(device=DEV).manual_seed(sum(shape))
    return tuple(torch.randn(s, generator=g, device=DEV).to(dtype)
                 for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, Dv)))


def device_ms(fn, n: int = 20, warmup: int = 2) -> float:
    """Mean device ms per call over ``n`` back-to-back calls enqueued behind
    a device-side sleep long enough for the host to enqueue them all."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    cycles = 10**7
    for _ in range(6):
        torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(n):
            fn()
        covered = not t0.query()
        t1.record()
        torch.cuda.synchronize()
        if covered:
            return t0.elapsed_time(t1) / n
        cycles *= 4
    raise AssertionError("device_ms: the host did not get ahead of the device")


def registers(lib: KernelLibrary) -> list[str]:
    """The build log's register and spill lines of the tensor-core
    instances."""
    out, fn = [], ""
    log = lib.build_all()["flash_attn.cu"].with_suffix(".log")
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        if "flash_fwd_tc" in fn and ("spill" in line or "Used" in line):
            out.append(f"{fn[:36]} {line.strip()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the other checkout's src/ directory")
    ap.add_argument("--out-dir", default=str(ROOT / "artifacts" / "flash"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    lib, offset = other_library(Path(args.src).resolve())
    for name, which in (("other", lib), ("this", fa.LIBRARY)):
        for line in registers(which):
            print(f"  {name}: {line}")
    n = 0
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.float32 and shape[1] * shape[3] > 16384:
                continue
            q, k, v = qkv(shape, dtype)
            for causal in (True, False):
                a = other_flash(lib, offset, q, k, v, causal)
                b = fa.flash_attention(q, k, v, causal=causal,
                                       q_block=shape[1], kv_block=shape[2])
                if not torch.equal(a, b):
                    raise AssertionError(f"{shape} {dtype} causal={causal}: "
                                         f"the two builds differ")
                n += 1
    print(f"  offset 0: {n} launches bit for bit equal ({len(SHAPES)} "
          f"shapes, both dtypes where quick, causal and not)")
    times = {}
    for label, shape in TIMED.items():
        q, k, v = qkv(shape, torch.bfloat16)
        runs = {"other": lambda: other_flash(lib, offset, q, k, v),
                "this": lambda: fa.flash_attention(q, k, v)}
        times[label] = [(w, device_ms(runs[w]))
                        for w in ("other", "this", "this", "other")]
        print(f"  device ms {label} {shape}: " + ", ".join(
            f"{w} {t:.4f}" for w, t in times[label]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_ab.json").write_text(json.dumps(
        {"device": smi, "bitwise_launches": n, "device_ms": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
