#!/usr/bin/env python3
"""Device times of the streaming membench kernels (``csrc/copy.cu``,
``csrc/rw.cu``, ``csrc/triad.cu``, ``csrc/acc.cu``) and of their design
variants, on one NVIDIA GPU.

    python3 tools/stream_variants.py                   # wrappers + variants
    python3 tools/stream_variants.py --mode wrappers --src DIR --label NAME
    python3 tools/stream_variants.py --quick           # no 2 GiB shapes
    python3 tools/stream_variants.py --sweep triad     # triad and its variants
    python3 tools/stream_variants.py --sweep acc       # acc.cu, its variants
    python3 tools/stream_variants.py --sweep copy      # copy.cu, its variants

``wrappers``: ``membench.copy``, ``membench.rw`` over the R:W ladder,
``membench.triad`` (beside rw_2to1, which computes the same function) and
``membench.load_sum`` / ``load_only`` / ``fma`` (depth 8) of the package
under ``--src`` (default: this checkout's ``src``), with the library calls
``out.copy_(x)``, ``torch.add(x, y, alpha=1.5, out=out)`` and ``x.sum``
beside them, at 32 KiB and 1 MiB float32 (2048 and 64 passes a call, so
that the cache level and not the launch is timed) and at 16 MiB and 2 GiB in
float32 and bfloat16 (one pass, as ``chip_smoke.py`` phase 5 times them).
Every time is device time: the calls are enqueued behind a device-side
sleep, so the host's pace drops out; ``host_ms`` is what enqueueing one
call cost the host.  Every output is checked against the plain version
(bit for bit) before it is timed.

``variants``: builds ``tools/stream_variants.cu`` (one ``nvcc`` per
library, all started together, into ``build/tools/``; a library that does
not build is reported and skipped) and times, at the same shapes, two
sweeps (``--sweep``).  The first: vectors in flight per thread (1, 4, 8) in
a kernel compiled without a residency bound, the work split (``walk``: CTA
c of G takes tiles c, c+G, ...; ``split``: the last round's tiles cut
evenly, to the vector, over all G CTAs; ``balanced``: as ``split`` with G a
multiple of the SM count), CTAs per SM (2, 4, 8), load / store cache hints,
and bulk copies (``cp.async.bulk`` through shared memory, an mbarrier
ring).  The second: the pass body of ``csrc/stream.cuh`` (the one rw.cu
runs) for every (R, vectors in flight, CTAs an SM it is compiled for) of
``LEAN``, each work split (the split now in 128-byte granules), with plain
and ``st.global.cs`` stores.  The third: the (R, V, CTAs) of ``THIRD`` with
every hint set of ``HINT_NAMES`` (``st.global.cs`` stores,
``ld.global.L2::256B`` loads, both, neither), on rw.cu's tile walk and on a
rotated walk (CTA c starts every tile at its own 512-byte offset, so that the
CTAs are not all at one offset of their tiles at once).  ``triad`` (alone:
the wrappers are then timed at the triad point of the ladder only): the
triad variants of the ``SV_TRIAD`` build (``np``: a non-persistent grid of
blocks of THREADS x V vectors in address order, one block per piece and the
pass the slow grid dimension; ``win``: a persistent grid of every CTA that
stays resident taking the same blocks c, c + G, ..., so that the CTAs in
flight cover one compact window), for V in 1, 2, 4, 8 and THREADS in 256,
512, 1024, against ``membench.triad`` and ``torch.add``.  ``acc`` and
``copy`` (alone: the wrappers are then timed for those kernels only): the
kernels of ``csrc/acc.cu`` (load_sum, load_only, fma) or ``csrc/copy.cu``
built at other grid shapes (the ``SV_ACC`` build: blocks of 64 to 4096
vectors, ``ACC_LIST``, persistent ``win`` and non-persistent ``np``; the
persistent 256-thread shape also on 1 and 2 CTAs an SM, ``G1`` / ``G2``,
and, for acc, ``walk T256 V1 C4``: the persistent kernel without its
``acc_linear`` branch), against the current wrappers; ``--configs`` keeps
only the named ones.  Each config is timed twice, in turns with the
others, and keeps its lesser time; configs whose launches are the same at a
shape are timed once.

Prints a summary (the configs ranked by the geometric mean of their time
over the current wrappers', with their worst ratio) and writes every
number to ``<out-dir>/<label>.json`` and ``.txt`` (default
``artifacts/stream_variants``).
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KiB, MiB, GiB = 2**10, 2**20, 2**30
LADDER = ((1, 2), (1, 1), (2, 1), (3, 1), (4, 1))
#: (dtype, working-set bytes, passes a call, calls a timing)
SHAPES = (("float32", 32 * KiB, 2048, 10), ("float32", 1 * MiB, 64, 20),
          ("float32", 16 * MiB, 1, 100), ("bfloat16", 16 * MiB, 1, 100),
          ("float32", 2 * GiB, 1, 5), ("bfloat16", 2 * GiB, 1, 5))
#: (load hint, store hint) pairs built from stream_variants.cu
HINTS = ((0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (0, 1), (0, 2), (2, 1))
LD_NAMES = ("ld", "ld.nc.L1::no_allocate", "ld.L2::evict_first", "ld.nc",
            "ld.L1::no_allocate")
ST_NAMES = ("st", "st.cs", "st.L2::evict_first")
#: (R, vectors in flight, CTAs an SM) of the second sweep (SV_LEAN_LIST)
LEAN = ((1, 1, 8), (1, 2, 8), (1, 1, 4), (1, 2, 4), (1, 4, 4), (1, 8, 4),
        (1, 4, 2), (1, 8, 2), (1, 8, 1),
        (2, 1, 8), (2, 1, 4), (2, 2, 4), (2, 4, 4), (2, 4, 2), (2, 8, 2),
        (2, 8, 1),
        (3, 1, 4), (3, 2, 4), (3, 4, 4), (3, 4, 2), (3, 8, 2), (3, 8, 1),
        (4, 1, 4), (4, 2, 4), (4, 4, 4), (4, 2, 2), (4, 4, 2), (4, 8, 1))
#: the (R, vectors in flight, CTAs an SM) the third sweep times with every
#: hint set and with the rotated tile walk
THIRD = ((1, 8, 4), (1, 4, 4), (1, 4, 2), (1, 8, 1), (2, 2, 4), (2, 1, 4),
         (2, 4, 2), (3, 2, 4), (3, 1, 4), (3, 4, 2), (4, 2, 4), (4, 1, 4),
         (4, 2, 2), (4, 4, 2))
#: hint sets of the lean kernels (stream.cuh bits)
HINT_NAMES = {0: "", 1: " st.cs", 2: " ld.L2::256B", 3: " ld.L2::256B/st.cs"}


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("all", "wrappers"), default="all")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--sweep", choices=("first", "second", "third", "all",
                                        "triad", "acc", "copy"),
                    default="all")
    ap.add_argument("--quick", action="store_true",
                    help="leave out the 2 GiB shapes")
    ap.add_argument("--configs", default="",
                    help="--sweep acc / copy: time only these variants "
                         "(comma-separated names as the sweep prints them, "
                         "e.g. 'win T256 V1 C4,walk T256 V1 C4')")
    ap.add_argument("--out-dir", default=str(ROOT / "artifacts" /
                                             "stream_variants"))
    return ap.parse_args()


ARGS = parse_args()
sys.path.insert(0, str(Path(ARGS.src).resolve()))

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("stream_variants: no CUDA device", file=sys.stderr)
    sys.exit(2)

from repro_torch.core import instruction_mix as im  # noqa: E402
from repro_torch.core.buffers import working_set  # noqa: E402
from repro_torch.kernels.membench import membench as mb  # noqa: E402

DEV = torch.device("cuda", 0)
OUT = Path(ARGS.out_dir)
LINES: list[str] = []


def say(msg: str = "") -> None:
    print(msg, flush=True)
    LINES.append(msg)


def device_ms(fn, n: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, host ms) per call over ``n`` back-to-back calls enqueued
    behind a device-side sleep long enough for the host to enqueue them
    all (lengthened until the first event is still pending when the last
    call is in); the host figure is the enqueueing loop's own time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    cycles = 10**7
    for _ in range(6):
        torch.cuda._sleep(cycles)
        t0.record()
        h0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - h0) * 1e3 / n
        covered = not t0.query()
        t1.record()
        torch.cuda.synchronize()
        if covered:
            return t0.elapsed_time(t1) / n, host
        cycles *= 4
    raise AssertionError("device_ms: the host did not get ahead of the device")


def shapes():
    return [s for s in SHAPES if not (ARGS.quick and s[1] >= GiB)]


def operands(dname: str, nbytes: int, reads: int, writes: int):
    dtype = getattr(torch, dname)
    x = working_set(nbytes, dtype=dtype, device=DEV)
    ys = im.rw_streams(x, reads)[1:]
    outs = tuple(torch.empty_like(x) for _ in range(writes))
    want = mb.plain_rw(x, *ys, writes=1)[0]
    return x, ys, outs, want


def check(outs, want, what: str) -> None:
    for o in outs:
        if not torch.equal(o, want):
            raise AssertionError(f"{what}: output differs from plain_rw")
        o.zero_()


# ---------------------------------------------------------------------------
# the wrappers of the package under --src
# ---------------------------------------------------------------------------

FMA_DEPTH = 8
ACC_KERNELS = ("load_sum", "load_only", "fma")


def acc_call(kernel: str, x, br: int, passes: int):
    kw = dict(block_rows=br, passes=passes)
    return {"load_sum": lambda: mb.load_sum(x, **kw),
            "load_only": lambda: mb.load_only(x, **kw),
            "fma": lambda: mb.fma(x, FMA_DEPTH, **kw)}[kernel]


def check_acc(kernel: str, got, x, br: int, passes: int, what: str) -> None:
    """A result of load_sum / load_only / fma against its plain version: on
    the working set the sums of load_sum and fma cancel (an absolute bound,
    the reference's n * 1e-7 * 1.3 per sweep and link), load_only's do not
    (1e-5 of the value)."""
    want = {"load_sum": lambda: mb.plain_load_sum(x, passes),
            "load_only": lambda: mb.plain_load_only(x, br, passes),
            "fma": lambda: mb.plain_fma(x, FMA_DEPTH, passes)}[kernel]()
    if kernel == "load_only":
        tol = 1e-5 * abs(float(want))
    else:
        link = FMA_DEPTH if kernel == "fma" else 1
        tol = max(x.numel() * 1e-7 * 1.3 * passes * link, 1e-4)
    if not abs(float(got) - float(want)) <= tol:
        raise AssertionError(f"{what}: {float(got)} against the plain "
                             f"version's {float(want)} (tolerance {tol})")


def time_acc_wrappers(dname, nbytes, passes, n) -> list[dict]:
    x = working_set(nbytes, dtype=getattr(torch, dname), device=DEV)
    br = mb.default_block_rows(x.shape[0])
    lib = (lambda: x.sum(dtype=torch.float32)) if passes == 1 else None
    lt = [device_ms(lib, n)[0] for _ in range(2)] if lib else None
    rows = []
    for kernel in ACC_KERNELS:
        fn = acc_call(kernel, x, br, passes)
        hp = min(passes, 8)       # checked at <= 8 passes, as phase 5 does
        check_acc(kernel, acc_call(kernel, x, br, hp)(), x, br, hp,
                  f"{kernel} {dname} {nbytes}")
        t = [device_ms(fn, n) for _ in range(2)]
        r = {"label": ARGS.label, "kernel": kernel, "dtype": dname,
             "nbytes": nbytes, "passes": passes,
             "device_ms": min(a for a, _ in t),
             "host_ms": min(b for _, b in t),
             "library_device_ms": min(lt) if lt else None,
             "bound_ms": x.numel() * x.element_size() * passes / 3.35e12
             * 1e3}
        rows.append(r)
        say(f"  {kernel:9s} {dname:8s} {nbytes:>11d} B x{passes:<5d} "
            f"device {r['device_ms']:.5f} ms  host {r['host_ms']:.5f}  "
            "x.sum " + ("-" if lt is None else f"{r['library_device_ms']:.5f}")
            + f"  bound {r['bound_ms']:.5f}")
    del x
    torch.cuda.empty_cache()
    return rows


def time_wrappers() -> list[dict]:
    say(f"== wrappers of {ARGS.src} ({ARGS.label})")
    rows = []
    ladder = {"triad": ((2, 1),), "acc": (), "copy": ((1, 1),)}.get(
        ARGS.sweep, LADDER)
    for dname, nbytes, passes, n in shapes():
        if ARGS.sweep not in ("triad", "copy"):
            rows += time_acc_wrappers(dname, nbytes, passes, n)
        for reads, writes in ladder:
            x, ys, outs, want = operands(dname, nbytes, reads, writes)
            br = mb.default_block_rows(x.shape[0])
            calls = {"rw": lambda: mb.rw(x, *ys, reads=reads, writes=writes,
                                         outs=outs, block_rows=br,
                                         passes=passes)}
            if (reads, writes) == (1, 1):
                calls["copy"] = lambda: mb.copy(x, outs[0], block_rows=br,
                                                passes=passes)
                if ARGS.sweep == "copy":
                    del calls["rw"]
            if (reads, writes) == (2, 1):
                calls["triad"] = lambda: mb.triad(x, ys[0], outs[0],
                                                  block_rows=br,
                                                  passes=passes)
            for name, fn in calls.items():
                fn()
                check(outs, want, f"{name} {reads}:{writes} {dname} {nbytes}")
            lib = {(1, 1): lambda: outs[0].copy_(x),
                   (2, 1): lambda: torch.add(x, ys[0], alpha=1.5,
                                             out=outs[0])
                   }.get((reads, writes)) if passes == 1 else None
            for name, fn in calls.items():
                t = [device_ms(fn, n) for _ in range(2)]
                lt = [device_ms(lib, n)[0] for _ in range(2)] if lib else None
                mix = name if name != "rw" else f"rw_{reads}to{writes}"
                nb = (reads + writes) * x.numel() * x.element_size() * passes
                r = {"label": ARGS.label, "kernel": mix, "dtype": dname,
                     "nbytes": nbytes, "passes": passes,
                     "device_ms": min(a for a, _ in t),
                     "host_ms": min(b for _, b in t),
                     "library_device_ms": min(lt) if lt else None,
                     "bound_ms": nb / 3.35e12 * 1e3}
                rows.append(r)
                say(f"  {mix:9s} {dname:8s} {nbytes:>11d} B x{passes:<5d} "
                    f"device {r['device_ms']:.5f} ms  host "
                    f"{r['host_ms']:.5f}  library "
                    + ("-" if lt is None else f"{r['library_device_ms']:.5f}")
                    + f"  bound {r['bound_ms']:.5f}")
            del x, ys, outs, want
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the variants of tools/stream_variants.cu
# ---------------------------------------------------------------------------

def build_variants() -> dict:
    """Library key -> loaded library: ("first", ld, st) per hint pair of
    the first sweep, ("lean", st) per store hint of the second."""
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    nvcc = find_nvcc()
    out = ROOT / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "src/repro_torch/kernels/membench/csrc"
    keys = []
    if ARGS.sweep in ("first", "all"):
        keys += [("first", ld, st) for ld, st in HINTS]
    if ARGS.sweep in ("second", "all"):
        keys += [("lean", h) for h in (0, 1)]
    if ARGS.sweep in ("third", "all"):
        keys += [("lean", h) for h in HINT_NAMES if ("lean", h) not in keys]
    if ARGS.sweep == "triad":
        keys = [("triad",)]
    if ARGS.sweep in ("acc", "copy"):
        keys = [("acc",)]
    t0 = time.perf_counter()
    procs = {}
    for key in keys:
        so = out / f"stream_variants-{'-'.join(map(str, key))}.so"
        defs = ([f"-DSV_LD={key[1]}", f"-DSV_ST={key[2]}"] if key[0] == "first"
                else ["-DSV_TRIAD"] if key[0] == "triad"
                else ["-DSV_ACC"] if key[0] == "acc"
                else ["-DSV_LEAN", f"-DSV_HINT={key[1]}"])
        cmd = [nvcc, *NVCC_FLAGS, f"-I{csrc}", *defs, "-o", str(so),
               str(ROOT / "tools" / "stream_variants.cu")]
        procs[key] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            say(f"  {key} did not build:\n{log[-1500:]}")
            continue
        lib = ctypes.CDLL(str(so))
        if key[0] == "triad":
            lib.sv_triad_launch.argtypes = [I, I, I, I, P, P, P] + [I] * 6 \
                + [P]
        elif key[0] == "acc":
            lib.sv_acc_launch.argtypes = [I] * 6 + [P, P, P] + [I] * 6 + [P]
        elif key[0] == "first":
            lib.sv_rw_launch.argtypes = [I, I, I, P, P, I, I, I, I, I, I, I, P]
            lib.sv_bulk_launch.argtypes = [I, I, P, P, I, I, LL, I, I, I, I,
                                           I, I, P]
        else:
            lib.sv_lean_launch.argtypes = [I, I, I, I, P, P] + [I] * 8 + [P]
        libs[key] = lib
        spills, fn = [], ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln and "'" in ln:
                fn = ln.split("'")[1]
            elif "spill stores" in ln and " 0 bytes spill stores" not in ln:
                spills.append(f"{fn}: {ln.strip()}")
        for sp in spills:
            say(f"  {key} spills: {sp}")
    say(f"  built {len(libs)} of {len(keys)} libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    return libs


def configs(libs: dict) -> list[dict]:
    out = []
    if ("first", 0, 0) in libs:
        for v in (1, 4, 8):
            for plan in ("walk", "split", "balanced"):
                for ctas in (2, 4, 8):
                    out.append({"kind": "regs", "lib": ("first", 0, 0),
                                "vecs": v, "plan": plan, "ctas": ctas})
        for ld, st in HINTS[1:]:
            if ("first", ld, st) in libs:
                for v in (4, 8):
                    out.append({"kind": "regs", "lib": ("first", ld, st),
                                "vecs": v, "plan": "balanced", "ctas": 4})
        for ctas, chunk in ((1, 16 * KiB), (1, 32 * KiB), (2, 8 * KiB),
                            (2, 16 * KiB)):
            out.append({"kind": "bulk", "lib": ("first", 0, 0),
                        "plan": "balanced", "ctas": ctas, "chunk": chunk})
    if ARGS.sweep in ("second", "all"):
        for h in (0, 1):
            for r, v, ctas in LEAN:
                for plan in ("walk", "split", "balanced"):
                    out.append({"kind": "lean", "lib": ("lean", h),
                                "reads": r, "vecs": v, "ctas": ctas,
                                "plan": plan})
    if ARGS.sweep in ("third", "all"):
        for h in HINT_NAMES:
            for r, v, ctas in THIRD:
                for plan in ("walk", "walk rot"):
                    c = {"kind": "lean", "lib": ("lean", h), "reads": r,
                         "vecs": v, "ctas": ctas, "plan": plan}
                    if c not in out:
                        out.append(c)
    return [c for c in out if c["lib"] in libs]


def name_of(c: dict) -> str:
    if c["kind"] == "bulk":
        return f"bulk ctas{c['ctas']} chunk{c['chunk'] // KiB}K"
    if c["kind"] == "lean":
        return (f"lean V{c['vecs']} C{c['ctas']} {c['plan']}"
                f"{HINT_NAMES[c['lib'][1]]}")
    _, ld, st = c["lib"]
    hint = "" if (ld, st) == (0, 0) else f" {LD_NAMES[ld]}/{ST_NAMES[st]}"
    return f"V{c['vecs']} {c['plan']} ctas{c['ctas']}{hint}"


def grid_of(plan: str, n_tiles: int, ctas: int, sms: int) -> tuple[int, int]:
    """(grid, split flag) of a work-split plan."""
    if plan in ("walk", "walk rot"):
        return min(n_tiles, ctas * sms), 0
    if plan == "split":
        return min(n_tiles, ctas * sms), 1
    if n_tiles <= sms:
        return n_tiles, 1
    return min(ctas * sms, sms * -(-n_tiles // sms)), 1


def variant_fn(c, libs, sms, x, ys, outs, passes):
    """The launch of config c on these operands (None where it cannot run),
    the key that identifies its launches, and its (grid, resident CTAs an
    SM)."""
    reads, writes = 1 + len(ys), len(outs)
    lib = libs[c["lib"]]
    dt = 0 if x.dtype == torch.float32 else 1
    br = mb.default_block_rows(x.shape[0])
    n_tiles = x.shape[0] // br
    tile_bytes = br * 128 * x.element_size()
    ins = (ctypes.c_void_p * reads)(*(t.data_ptr() for t in (x, *ys)))
    dst = (ctypes.c_void_p * writes)(*(o.data_ptr() for o in outs))
    if c["kind"] == "lean":
        if c["reads"] != reads:
            return None, None, None
        grid, split = grid_of(c["plan"], n_tiles, c["ctas"], sms)
        args = (dt, reads, c["vecs"], c["ctas"], ins, dst, writes, n_tiles,
                tile_bytes // 16, split, int(c["plan"] == "walk rot"),
                passes, grid)
        fn = lib.sv_lean_launch
    elif c["kind"] == "regs":
        if c["vecs"] == 8 and reads > 4:
            return None, None, None
        grid, split = grid_of(c["plan"], n_tiles, c["ctas"], sms)
        args = (dt, reads, c["vecs"], ins, dst, writes, n_tiles,
                tile_bytes // 16, split, passes, grid)
        fn = lib.sv_rw_launch
    else:
        chunk, ctas = c["chunk"], c["ctas"]
        budget = 227 * KiB // ctas - 1 * KiB
        stages = min(8, (budget - (2 * chunk if reads > 1 else 0))
                     // (reads * chunk))
        if stages < 3:
            return None, None, None
        grid, split = grid_of("balanced", n_tiles, ctas, sms)
        args = (dt, reads, ins, dst, writes, n_tiles, tile_bytes, split,
                passes, grid, chunk, stages)
        fn = lib.sv_bulk_launch
    ret = fn(*args, 1, None)
    if ret > 0:
        return None, None, None
    split = split and n_tiles % grid != 0
    key = (c["kind"], c["lib"], c.get("vecs"), c.get("chunk"), grid, split,
           c["ctas"] if c["kind"] != "regs" else None,
           c["plan"] == "walk rot")

    def launch():
        err = fn(*args, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name_of(c)}: launch error {err}")
    return launch, key, (grid, -ret)


def time_variants(current: dict) -> list[dict]:
    say(f"== variants (tools/stream_variants.cu, sweep {ARGS.sweep})")
    libs = build_variants()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfgs = configs(libs)
    rows = []
    for dname, nbytes, passes, n in shapes():
        for reads, writes in LADDER:
            x, ys, outs, want = operands(dname, nbytes, reads, writes)
            runs, same = [], {}
            for c in cfgs:
                fn, key, geo = variant_fn(c, libs, sms, x, ys, outs, passes)
                if fn is None:
                    continue
                if key in same:                 # the same launches: once
                    runs.append((c, None, geo, same[key]))
                    continue
                fn()
                torch.cuda.synchronize()
                check(outs, want, f"{name_of(c)} {reads}:{writes} {dname} "
                                  f"{nbytes}")
                same[key] = name_of(c)
                runs.append((c, fn, geo, None))
            best = {}
            for _ in range(2):                      # two rounds, in turns
                for c, fn, _, _ in runs:
                    if fn is not None:
                        t = device_ms(fn, n)[0]
                        best[name_of(c)] = min(best.get(name_of(c), math.inf),
                                               t)
            mix = f"rw_{reads}to{writes}"
            cur = current.get((mix, dname, nbytes))
            cur_copy = current.get(("copy", dname, nbytes))
            for c, _, (grid, resident), alias in runs:
                k = name_of(c)
                t = best[alias or k]
                best[k] = t
                rows.append({"config": k, "kind": c["kind"],
                             "lib": list(c["lib"]), "vecs": c.get("vecs"),
                             "ctas": c["ctas"], "plan": c["plan"],
                             "chunk": c.get("chunk"), "mix": mix,
                             "dtype": dname, "nbytes": nbytes,
                             "passes": passes, "grid": grid,
                             "resident_per_sm": resident, "device_ms": t,
                             "vs_current": t / cur if cur else None,
                             "vs_copy": (t / cur_copy if cur_copy and
                                         (reads, writes) == (1, 1) else None)})
            top = sorted({name_of(c) for c, *_ in runs}, key=best.get)[:3]
            say(f"  {mix} {dname:8s} {nbytes:>11d} B x{passes}  current "
                f"{cur if cur is None else f'{cur:.5f}'}  best: "
                + "; ".join(f"{k} {best[k]:.5f}" for k in top))
            del x, ys, outs, want, runs
            torch.cuda.empty_cache()
    rank(rows, "vs_current", "the current rw wrapper")
    rank([r for r in rows if r["vs_copy"] is not None], "vs_copy",
         "the current copy wrapper, rw_1to1 only")
    return rows


#: (V, THREADS) of the SV_TRIAD build (SV_TRIAD_LIST)
TRIAD_LIST = ((1, 256), (2, 256), (4, 256), (8, 256), (1, 512), (2, 512),
              (4, 512), (1, 1024), (2, 1024), (4, 1024))


def time_triad_variants(current: dict) -> list[dict]:
    """The triad variants at every shape, each checked bit for bit against
    the plain version, timed twice in turns with the others (the lesser
    time kept), beside the current triad wrapper's and torch.add's device
    times at the same shape."""
    say("== triad variants (tools/stream_variants.cu, SV_TRIAD)")
    libs = build_variants()
    if ("triad",) not in libs:
        return []
    fn_c = libs[("triad",)].sv_triad_launch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for dname, nbytes, passes, n in shapes():
        x, ys, outs, want = operands(dname, nbytes, 2, 1)
        dt = 0 if x.dtype == torch.float32 else 1
        br = mb.default_block_rows(x.shape[0])
        n_tiles = x.shape[0] // br
        tile_vecs = br * 128 * x.element_size() // 16
        runs = []
        for kind, kname in ((0, "np"), (1, "win")):
            for v, th in TRIAD_LIST:
                res = -fn_c(kind, dt, v, th, x.data_ptr(), ys[0].data_ptr(),
                            outs[0].data_ptr(), n_tiles, tile_vecs, 1,
                            passes, 0, 1, None)
                blocks = -(-n_tiles * tile_vecs // (th * v))
                grid = blocks if kind == 0 else min(blocks, res * sms)
                args = (kind, dt, v, th, x.data_ptr(), ys[0].data_ptr(),
                        outs[0].data_ptr(), n_tiles, tile_vecs, 1, passes,
                        grid, 0)

                def launch(args=args):
                    err = fn_c(*args, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"triad variant {args[:4]}: "
                                           f"launch error {err}")
                name = f"{kname} V{v} T{th}"
                if kind == 0 and passes > 65535:
                    continue
                launch()
                torch.cuda.synchronize()
                check(outs, want, f"{name} {dname} {nbytes}")
                runs.append((name, launch, grid, res))
        best: dict[str, float] = {}
        for _ in range(2):
            for name, launch, _, _ in runs:
                best[name] = min(best.get(name, math.inf),
                                 device_ms(launch, n)[0])
        cur = current.get(("triad", dname, nbytes))
        lib = current.get(("torch.add", dname, nbytes))
        for name, _, grid, res in runs:
            t = best[name]
            rows.append({"config": name, "dtype": dname, "nbytes": nbytes,
                         "passes": passes, "grid": grid,
                         "resident_per_sm": res, "device_ms": t,
                         "vs_current": t / cur if cur else None,
                         "vs_library": t / lib if lib else None})
        top = sorted(best, key=best.get)[:4]
        say(f"  triad {dname:8s} {nbytes:>11d} B x{passes}  current "
            f"{cur if cur is None else f'{cur:.5f}'}  torch.add "
            f"{lib if lib is None else f'{lib:.5f}'}  best: "
            + "; ".join(f"{k} {best[k]:.5f}" for k in top))
        del x, ys, outs, want, runs
        torch.cuda.empty_cache()
    rank(rows, "vs_current", "the current triad wrapper")
    return rows


#: (threads a CTA, positions a thread a block, CTAs an SM) of the SV_ACC
#: build (SV_ACC_LIST): blocks of 64 to 4096 vectors
ACC_LIST = ((64, 1, 16), (256, 1, 4), (256, 1, 8), (256, 2, 4), (256, 4, 4),
            (256, 4, 8), (256, 8, 2), (256, 16, 2), (1024, 1, 2))
ACC_MIX_CODE = {"load_sum": 0, "load_only": 1, "fma": 2, "copy": 3}


def time_acc_variants(current: dict) -> list[dict]:
    """The acc (or copy) variants at every shape, each checked against the
    plain version (copy bit for bit), timed twice in turns with the others
    (the lesser time kept), beside the current wrapper's device time at the
    same shape.  ``np`` runs the passes of a many-pass point side by side:
    it is not what the persistent shape measures there."""
    say(f"== {ARGS.sweep} variants (tools/stream_variants.cu, SV_ACC)")
    libs = build_variants()
    if ("acc",) not in libs:
        return []
    fn_c = libs[("acc",)].sv_acc_launch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = ("copy",) if ARGS.sweep == "copy" else ACC_KERNELS
    rows = []
    for dname, nbytes, passes, n in shapes():
        x = working_set(nbytes, dtype=getattr(torch, dname), device=DEV)
        out = torch.empty_like(x)
        dt = 0 if x.dtype == torch.float32 else 1
        br = mb.default_block_rows(x.shape[0])
        n_tiles = x.shape[0] // br
        tile_vecs = br * 128 * x.element_size() // 16
        for kernel in kernels:
            code = ACC_MIX_CODE[kernel]
            runs = []
            # (kind, threads, V, CTAs, grid cap in CTAs an SM): the
            # persistent 256 x 1 shape also on 1 and 2 CTAs an SM
            cases = [(kind, th, v, ctas, None) for kind in (0, 1)
                     for th, v, ctas in ACC_LIST]
            cases += [(0, 256, 1, 4, g) for g in (1, 2)]
            if kernel != "copy":
                # the persistent kernel without its acc_linear branch
                cases.append((2, 256, 1, 4, None))
            for kind, th, v, ctas, cap in cases:
                kname = ("win", "np", "walk")[kind]
                name = f"{kname} T{th} V{v} C{ctas}" + (
                    f" G{cap}" if cap else "")
                if ARGS.configs and name not in ARGS.configs.split(","):
                    continue
                res = -fn_c(kind, code, dt, th, v, ctas, x.data_ptr(),
                            None, None, n_tiles, tile_vecs, passes,
                            FMA_DEPTH, 0, 1, None)
                blocks = -(-n_tiles * tile_vecs // (th * v))
                grid = blocks if kind == 1 else min(
                    blocks, (cap or res) * sms)
                parts = grid * (passes if kind == 1 else 1)
                partials = torch.empty(parts + -(-parts // 1024),
                                       dtype=torch.float32, device=DEV)
                res_t = torch.empty((), dtype=torch.float32, device=DEV)
                dst = out if kernel == "copy" else res_t
                args = (kind, code, dt, th, v, ctas, x.data_ptr(),
                        partials.data_ptr(), dst.data_ptr(), n_tiles,
                        tile_vecs, passes, FMA_DEPTH, grid, 0)
                # checked at <= 8 passes (chip_smoke.py phase 5 says
                # why), timed at the shape's
                hp = min(passes, 8)
                held = args[:11] + (hp,) + args[12:]

                def launch(args=args):
                    err = fn_c(*args,
                               torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"acc variant {args[:6]}: "
                                           f"launch error {err}")
                launch(held)
                torch.cuda.synchronize()
                what = f"{kernel} {name} {dname} {nbytes}"
                if kernel == "copy":
                    if not torch.equal(out, x):
                        raise AssertionError(f"{what}: output differs "
                                             f"from x")
                    out.zero_()
                else:
                    check_acc(kernel, res_t, x, br, hp, what)
                runs.append((name, launch, grid, res,
                             (partials, res_t)))
            best: dict[str, float] = {}
            for _ in range(2):
                for name, launch, *_ in runs:
                    best[name] = min(best.get(name, math.inf),
                                     device_ms(launch, n)[0])
            cur = current.get((kernel, dname, nbytes))
            for name, _, grid, res, _ in runs:
                t = best[name]
                rows.append({"config": f"{kernel} {name}", "kernel": kernel,
                             "dtype": dname, "nbytes": nbytes,
                             "passes": passes, "grid": grid,
                             "resident_per_sm": res, "device_ms": t,
                             "vs_current": t / cur if cur else None})
            top = sorted(best, key=best.get)[:4]
            say(f"  {kernel:9s} {dname:8s} {nbytes:>11d} B x{passes}  "
                f"current {cur if cur is None else f'{cur:.5f}'}  best: "
                + "; ".join(f"{k} {best[k]:.5f}" for k in top))
            del runs
        del x, out
        torch.cuda.empty_cache()
    for kernel in kernels:
        rank([dict(r, config=r["config"].split(" ", 1)[1]) for r in rows
              if r["kernel"] == kernel], "vs_current",
             f"the current {kernel} wrapper")
    return rows


def rank(rows: list[dict], field: str, what: str) -> None:
    """Configs by the geometric mean of rows[field] over every point they
    ran at (those that ran at every point only), with the worst ratio."""
    by: dict[str, list[float]] = {}
    for r in rows:
        if r[field] is not None:
            by.setdefault(r["config"], []).append(r[field])
    if not by:
        return
    full = max(len(v) for v in by.values())
    ranked = sorted(((math.exp(sum(map(math.log, v)) / len(v)), max(v), k)
                     for k, v in by.items() if len(v) == full))
    say(f"== configs by geometric mean of (variant / {what}) over {full} "
        f"points, worst ratio (the first 25)")
    for g, worst, k in ranked[:25]:
        say(f"  {g:.4f}  worst {worst:.4f}  {k}")


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    t0 = time.perf_counter()
    result = {"label": ARGS.label, "src": ARGS.src,
              "device": torch.cuda.get_device_name(0)}
    wrappers = time_wrappers()
    result["wrappers"] = wrappers
    if ARGS.mode == "all":
        current = {(r["kernel"], r["dtype"], r["nbytes"]): r["device_ms"]
                   for r in wrappers}
        current.update({("torch.add", r["dtype"], r["nbytes"]):
                        r["library_device_ms"] for r in wrappers
                        if r["kernel"] == "triad"})
        result["variants"] = (
            time_triad_variants(current) if ARGS.sweep == "triad"
            else time_acc_variants(current) if ARGS.sweep in ("acc", "copy")
            else time_variants(current))
    say(f"== done in {time.perf_counter() - t0:.1f} s")
    (OUT / f"{ARGS.label}.json").write_text(json.dumps(result, indent=1))
    (OUT / f"{ARGS.label}.txt").write_text("\n".join(LINES) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
