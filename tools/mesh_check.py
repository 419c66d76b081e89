#!/usr/bin/env python3
"""Hold the multi-device bench (``sharded``, ``distributed``, ``launch``,
``core.scaling``) to its single-device version across the devices of one
host.

    python3 tools/mesh_check.py                  # every visible GPU (>= 2)
    python3 tools/mesh_check.py --device cpu     # a rehearsal on logical CPU
                                                 # devices, gloo
    python3 tools/mesh_check.py --out-dir DIR    # default artifacts/mesh_check

The mesh sizes are 1, 2 and every device of the pool (on the CPU the pool
is ``REPRO_TORCH_CPU_DEVICES`` logical devices).  Checks, any failure
raises and the script exits non-zero:

  1  every torch mix on ``sharded`` at each mesh size k (256 MiB; the chase,
     whose oracle walks on the host, at 16 MiB): the accounting of
     ``torch`` at the same size, each shard made on its own device, and the
     returned scalar equal to the torch oracle run block by block on the
     first device and summed in block order (the oracle's bound, below);
  2  the loaded composite at devices = load + 1 for k = 2 and every device:
     the probe on shard 0, a generator on each sibling; its scalar equal to
     the siblings' load_sum sweeps, run on the first device;
  3  ``scaling_curve`` for load_sum and copy at 1 GiB a device, 8 passes,
     8 reps (the paper's Fig. 4: aggregate GB/s against device count);
  4  ``launch`` for every split of the pool into P >= 2 processes of K
     devices (NCCL on CUDA, gloo on the CPU): one result gathered on
     process 0 with ``local_device_counts`` [K] * P, every point the
     slowest process's, the accounting of ``sharded`` at P * K, one trace
     pid a process; a mesh that leaves a process out fails; on CUDA a
     launch of more GPUs than are visible is refused before it spawns.

No kernel of the port runs (the mesh runs the oracles; checked).  On the
CPU the sizes shrink to 1 MiB (256 KiB for the chase) and no number is a
device's.  Prints each card's name and power limit and, last, one JSON line
of the figures.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MiB = 2 ** 20
#: (mesh check, chase, scaling a device) sizes, by device kind
SIZES = {"cuda": (256 * MiB, 16 * MiB, 1024 * MiB),
         "cpu": (1 * MiB, 256 * 2**10, 1 * MiB)}
PASSES = 2


def say(out_dir: Path, msg: str = "") -> None:
    print(msg, flush=True)
    with open(out_dir / "log.txt", "a") as f:
        f.write(msg + "\n")


def oracle_tol(mix: str, n: int, value: float) -> float:
    """The torch oracle's own bound for one block of n elements (the
    tolerances of ``tests/test_torch_oracles.py`` and ``test_torch_rw.py``):
    sums n x 1.3e-7 x passes x depth (floor 1e-4), element checksums
    1e-6 |v| + 1e-6, rw 1e-6 |v| + (R-1) ulp(4) (passes + W), the chase
    exactly."""
    import numpy as np

    from repro_torch.bench.mixes import get_mix
    if mix == "latency_chase":
        return 0.0
    if mix in ("copy", "triad", "mxu"):
        return 1e-6 * abs(value) + 1e-6
    if mix.startswith("rw_"):
        reads, writes = get_mix(mix).rw
        ulp = float(np.spacing(np.float32(4.0)))
        return 1e-6 * abs(value) + (reads - 1) * ulp * (PASSES + writes)
    depth = int(mix.split("_")[1]) if mix.startswith("fma_") else 1
    return max(n * 1.3e-7 * PASSES * depth, 1e-4)


def cli_run(argv: list[str]) -> tuple[int, str, str]:
    """The bench CLI in this process: (exit code, stdout, stderr); a
    launch's workers stream into the stderr captured here."""
    from repro_torch.bench import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    cli.trace.configure(enabled=False)
    return rc, out.getvalue(), err.getvalue()


def check_sharded(dev, ks, sizes, log) -> dict:
    """Checks 1 and 2: accounting, placement and scalars on each mesh."""
    import torch

    from repro_torch.bench import BenchSpec, Runner, mix_names
    from repro_torch.bench.backends import get_backend
    from repro_torch.bench.mixes import GEN_SWEEPS_PER_PASS, get_mix
    from repro_torch.core import instruction_mix as im
    from repro_torch.core.buffers import working_set
    from repro_torch.core.device import device_pool
    from repro_torch.obs import trace
    main, chase, _ = sizes
    mixes = mix_names("torch")
    bandwidth = [m for m in mixes if m != "latency_chase"]
    runner = Runner(device=dev)
    pool = [str(d) for d in device_pool(dev)]
    every = BenchSpec(mixes=tuple(bandwidth), sizes=(main,), reps=3,
                      warmup=1)
    base = runner.run(every).points
    gbps, worst = {"torch": {p.mix: p.gbps for p in base}}, 0.0
    for k in ks:
        tr = trace.configure(enabled=True, clear=True)
        pts = runner.run(every.replace(backend="sharded", devices=k)).points
        places = {tuple(e["args"]["devices"]) for e in tr.events()
                  if e["name"] == "mesh.place"}
        trace.configure(enabled=False, clear=True)
        if places != {tuple(pool[:k])}:
            raise AssertionError(f"devices={k}: shards placed on {places}")
        for p, q in zip(pts, base):
            if (p.mix, p.bytes_per_call, p.flops_per_call, p.passes) != \
                    (q.mix, q.bytes_per_call, q.flops_per_call, q.passes) \
                    or p.devices != k or not p.gbps > 0:
                raise AssertionError(f"sharded {p} against torch {q}")
        gbps[f"sharded_{k}"] = {p.mix: p.gbps for p in pts}
        log(f"  sharded devices={k} on {', '.join(pool[:k])} (traced): "
            f"accounting = torch's for {len(bandwidth)} mixes at {main} B; "
            f"GB/s " + ", ".join(f"{p.mix} {p.gbps:.1f}" for p in pts))
        for size, names in ((main, bandwidth), (chase, ["latency_chase"])):
            x = working_set(size, device=dev)
            rows = x.shape[0]
            for name in names:
                mix = get_mix(name)
                one = BenchSpec(mixes=(name,), sizes=(size,), passes=PASSES)
                got = float(get_backend("sharded").build(
                    one.replace(backend="sharded", devices=k), mix, x,
                    PASSES)())
                r = rows // k
                want = torch.zeros((), dtype=torch.float32, device=x.device)
                for i in range(k):
                    want = want + get_backend("torch").build(
                        one, mix, x[i * r:(i + 1) * r], PASSES)()
                want = float(want)
                tol = k * oracle_tol(name, x.numel() // k, want)
                worst = max(worst, abs(got - want))
                if not abs(got - want) <= tol:
                    raise AssertionError(f"sharded {name} devices={k}: "
                                         f"{got} against {want} (tol {tol})")
            del x
        log(f"  sharded devices={k}: every scalar = the torch oracle block "
            f"by block (largest difference so far {worst:.3e})")
        if k < 2:
            continue
        # the loaded composite: the probe on shard 0, generators on siblings
        x = working_set(chase, device=dev)
        r = x.shape[0] // k
        spec = BenchSpec(mixes=("latency_chase",), sizes=(chase,),
                         backend="sharded", devices=k, load=k - 1,
                         passes=PASSES)
        gen = [x[i * r:(i + 1) * r].clone() for i in range(1, k)]
        got = float(get_backend("sharded").build(
            spec, get_mix("latency_chase"), x, PASSES)())
        want = sum(float(im.k_load_sum(g, PASSES * GEN_SWEEPS_PER_PASS))
                   for g in gen)
        tol = (k - 1) * oracle_tol("load_sum", r * x.shape[1] *
                                   GEN_SWEEPS_PER_PASS, want)
        if not abs(got - want) <= tol:
            raise AssertionError(f"composite devices={k}: {got} against "
                                 f"{want} (tol {tol})")
        (p,) = runner.run(spec.replace(passes=None, reps=3, warmup=1)).points
        if not (p.latency_ns > 0 and p.gen_gbps > 0):
            raise AssertionError(f"composite point {p}")
        gbps[f"composite_{k}"] = {"latency_ns": p.latency_ns,
                                  "gen_gbps": p.gen_gbps}
        log(f"  composite devices={k} load={k - 1}: scalar = the siblings' "
            f"sweeps; {p.latency_ns:.2f} ns a step, generators "
            f"{p.gen_gbps:.2f} GB/s")
        del x, gen
    gbps["largest_scalar_difference"] = worst
    return gbps


def check_scaling(dev, ks, per_device, log) -> dict:
    """Check 3: the Fig-4 curve."""
    from repro_torch.bench import Runner
    from repro_torch.core.scaling import scaling_curve
    out = {}
    for mix in ("load_sum", "copy"):
        pts = scaling_curve(per_device, mix=mix, device_counts=ks, passes=8,
                            reps=8, runner=Runner(device=dev))
        if [p.devices for p in pts] != list(ks) or pts[0].speedup != 1.0 \
                or not all(p.gbps > 0 for p in pts):
            raise AssertionError(f"scaling_curve {mix}: {pts}")
        out[mix] = [[p.devices, p.gbps, p.speedup, p.mean_s] for p in pts]
        log(f"  scaling_curve {mix}, {per_device} B a device: "
            + "; ".join(f"{p.devices}: {p.gbps:.1f} GB/s (x{p.speedup:.2f})"
                        for p in pts))
    return out


def check_launch(dev, n, main, out_dir, log) -> dict:
    """Check 4: the launcher on every split of the pool."""
    from repro_torch.bench import BenchSpec, Runner
    cpu = ["--device", "cpu"] if dev.type == "cpu" else []
    size = f"{main // MiB}M"
    sharded = Runner(device=dev).run(BenchSpec(
        mixes=("load_sum", "copy"), sizes=(main,), backend="sharded",
        devices=n, reps=3))
    want = [[p.mix, p.nbytes, p.passes, p.bytes_per_call, p.flops_per_call]
            for p in sharded.points]
    out = {}
    for procs in (p for p in range(2, n + 1) if n % p == 0):
        per = n // procs
        res, tr = out_dir / f"launch_{procs}x{per}.json", \
            out_dir / f"launch_{procs}x{per}_trace.json"
        res.unlink(missing_ok=True)
        t0 = time.perf_counter()
        rc, text, err = cli_run(
            ["launch", "--processes", str(procs), "--devices-per-process",
             str(per), "--mixes", "load_sum,copy", "--sizes", size,
             "--reps", "3", "--timeout", "300", "--out", str(res),
             "--trace", str(tr), "--no-ledger", *cpu])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"launch {procs}x{per} exited {rc}:\n"
                                 f"{text}\n{err[-4000:]}")
        doc = json.loads(res.read_text())
        m, rows = doc["machine"], doc["meta"]["per_process_mean_s"]
        if (m["process_count"], m["local_device_counts"], m["device_count"]) \
                != (procs, [per] * procs, n) or len(rows) != procs:
            raise AssertionError(f"launch {procs}x{per}: {m}")
        got = [[p["mix"], p["nbytes"], p["passes"], p["bytes_per_call"],
                p["flops_per_call"]] for p in doc["points"]]
        if got != want or any(p["devices"] != n for p in doc["points"]):
            raise AssertionError(f"launch {procs}x{per}: {got} != {want}")
        for i, p in enumerate(doc["points"]):
            if p["mean_s"] != max(r[i] for r in rows) or not math.isclose(
                    p["gbps"], p["bytes_per_call"] / p["mean_s"] / 1e9):
                raise AssertionError(f"straggler merge: {p} {rows}")
        pids = {e["pid"] for e in json.loads(tr.read_text())["traceEvents"]}
        if pids != set(range(procs)):
            raise AssertionError(f"trace pids {pids}")
        out[f"{procs}x{per}"] = {"wall_s": wall, **{
            p["mix"]: p["gbps"] for p in doc["points"]}}
        log(f"  launch {procs} x {per}: gathered on process 0, accounting = "
            f"sharded at {n}, trace pids {sorted(pids)}, "
            + ", ".join(f"{p['mix']} {p['gbps']:.1f} GB/s"
                        for p in doc["points"]) + f", {wall:.1f} s")
    # a mesh that leaves a process out fails in every worker
    rc, _, err = cli_run(["launch", "--processes", "2",
                          "--devices-per-process", str(n // 2), "--devices",
                          "1", "--mixes", "load_sum", "--sizes", size,
                          "--timeout", "300", "--no-ledger", *cpu])
    if rc == 0 or "no mesh shard" not in err:
        raise AssertionError(f"a mesh leaving a process out: {rc}\n{err}")
    log("  launch with devices=1 over 2 processes: refused in the workers")
    if dev.type == "cuda":
        rc, _, err = cli_run(["launch", "--processes", str(n + 1),
                              "--mixes", "load_sum", "--sizes", size,
                              "--no-ledger"])
        if rc == 0 or f"{n} visible" not in err or "[p0]" in err:
            raise AssertionError(f"launch of {n + 1} GPUs: {rc}\n{err}")
        log(f"  launch of {n + 1} processes on {n} GPUs: refused, nothing "
            f"spawned")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible GPU) or cpu (a rehearsal)")
    ap.add_argument("--out-dir",
                    default=str(ROOT / "artifacts" / "mesh_check"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core.device import device_pool, resolve_device
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.membench import membench as mb
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    dev = resolve_device(args.device)       # raises without a CUDA device
    out_dir = Path(args.out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "log.txt").unlink(missing_ok=True)

    def log(msg=""):
        say(out_dir, msg)

    n = len(device_pool(dev))
    if n < 2:
        raise SystemExit(f"mesh_check: {n} device(s) in the {dev.type} pool;"
                         f" needs 2 or more")
    t0 = time.perf_counter()
    smi = ""
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        log(smi)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {n} GPUs")
    ks = sorted({1, 2, n})
    sizes = SIZES[dev.type]
    for mod in (mb, fa, sk):
        mod.reset_launch_counts()
    log(f"== 1, 2: sharded meshes of {ks} and the loaded composite")
    mesh = check_sharded(dev, ks, sizes, log)
    log("== 3: scaling_curve (Fig. 4)")
    scaling = check_scaling(dev, ks, sizes[2], log)
    log("== 4: launch")
    launches = check_launch(dev, n, sizes[0], out_dir, log)
    launched = {k: v for mod in (mb, fa, sk)
                for k, v in mod.launch_counts.items() if v}
    if launched:
        raise AssertionError(f"kernels launched: {launched}")
    log(f"== all checks passed in {time.perf_counter() - t0:.1f} s; no "
        f"kernel launched")
    summary = {"mesh_check": {
        "device": dev.type, "count": n, "smi": smi,
        "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                 else "cpu"),
        "sharded": mesh, "scaling": scaling, "launch": launches}}
    (out_dir / "mesh_check.json").write_text(json.dumps(summary, indent=1))
    log(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
