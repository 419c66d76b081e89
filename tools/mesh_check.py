#!/usr/bin/env python3
"""Hold the multi-device bench (``sharded``, ``distributed``, ``launch``,
``core.scaling``, Fig. 4) to its single-device version across the devices
of one host.

    python3 tools/mesh_check.py                  # every visible GPU (>= 2)
    python3 tools/mesh_check.py --device cpu     # a rehearsal on logical CPU
                                                 # devices, gloo
    python3 tools/mesh_check.py --out-dir DIR    # default artifacts/mesh_check
    python3 tools/mesh_check.py --src OTHER/src --label parent \
        --steps enqueue,scaling,fig4             # another checkout's package

The mesh sizes are 1, 2 and every device of the pool (on the CPU the pool
is ``REPRO_TORCH_CPU_DEVICES`` logical devices).  Steps (``--steps``, all
by default), any failure raises and the script exits non-zero:

  enqueue  the host's time to enqueue one pass of the load_sum and copy
           oracles at the scaling size (a call without a sync, over its
           passes) beside the device's time for one pass (CUDA events): how
           far ahead of the devices the host runs;
  sharded  (1) every torch mix on ``sharded`` at each mesh size k (256 MiB;
           the chase at 16 MiB): the accounting of ``torch`` at the same
           size, each shard made on its own device, and the returned scalar
           equal to the torch oracle run block by block on the first device
           and summed in block order (the oracle's bound, below); (2) the
           loaded composite at devices = load + 1 for k = 2 and every
           device: the probe on shard 0, a generator on each sibling; its
           scalar equal to the siblings' load_sum sweeps, and on CUDA its
           latency_ns near ``chase.cu``'s walking shard 0's block as one
           tile;
  scaling  ``scaling_curve`` for load_sum and copy at 1 GiB a device, 8
           passes, 8 reps (the paper's Fig. 4: aggregate GB/s against device
           count);
  launch   ``launch`` for every split of the pool into P >= 2 processes of K
           devices (NCCL on CUDA, gloo on the CPU): one result gathered on
           process 0 with ``local_device_counts`` [K] * P, every point the
           slowest process's, the accounting of ``sharded`` at P * K, one
           trace pid a process; a mesh that leaves a process out fails; on
           CUDA a launch of more GPUs than are visible is refused before it
           spawns;
  fig4     ``python -m benchmarks_torch.fig4_scaling --quick`` (the sharded
           ladder 1, 2, 4, ...) and ``--quick --distributed --processes 2
           --devices-per-process N/2``: every row printed, the speedups read;
  collectives
           the collective study (``core.collective_bench``) on meshes 1 x N
           and 2 x N/2 of processes, one a device, at the reference's 8 MiB
           and 256 MiB: every op's first output within n ulps of
           ``plain_output``, then its time, algorithm and ring-model link
           GB/s; on CUDA the NCCL transport its channels take, from
           ``NCCL_DEBUG=INFO``;
  stragglers
           ``ft.stragglers.probe_devices`` over the pool at 4 MiB and 1 GiB:
           one ``acc.cu`` load_sum launch a device a rep on CUDA.

The kernels of the port that run are ``chase.cu``, the chase probe of a
CUDA shard, and ``acc.cu``'s load_sum, the straggler probe (checked: no
other launch).  On the CPU the sizes shrink to 1 MiB
(256 KiB for the chase) and no number is a device's.  Prints each card's
name and power limit and, last, one JSON line of the figures.  Imports
nothing of JAX.
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
#: how far the mesh probe's latency_ns may lie from chase.cu's walking the
#: same one-tile block alone (chip_smoke.py's MESH_PROBE_TOL)
PROBE_TOL = 0.10


def say(path: Path, msg: str = "") -> None:
    print(msg, flush=True)
    with open(path, "a") as f:
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


def chase_ns(perm, passes: int) -> float:
    """ns a dependent step of ``chase.cu`` walking ``perm`` as one tile,
    ``passes`` passes a call, three calls after one (CUDA events)."""
    import torch

    from repro_torch.kernels.membench import membench as mb
    rows = perm.shape[0]
    mb.chase(perm, block_rows=rows, passes=passes)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    t0.record()
    for _ in range(3):
        mb.chase(perm, block_rows=rows, passes=passes)
    t1.record()
    torch.cuda.synchronize(perm.device)
    return t0.elapsed_time(t1) * 1e6 / (3 * passes * perm.numel())


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
        probe = ""
        if dev.type == "cuda":
            # the probe is chase.cu over shard 0's block as one tile: hold
            # its latency to that kernel's walking the same cycle alone
            ns = chase_ns(torch.tensor(im.chase_perm((r, x.shape[1])),
                                       device=dev), p.passes)
            gbps[f"composite_{k}"]["chase_cu_ns"] = ns
            if not abs(p.latency_ns - ns) <= PROBE_TOL * ns:
                raise AssertionError(f"composite devices={k}: probe "
                                     f"{p.latency_ns} ns against chase.cu's "
                                     f"{ns} ns")
            probe = f" (chase.cu alone on shard 0's block: {ns:.2f} ns)"
        log(f"  composite devices={k} load={k - 1}: scalar = the siblings' "
            f"sweeps; {p.latency_ns:.2f} ns a step{probe}, generators "
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


def check_enqueue(dev, per_device, log) -> dict:
    """How long the host takes to enqueue one pass of the load_sum and copy
    oracles (the call returns before the device has run its passes) beside
    one pass's device time (CUDA events; on the CPU the two are one)."""
    import torch

    from repro_torch.core import instruction_mix as im
    from repro_torch.core.buffers import working_set
    x = working_set(per_device, device=dev)
    cuda = dev.type == "cuda"
    out, passes = {}, 8
    for name, oracle in (("load_sum", im.k_load_sum), ("copy", im.k_copy)):
        oracle(x, 2)
        if cuda:
            torch.cuda.synchronize(dev)
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
        h0 = time.perf_counter()
        oracle(x, passes)
        host = time.perf_counter() - h0
        if cuda:
            t1.record()
            torch.cuda.synchronize(dev)
            device = t0.elapsed_time(t1) / 1e3
        else:
            device = host
        out[name] = {"enqueue_us_a_pass": host / passes * 1e6,
                     "device_us_a_pass": device / passes * 1e6}
        log(f"  {name} oracle, {per_device} B on {dev}: the host enqueues a "
            f"pass in {host / passes * 1e6:.1f} us, the device runs it in "
            f"{device / passes * 1e6:.1f} us")
    return out


def check_fig4(dev, n, src, log) -> dict:
    """``benchmarks_torch.fig4_scaling --quick`` on the sharded ladder, then
    ``--distributed`` over 2 processes of n/2 devices: every row, each
    device count's GB/s and speedup."""
    import os
    import re
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(src), str(ROOT)]))
    if dev.type == "cpu":
        env["REPRO_TORCH_CPU_DEVICES"] = str(n)
    row = re.compile(r"^(?:\[p\d+\] )?(fig4\w*/\w+),([0-9.]+),([0-9.]+)GB/s"
                     r"(?:;speedup=([0-9.]+)x)?")
    out = {}
    for label, extra in (("sharded", []),
                         ("distributed", ["--distributed", "--processes", "2",
                                          "--devices-per-process",
                                          str(n // 2)])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "benchmarks_torch.fig4_scaling", "--quick",
                            "--device", dev.type, *extra], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        rows = [m.groups() for m in map(row.match, r.stdout.splitlines())
                if m]
        if r.returncode != 0 or not rows:
            raise AssertionError(f"fig4 {label} exited {r.returncode}:\n"
                                 f"{r.stdout}\n{r.stderr[-4000:]}")
        out[label] = {name: {"us": float(us), "gbps": float(gbps),
                             "speedup": None if sp is None else float(sp)}
                      for name, us, gbps, sp in rows}
        log(f"  fig4 --quick {' '.join(extra) or '(sharded)'}, "
            f"{time.perf_counter() - t0:.1f} s: "
            + "; ".join(f"{name} {v['gbps']:.1f} GB/s"
                        + (f" x{v['speedup']:.2f}" if v["speedup"] else "")
                        for name, v in out[label].items()))
    return out


def collective_worker(shape, sizes, device: str) -> int:
    """One rank of the ``collectives`` step: at each global size, every op
    on every axis of two or more ranks, its first output held to
    ``plain_output`` (n ulps), then ``bench_collective``'s time; rank 0
    prints one JSON line."""
    import numpy as np
    import torch

    from repro_torch.bench import distributed as dist
    from repro_torch.core import collective_bench as cb
    from repro_torch.launch.mesh import make_mesh
    dist.ensure_initialized(device)
    mesh = make_mesh(shape, ("data", "model"), device=device)
    rows = []
    for nbytes in sizes:
        for axis in mesh.axis_names:
            n = mesh.shape[axis]
            if n < 2:
                continue
            host = cb.global_input(n, nbytes, device="cpu")
            for op in cb.OPS:
                fn, arg, _ = cb.collective_case(mesh, axis, op, nbytes)
                got = fn(arg).to("cpu", torch.float64)
                want = cb.plain_output(op, host, mesh.coords[axis]).double()
                ulps = float(((got - want).abs() / torch.from_numpy(
                    np.spacing(want.abs().float().numpy())).double()).max())
                r = cb.bench_collective(mesh, axis, op, nbytes)
                rows.append({**r.__dict__, "global_bytes": nbytes,
                             "max_ulps": ulps})
    worst = max(dist._all_gather(max((r["max_ulps"] for r in rows),
                                     default=0.0)))
    if dist.is_primary():
        print("COLLECTIVES " + json.dumps({"rows": rows, "max_ulps": worst}),
              flush=True)
    return 0


def check_collectives(dev, n, src, log) -> dict:
    """The collective study on meshes 1 x n and 2 x n/2 at the reference's
    8 MiB and, on CUDA, at 256 MiB (where the links, not the calls'
    latency, should bound it), 1 MiB on the CPU: one launch a mesh (one
    process a device; NCCL on CUDA, with ``NCCL_DEBUG=INFO`` to name the
    transport its channels take), every op's values within n ulps of the
    host's, times, algorithm and ring-model link GB/s."""
    import os
    import re

    from repro_torch.bench.distributed import launch_local
    sizes = (8 * MiB, 256 * MiB) if dev.type == "cuda" else (1 * MiB,)
    env = dict(os.environ, PYTHONPATH=str(src))
    if dev.type == "cuda":
        env.update(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT,P2P,SHM,NET")
    via = re.compile(r"via (\S+)")
    out = {}
    for shape in ((1, n), (2, n // 2)):
        code = (f"import sys; sys.path[:0] = [{str(src)!r}, "
                f"{str(ROOT / 'tools')!r}]; import mesh_check; "
                f"sys.exit(mesh_check.collective_worker({shape!r}, "
                f"{sizes!r}, {dev.type!r}))")
        lines: list[str] = []

        class Sink:
            def write(self, s):
                lines.append(s)

            def flush(self):
                pass
        t0 = time.perf_counter()
        rc = launch_local([sys.executable, "-c", code], processes=n,
                          env=env, timeout=600, stream_to=Sink(),
                          device=dev.type)
        text = "".join(lines)
        doc = next((json.loads(line.split("COLLECTIVES ", 1)[1])
                    for line in text.splitlines() if "COLLECTIVES " in line),
                   None)
        if rc != 0 or doc is None:
            raise AssertionError(f"collectives {shape} exited {rc}:\n"
                                 f"{text[-6000:]}")
        transports: dict[str, int] = {}
        for m in via.finditer(text):
            transports[m.group(1)] = transports.get(m.group(1), 0) + 1
        if doc["max_ulps"] > n:
            raise AssertionError(f"collectives {shape}: a value "
                                 f"{doc['max_ulps']} ulps off the host's "
                                 f"(limit {n})")
        key = f"{shape[0]}x{shape[1]}"
        out[key] = {"rows": doc["rows"], "max_ulps": doc["max_ulps"],
                    "transports": transports,
                    "wall_s": time.perf_counter() - t0}
        log(f"  mesh {key}: values within {doc['max_ulps']:.1f} ulps of the "
            f"host's; transports {transports or '(none logged)'}; "
            f"{out[key]['wall_s']:.1f} s")
        for r in doc["rows"]:
            log(f"    {r['global_bytes'] // MiB:4d} MiB {r['op']:14s} "
                f"{r['axis']}{r['group_size']}  {r['mean_s'] * 1e6:9.1f} us "
                f"(σ {r['std_s'] * 1e6:.1f})  algo {r['algo_gbps']:8.2f} "
                f"GB/s  link {r['link_gbps']:8.2f} GB/s")
    return out


def check_stragglers(dev, log) -> dict:
    """``probe_devices`` over the pool: at the reference's defaults (4 MiB,
    4 passes, 5 reps) and at 1 GiB (past the L2 on the card), one
    ``acc.cu`` load_sum launch a device a rep (plus one to warm) on CUDA."""
    from repro_torch.ft.stragglers import probe_devices
    from repro_torch.kernels.membench import membench as mb
    out = {}
    for nbytes in ((4 * MiB, 1024 * MiB) if dev.type == "cuda"
                   else (4 * MiB,)):
        before = mb.launch_counts["load_sum"]
        probes = probe_devices(nbytes=nbytes, device=dev)
        launched = mb.launch_counts["load_sum"] - before
        want = len(probes) * 6 if dev.type == "cuda" else 0
        if launched != want:
            raise AssertionError(f"probe_devices launched acc.cu load_sum "
                                 f"{launched} times, expected {want}")
        out[f"{nbytes // MiB}M"] = [
            {"device": p.device, "gbps": float(p.gbps),
             "z_score": float(p.z_score),
             "is_straggler": bool(p.is_straggler)} for p in probes]
        log(f"  probe_devices {nbytes // MiB} MiB: "
            + "; ".join(f"{p.device} {p.gbps:.1f} GB/s z={p.z_score:+.2f}"
                        + (" STRAGGLER" if p.is_straggler else "")
                        for p in probes) + f"; acc.cu launches {launched}")
    return out


STEPS = ("enqueue", "sharded", "scaling", "launch", "fig4", "collectives",
         "stragglers")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible GPU) or cpu (a rehearsal)")
    ap.add_argument("--out-dir",
                    default=str(ROOT / "artifacts" / "mesh_check"))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch runs (another "
                         "checkout's, for an A/B in one call)")
    ap.add_argument("--label", default="",
                    help="suffix of the log and JSON names (mesh_check_"
                         "LABEL.json)")
    ap.add_argument("--steps", default=",".join(STEPS),
                    help="comma list of " + ", ".join(STEPS))
    args = ap.parse_args(argv)
    steps = args.steps.split(",")
    if set(steps) - set(STEPS):
        ap.error(f"unknown steps {sorted(set(steps) - set(STEPS))}")
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.core.device import device_pool, resolve_device
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.membench import membench as mb
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    dev = resolve_device(args.device)       # raises without a CUDA device
    out_dir = Path(args.out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"_{args.label}" if args.label else ""
    log_name = f"log{suffix}.txt"
    (out_dir / log_name).unlink(missing_ok=True)

    def log(msg=""):
        say(out_dir / log_name, msg)

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
    import repro_torch
    log(f"repro_torch from {Path(repro_torch.__file__).parent}")
    ks = sorted({1, 2, n})
    sizes = SIZES[dev.type]
    for mod in (mb, fa, sk):
        mod.reset_launch_counts()
    summary = {"device": dev.type, "count": n, "smi": smi,
               "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                        else "cpu"), "src": str(src), "label": args.label}
    if "enqueue" in steps:
        log("== enqueue: one pass of the oracles, host against device")
        summary["enqueue"] = check_enqueue(dev, sizes[2], log)
    if "sharded" in steps:
        log(f"== sharded: meshes of {ks} and the loaded composite")
        summary["sharded"] = check_sharded(dev, ks, sizes, log)
    if "scaling" in steps:
        log("== scaling: scaling_curve (Fig. 4)")
        summary["scaling"] = check_scaling(dev, ks, sizes[2], log)
    if "launch" in steps:
        log("== launch")
        summary["launch"] = check_launch(dev, n, sizes[0], out_dir, log)
    if "fig4" in steps:
        log("== fig4: benchmarks_torch.fig4_scaling --quick")
        summary["fig4"] = check_fig4(dev, n, src, log)
    if "collectives" in steps:
        log("== collectives: the five ops on meshes 1 x n and 2 x n/2")
        summary["collectives"] = check_collectives(dev, n, src, log)
    if "stragglers" in steps:
        log("== stragglers: probe_devices over the pool")
        summary["stragglers"] = check_stragglers(dev, log)
    launched = {k: v for mod in (mb, fa, sk)
                for k, v in mod.launch_counts.items() if v}
    allowed = {"chase"} | ({"load_sum"} if "stragglers" in steps else set())
    if set(launched) - allowed or (dev.type == "cpu" and launched):
        raise AssertionError(f"kernels launched: {launched}")
    log(f"== all checks passed in {time.perf_counter() - t0:.1f} s; "
        f"launches {launched} (the chase probe of a CUDA shard, the "
        f"straggler probe's load_sum)")
    summary = {"mesh_check": summary}
    (out_dir / f"mesh_check{suffix}.json").write_text(
        json.dumps(summary, indent=1))
    log(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
