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
           one ``acc.cu`` load_sum launch a device a rep on CUDA;
  flash_decode
           serving on a mesh, the sequence-sharded decode: zamba2-2.7b at
           full width, batch 1, on meshes (1, N, 1) and (1, 2, N/2) of
           processes: at 65,536 tokens (the whole cache from host numpy
           seeds, cut to each rank's block) one step at ``pos`` in the
           first shard, on both sides of a shard boundary and last, held
           against the plain decode (``hold_decode_at``); then long_500k,
           524,288 tokens, each rank's block drawn on its device (12.08 GB
           of KV a GPU at N = 4): ms a token, peak memory, finite logits,
           rows written by their owners only; the refusals (a world of
           another size, a CUDA tensor at a gloo group);
  moe_ep   the expert-parallel MoE on (1, 1, N) and (1, 2, N/2):
           deepseek-v2-236b at full width on 2 layers against the one-GPU
           path (each data shard alone), every moe layer and the logits;
           on (1, 1, N) also arctic-480b at full width on 2 layers (which
           one GPU cannot hold: peak memory, prefill and decode ms, flash
           launches, top-K against the router alone) and reduced against
           one GPU.  Each mesh is one ``launch_local`` (one process a
           device; NCCL on CUDA, gloo on the CPU);
  train    training on a mesh: granite-3-2b at full width through the
           Trainer, batch 4 x 512, 8 AdamW steps with remat full, on
           (1, 1, 1) (the yardstick), (1, N, 1), (1, 2, N/2) and (1, 1,
           N) (pure tensor parallelism): losses finite and falling, step
           0 within 2e-3 of one device's and every later step within
           2e-2, step wall ms, device-busy ms of a further step and its
           NCCL share (compute a rank: busy less NCCL), its matmul FLOPs a
           rank (``FlopCounterMode``) beside one GPU's, within 1.15 x of
           one GPU's over the ranks (the batch splits over data, the
           layers over model), tokens/s, peak memory, the bytes of
           parameters and moments a rank against the rules', no
           hand-written kernel launched; on (1, 2, N/2) also
           deepseek-v2-236b at full width on 2 layers (blocks drawn rank
           by rank), two steps through the expert-parallel MoE.

The kernels of the port that run in this process are ``chase.cu``, the
chase probe of a CUDA shard, and ``acc.cu``'s load_sum, the straggler
probe (checked: no other launch); the serving steps' ranks launch
``flash_attn.cu`` in their prefills and count it.  On the CPU the sizes
shrink to 1 MiB (256 KiB for the chase), the serving configs to
``reduced``, and no number is a device's.  Prints each card's
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


# ---------------------------------------------------------------------------
# serving on a mesh: the sequence-sharded decode and the expert-parallel MoE
# ---------------------------------------------------------------------------

#: zamba2-2.7b's decode: (S of the values check, S of long_500k), by device
FLASH_DECODE_S = {"cuda": (65536, 524288), "cpu": (256, 1024)}
#: greedy tokens of the long_500k run
LONG_TOKENS = 8
#: the reference's bound on a sequence-sharded attention output
#: (``tests/test_flash_decode.py``); a layer's MoE output (relative RMS);
#: the logits (relative RMS), as ``chip_smoke.py`` phase 3d holds them
ATTN_TOL, LAYER_TOL, LOGITS_RMS_TOL = 2e-2, 2e-2, 0.15
#: the moe serving shape: batch x prompt, greedy tokens
MOE_SHAPE = {"cuda": (4, 512, 8), "cpu": (4, 32, 3)}
MESH_AXES = ("pod", "data", "model")


def rms_rel(a, b) -> float:
    """Relative RMS of ``a`` against ``b``."""
    a, b = a.float(), b.float()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt())


def row_sums(t):
    """(sites, B, S, ...) -> per (site, position) float32 sums, a site at a
    time (a float copy of one site, not of the cache): a row that a decode
    step rewrote almost surely changes its sum; one that it did not keeps
    it bit for bit."""
    import torch
    return torch.stack([s.float().flatten(2).sum(dim=(0, 2)) for s in t])


def hold_decode_at(ctx, cfg, params, whole, ssm, tok, pos,
                   held_params=None) -> dict:
    """One decode step at ``pos``, both ways, from the same state: the
    plain step on a copy of the whole cache with the whole ``params``, and
    the sequence-sharded step (``make_decode_step(seq_shard_decode=True)``)
    on this rank's blocks of it with the parameters as the rank holds them
    (``held_params``, default ``params``) and the SSM caches cut to the
    rank's SSD heads (``flash_decode.shard_ssm``), with each site's
    sharded attention held against the plain ``gqa_decode`` of the whole
    weights on the same input (which writes the whole cache's row
    ``pos``).  Returns the largest
    attention difference, the logits' relative RMS, whether every block
    equals its part of the whole cache bit for bit afterwards (so only
    the owner of ``pos`` wrote, and wrote the plain decode's row), and the
    rows each block changed."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models.variant import BASELINE
    from repro_torch.serve import flash_decode as fd
    from repro_torch.train.step import make_decode_step
    spec = (None,) + fd.cache_spec(ctx, cfg)
    batch = {"tokens": tok}
    plain = {"ssm": {k: v.clone() for k, v in ssm.items()},
             "k": whole["k"].clone(), "v": whole["v"].clone()}
    lg_plain, _ = make_decode_step(cfg, None, BASELINE)(params, plain, batch,
                                                         pos)
    del plain
    blocks = {"ssm": fd.shard_ssm(ctx, cfg, ssm),
              "k": ctx.shard(whole["k"], spec).clone(),
              "v": ctx.shard(whole["v"], spec).clone()}
    before = row_sums(blocks["k"]) + row_sums(blocks["v"])
    errs, sites = [], iter(range(whole["k"].shape[0]))
    orig = fd.seq_sharded_gqa_decode

    def held(ctx_, cfg_, p, x, kb, vb, pos_):
        s = next(sites)
        o_plain, _, _ = attn.gqa_decode(cfg_, params["shared"]["attn"], x,
                                        whole["k"][s], whole["v"][s], pos_)
        out = orig(ctx_, cfg_, p, x, kb, vb, pos_)
        errs.append(float((out[0].float() - o_plain.float()).abs().max()))
        return out
    fd.seq_sharded_gqa_decode = held
    try:
        lg, _ = make_decode_step(cfg, ctx, BASELINE, seq_shard_decode=True)(
            params if held_params is None else held_params, blocks, batch,
            pos)
    finally:
        fd.seq_sharded_gqa_decode = orig
    changed = ((row_sums(blocks["k"]) + row_sums(blocks["v"])) != before)
    return {"pos": pos, "attn_max_abs": max(errs), "sites": len(errs),
            "logits_rms": rms_rel(lg, lg_plain),
            "finite": bool(torch.isfinite(lg).all()),
            "cache_equal": all(torch.equal(blocks[k], ctx.shard(whole[k],
                                                                spec))
                               for k in ("k", "v")),
            "changed_rows": sorted({int(r) for r in
                                    torch.nonzero(changed)[:, 1]})}


def zamba_setup(dev, S: int, seed: int = 0) -> tuple:
    """zamba2-2.7b (reduced on the CPU): the weights (seed 0, the same on
    every rank) and random SSM caches for batch 1 at S."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build, cache_abstract
    cfg = get_arch("zamba2-2.7b")
    if dev.type == "cpu":
        cfg = reduced(cfg)
    params = init_params(build(cfg).param_specs(),
                         torch.Generator(device=dev).manual_seed(seed))
    abs_t, _ = cache_abstract(cfg, 1, S)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    ssm = {k: torch.randn(t.shape, generator=gen, device=dev).mul_(
        0.1 if k == "state" else 0.3).to(t.dtype)
        for k, t in abs_t["ssm"].items()}
    return cfg, params, ssm, abs_t


def flash_decode_worker(shape, device: str) -> int:
    """One rank of the ``flash_decode`` step on mesh ``shape``: the values
    check at the first S (the whole cache drawn on the host from one numpy
    seed, identically on every rank, and cut to this rank's block), then
    long_500k (every rank draws its own block on the device from (seed,
    rank); no whole cache exists anywhere).  Rank 0 prints one JSON
    line."""
    import types

    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch.bench import distributed as dist
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import shard_params
    from repro_torch.models.variant import BASELINE
    from repro_torch.serve import flash_decode as fd
    from repro_torch.train.step import make_decode_step
    dist.ensure_initialized(device)
    mesh = make_mesh(shape, MESH_AXES, device=device)
    ctx, dev, rank = ShardCtx(mesh), mesh.device, dist.process_index()
    world = tdist.get_world_size()
    report: dict = {"shape": list(shape), "coords": mesh.coords}
    # the refusals: a world of another size, a CUDA tensor at gloo
    try:
        make_mesh((1, world // 2, 1), MESH_AXES, device=device)
        report["world_mismatch"] = "no error"
    except ValueError as e:
        report["world_mismatch"] = str(e)
    if dev.type == "cuda":
        gloo = tdist.new_group(list(range(world)), backend="gloo")
        fake = ShardCtx(types.SimpleNamespace(
            shape={"data": world}, axis_names=("data",),
            groups={"data": gloo}, coords={"data": rank}))
        try:
            fake.all_reduce(torch.zeros(1, device=dev), ("data",))
            report["cuda_on_gloo"] = "no error"
        except RuntimeError as e:
            report["cuda_on_gloo"] = str(e)
    S, S_long = FLASH_DECODE_S[dev.type]
    cfg, params, ssm, abs_t = zamba_setup(dev, S)
    held = shard_params(cfg, params, ctx)
    report["param_bytes_a_rank"] = sum(t.numel() * t.element_size()
                                       for t in tree_leaves(held))
    n_seq = ctx.axis_size("data")
    report["cache_spec"] = list(fd.cache_spec(ctx, cfg))
    # 1) values: the whole cache on the host from numpy seeds (7, site,
    # k / v), each array drawn by one rank in turn and broadcast to all
    t0 = time.perf_counter()
    whole = {k: torch.empty(abs_t[k].shape, dtype=abs_t[k].dtype, device=dev)
             for k in ("k", "v")}
    for site in range(whole["k"].shape[0]):
        for j, k in enumerate(("k", "v")):
            owner = (2 * site + j) % world
            if rank == owner:
                a = np.random.default_rng([7, site, j]).standard_normal(
                    whole[k].shape[1:], dtype=np.float32)
                whole[k][site] = torch.from_numpy(a).mul_(0.3).to(
                    dev).to(whole[k].dtype)
            tdist.broadcast(whole[k][site], src=owner)
    report["draw_s"] = time.perf_counter() - t0
    report["whole_cache_bytes"] = sum(t.numel() * t.element_size()
                                      for t in whole.values())
    block = S // n_seq
    tok = torch.full((1, 1), 11, dtype=torch.int64, device=dev)
    report["values"] = [
        hold_decode_at(ctx, cfg, params, whole, ssm, tok, pos, held)
        for pos in sorted({5, block - 1, block, S - 1})]
    del whole, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # 2) long_500k: this rank's block only, drawn on the device
    spec = fd.cache_spec(ctx, cfg)
    tp_n = ctx.axis_size("model") if len(spec) > 2 else 1
    n_sites = abs_t["k"].shape[0]
    bshape = (n_sites, 1, S_long // n_seq, cfg.n_kv_heads // tp_n,
              cfg.resolved_head_dim)
    gen = torch.Generator(device=dev).manual_seed(1000 + rank)
    cache = {"ssm": fd.shard_ssm(ctx, cfg, ssm),
             "k": torch.randn(bshape, generator=gen, device=dev,
                              dtype=torch.bfloat16).mul_(0.3),
             "v": torch.randn(bshape, generator=gen, device=dev,
                              dtype=torch.bfloat16).mul_(0.3)}
    report["long"] = {"S": S_long, "block": list(bshape),
                      "kv_bytes_a_rank": 2 * cache["k"].numel() * 2}
    before = row_sums(cache["k"]) + row_sums(cache["v"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step = make_decode_step(cfg, ctx, BASELINE, seq_shard_decode=True)
    pos0 = S_long // 2 - LONG_TOKENS // 2      # crosses a shard boundary
    vocab = cfg.vocab_size
    times, finite, toks = [], True, []
    for i in range(LONG_TOKENS):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        lg, cache = step(held, cache, {"tokens": tok}, pos0 + i)
        tok = torch.argmax(lg[:, :, :vocab], dim=-1)
        toks.append(int(tok))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(lg).all())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    changed = ((row_sums(cache["k"]) + row_sums(cache["v"])) != before)
    start = mesh.coords["data"] * (S_long // n_seq)
    report["long"].update({
        "ms_a_token": [t * 1e3 for t in times], "finite": finite,
        "tokens": toks,
        "changed_rows": sorted({start + int(r) for r in
                                torch.nonzero(changed)[:, 1]}),
        "owned_positions": [p for p in range(pos0, pos0 + LONG_TOKENS)
                            if start <= p < start + S_long // n_seq],
        "peak_bytes": peak})
    reports = dist._all_gather(report)
    if dist.is_primary():
        print("FLASH_DECODE " + json.dumps(reports), flush=True)
    return 0


def moe_hold(ctx, cfg, B: int, P: int, G: int, dev) -> dict:
    """Serve ``cfg`` on the mesh (prefill of this rank's block of the B x P
    batch through the kernels, G - 1 decode steps teacher-forced with the
    one-GPU path's greedy tokens) and on one GPU, the same block alone
    (capacity is per data shard): every moe layer's output (relative RMS)
    and the logits.  The one-GPU path runs first on this rank's whole
    weights, which are then cut to the held layout."""
    from dataclasses import replace

    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build, make_batch, shard_params
    from repro_torch.models.variant import BASELINE
    model = build(cfg)
    variant = replace(BASELINE, use_pallas=True)
    params = init_params(model.param_specs(),
                         torch.Generator(device=dev).manual_seed(0))
    tokens = make_batch(cfg, (B, P), torch.Generator(device=dev).manual_seed(
        1))["tokens"]
    tokens = ctx.shard(tokens, ctx.block_spec(tokens.shape, ("batch", None)))
    V = cfg.vocab_size
    orig = moe.moe_layer
    log: list = []

    def recording(*a, **kw):
        out = orig(*a, **kw)
        log.append(out[0])
        return out

    def serve(p, c, toks_in, teacher=None):
        """Prefill and G - 1 decode steps: (logits list, tokens)."""
        lg, cache = model.prefill(p, toks_in, c, variant)
        cache = pad_cache(cfg, cache, toks_in.shape[0], P, G)
        out_l = [lg[:, :V]]
        nxt = torch.argmax(lg[:, :V], -1)[:, None]
        out_t = [nxt]
        for i in range(G - 1):
            if teacher is not None:
                nxt = teacher[:, i:i + 1]
            lg, cache = model.decode_step(p, cache, nxt, P + i, c, variant)
            out_l.append(lg[:, 0, :V])
            nxt = torch.argmax(lg[:, :, :V], -1)
            out_t.append(nxt)
        return out_l, torch.cat(out_t, 1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    moe.moe_layer = recording
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            log.clear()
            ref_logits, teacher = serve(params, None, tokens)
            ref_layers = list(log)
            sync()
            one_s = time.perf_counter() - t0
            held = shard_params(cfg, params, ctx)
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            log.clear()
            fa.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            got_logits, _ = serve(held, ctx, tokens, teacher[:, :-1])
            sync()
            mesh_s = time.perf_counter() - t0
    finally:
        moe.moe_layer = orig
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, P, G],
            "block": list(tokens.shape), "moe_calls": len(log),
            "layer_rms": max(rms_rel(a, b) for a, b in zip(log, ref_layers)),
            "logits_rms": max(rms_rel(a, b)
                              for a, b in zip(got_logits, ref_logits)),
            "finite": all(bool(torch.isfinite(x).all()) for x in got_logits),
            "flash_launches": fa.launch_counts["flash_attn"],
            "mesh_s": mesh_s, "one_gpu_s": one_s}


def moe_alone(ctx, cfg, B: int, P: int, G: int, dev) -> dict:
    """Serve ``cfg`` on the mesh where one GPU cannot hold it (the held
    blocks drawn rank by rank, ``init_params_held``): peak memory, a cold
    and a warm prefill, decode ms a step, flash launches, finite logits,
    and every moe layer's top-K choices against the router run alone on
    this GPU on the same input."""
    from dataclasses import replace

    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models import moe
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import (build, init_params_held,
                                             make_batch)
    from repro_torch.models.variant import BASELINE
    model = build(cfg)
    variant = replace(BASELINE, use_pallas=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    held = init_params_held(cfg, ctx, 0, dev)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(held))
    tokens = make_batch(cfg, (B, P), torch.Generator(device=dev).manual_seed(
        1))["tokens"]
    tokens = ctx.shard(tokens, ctx.block_spec(tokens.shape, ("batch", None)))
    V = cfg.vocab_size
    orig = moe.route
    routes: list = []

    def recording(cfg_, p, xf):
        out = orig(cfg_, p, xf)
        routes.append((p["router"], xf, out[2]))
        return out

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fa.reset_launch_counts()
    moe.route = recording
    try:
        with torch.inference_mode():
            prefill_ms = []
            for _ in range(2):
                routes.clear()
                sync()
                t0 = time.perf_counter()
                lg, cache = model.prefill(held, tokens, ctx, variant)
                sync()
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            cache = pad_cache(cfg, cache, tokens.shape[0], P, G)
            finite = bool(torch.isfinite(lg).all())
            nxt = torch.argmax(lg[:, :V], -1)[:, None]
            step_ms = []
            for i in range(G - 1):
                sync()
                t0 = time.perf_counter()
                lg, cache = model.decode_step(held, cache, nxt, P + i, ctx,
                                              variant)
                nxt = torch.argmax(lg[:, :, :V], -1)
                sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                finite &= bool(torch.isfinite(lg).all())
            same = all(torch.equal(orig(cfg, {"router": r}, xf)[2], topi)
                       for r, xf, topi in routes)
    finally:
        moe.route = orig
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, P, G],
            "param_bytes_a_rank": param_bytes,
            "w_gate_block": list(held["blocks"]["moe"]["w_gate"].shape),
            "prefill_ms": prefill_ms, "decode_ms": step_ms,
            "flash_launches": fa.launch_counts["flash_attn"],
            "finite": finite, "topk_equal": same, "routed_calls": len(routes),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def moe_worker(shape, device: str) -> int:
    """One rank of the ``moe_ep`` step on mesh ``shape``: deepseek-v2-236b
    at full width on 2 layers against the one-GPU path; on a mesh whose
    model axis takes every rank, also arctic-480b at full width on 2
    layers (no reference: one GPU cannot hold it) and arctic reduced
    against one GPU.  On the CPU every config is reduced.  Rank 0 prints
    one JSON line."""
    from dataclasses import replace

    from repro_torch.bench import distributed as dist
    from repro_torch.configs import get_arch, reduced
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import make_mesh
    dist.ensure_initialized(device)
    mesh = make_mesh(shape, MESH_AXES, device=device)
    ctx, dev = ShardCtx(mesh), mesh.device
    B, P, G = MOE_SHAPE[dev.type]
    full = dev.type == "cuda"

    def cut(arch):
        cfg = get_arch(arch)
        return replace(cfg, n_layers=2) if full else reduced(cfg)
    report = {"shape": list(shape),
              "deepseek": moe_hold(ctx, cut("deepseek-v2-236b"), B, P, G,
                                   dev)}
    if mesh.shape["model"] == dist.process_count():
        report["arctic"] = moe_alone(ctx, cut("arctic-480b"), B, P, G, dev)
        report["arctic_reduced"] = moe_hold(
            ctx, reduced(get_arch("arctic-480b")), B, P, G, dev)
    reports = dist._all_gather(report)
    if dist.is_primary():
        print("MOE_EP " + json.dumps(reports), flush=True)
    return 0


def _launch_workers(fn: str, shape, n: int, dev, src, tag: str,
                    timeout: float) -> tuple[list, str]:
    """``mesh_check.<fn>(shape, device)`` on n processes (one device each;
    NCCL on CUDA, gloo on the CPU); returns rank 0's JSON line (every
    rank's report) and the launch's output."""
    import os

    from repro_torch.bench.distributed import launch_local
    env = dict(os.environ, PYTHONPATH=str(src))
    code = (f"import sys; sys.path[:0] = [{str(src)!r}, "
            f"{str(ROOT / 'tools')!r}]; import mesh_check; "
            f"sys.exit(mesh_check.{fn}({tuple(shape)!r}, {dev.type!r}))")
    lines: list[str] = []

    class Sink:
        def write(self, s):
            lines.append(s)

        def flush(self):
            pass
    rc = launch_local([sys.executable, "-c", code], processes=n, env=env,
                      timeout=timeout, stream_to=Sink(), device=dev.type)
    text = "".join(lines)
    doc = next((json.loads(line.split(tag + " ", 1)[1])
                for line in text.splitlines() if tag + " " in line), None)
    if rc != 0 or doc is None:
        raise AssertionError(f"{fn} {shape} exited {rc}:\n{text[-8000:]}")
    return doc, text


def rule_bytes(shape, cfg, S: int | None = None) -> tuple[int, int]:
    """(bytes of the parameters, or with S of the batch-1 cache, one rank
    would hold under the reference's rules on mesh ``shape``, the bytes of
    the whole): ``ShardCtx.layout`` on an ``AbstractMesh``, nothing
    allocated."""
    from repro_torch.distributed.sharding import AbstractMesh, ShardCtx
    from repro_torch.models.registry import build, cache_abstract
    ctx = ShardCtx(AbstractMesh(tuple(shape), MESH_AXES))
    if S is None:
        import torch

        from repro_torch.models.common import spec_map
        specs = build(cfg).param_specs()
        tree = spec_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), specs)
        axes = spec_map(lambda t: t.axes, specs)
    else:
        tree, axes = cache_abstract(cfg, 1, S)
    rep = ctx.layout(tree, axes)
    return (sum(r["bytes_a_rank"] for r in rep.values()),
            sum(r["bytes"] for r in rep.values()))


def check_flash_decode(dev, n, src, log) -> dict:
    """zamba2-2.7b's sequence-sharded decode on meshes (1, n, 1) and (1, 2,
    n/2): the values check against the plain decode (attention a site
    within ATTN_TOL, logits within LOGITS_RMS_TOL, the cache bit for bit,
    only the owner of ``pos`` writing) at ``pos`` in the first shard, on
    both sides of a shard boundary and last; then long_500k's block a rank,
    ms a token, peak memory, finite logits, only owned rows changed."""
    out = {}
    S, S_long = FLASH_DECODE_S[dev.type]
    for shape in ((1, n, 1), (1, 2, n // 2)):
        t0 = time.perf_counter()
        ranks, _ = _launch_workers("flash_decode_worker", shape, n, dev, src,
                                   "FLASH_DECODE", 600)
        key = "x".join(map(str, shape))
        for r in ranks:
            if f"needs {n // 2} processes" not in r["world_mismatch"]:
                raise AssertionError(f"{key}: a mismatched world: "
                                     f"{r['world_mismatch']}")
            if dev.type == "cuda" and "gloo collective" not in \
                    r["cuda_on_gloo"]:
                raise AssertionError(f"{key}: CUDA at gloo: "
                                     f"{r['cuda_on_gloo']}")
            n_seq = shape[1]
            for v in r["values"]:
                owner = v["pos"] // (S // n_seq)
                want_rows = ([v["pos"] - owner * (S // n_seq)]
                             if r["coords"]["data"] == owner else [])
                if not (v["attn_max_abs"] < ATTN_TOL
                        and v["logits_rms"] <= LOGITS_RMS_TOL
                        and v["cache_equal"] and v["finite"]
                        and v["changed_rows"] == want_rows):
                    raise AssertionError(f"{key} rank {r['coords']}: {v} "
                                         f"(rows wanted {want_rows})")
            lg = r["long"]
            if not (lg["finite"] and lg["changed_rows"]
                    == lg["owned_positions"]):
                raise AssertionError(f"{key} long_500k: {lg}")
        if len({tuple(r["long"]["tokens"]) for r in ranks}) != 1:
            raise AssertionError(f"{key}: ranks decoded other tokens")
        worst = {k: max(v[k] for r in ranks for v in r["values"])
                 for k in ("attn_max_abs", "logits_rms")}
        ms = [sorted(r["long"]["ms_a_token"][1:])[len(
            r["long"]["ms_a_token"][1:]) // 2] for r in ranks]
        peak = [r["long"]["peak_bytes"] for r in ranks]
        out[key] = {"ranks": ranks, "worst": worst,
                    "long_median_ms_a_token": max(ms), "peak_bytes": peak,
                    "wall_s": time.perf_counter() - t0}
        log(f"  mesh {key}: cache spec {ranks[0]['cache_spec']}; values at "
            f"S {S} ({ranks[0]['whole_cache_bytes'] / 1e9:.2f} GB whole, "
            f"drawn in {ranks[0]['draw_s']:.1f} s), pos "
            f"{[v['pos'] for v in ranks[0]['values']]}: attention within "
            f"{worst['attn_max_abs']:.3e} (limit {ATTN_TOL}), logits "
            f"{worst['logits_rms']:.3e} (limit {LOGITS_RMS_TOL}), caches bit "
            f"for bit, only the owner wrote")
        from repro_torch.configs import get_arch, reduced
        cfg = get_arch("zamba2-2.7b")
        cfg = reduced(cfg) if dev.type == "cpu" else cfg
        (c_rank, c_whole), (p_rank, p_whole) = \
            rule_bytes(shape, cfg, S_long), rule_bytes(shape, cfg)
        out[key]["rules"] = {"cache_a_rank": c_rank, "cache": c_whole,
                             "params_a_rank": p_rank, "params": p_whole}
        held = {r["param_bytes_a_rank"] for r in ranks}
        if held != {p_rank}:
            raise AssertionError(f"{key}: parameters held {held} bytes a "
                                 f"rank; the rules give {p_rank}")
        log(f"  mesh {key}: under the reference's rules a rank would hold "
            f"{c_rank / 1e9:.2f} of the cache's {c_whole / 1e9:.2f} GB and "
            f"{p_rank / 1e9:.2f} of the parameters' {p_whole / 1e9:.2f} GB; "
            f"the port holds exactly those parameter bytes (every leaf as "
            f"its block, gathered over the fsdp axes at use) and the KV and "
            f"SSM caches as blocks")
        log(f"  mesh {key}: long_500k S {S_long}, "
            f"{ranks[0]['long']['kv_bytes_a_rank'] / 1e9:.2f} GB of KV a rank "
            f"(block {ranks[0]['long']['block']}): median "
            f"{max(ms):.2f} ms a token (slowest rank; each rank "
            + ", ".join(f"{m:.2f}" for m in ms) + "), peak "
            + (", ".join(f"{p / 2**30:.2f}" for p in peak) + " GiB"
               if dev.type == "cuda" else "not measured (CPU)")
            + f"; finite; rows written "
            f"{sorted({p for r in ranks for p in r['long']['changed_rows']})}"
            f" by their owners only; {out[key]['wall_s']:.1f} s")
    return out


def check_moe_ep(dev, n, src, log) -> dict:
    """The expert-parallel MoE on meshes (1, 1, n) and (1, 2, n/2):
    deepseek-v2-236b at full width on 2 layers against one GPU (each moe
    layer within LAYER_TOL, the logits within LOGITS_RMS_TOL); on (1, 1,
    n) arctic-480b at full width on 2 layers (no reference; its peak
    memory, times, launches and routing) and reduced against one GPU."""
    out = {}
    per_layer = 1 if dev.type == "cuda" else 0      # the CPU: plain flash
    for shape in ((1, 1, n), (1, 2, n // 2)):
        t0 = time.perf_counter()
        ranks, _ = _launch_workers("moe_worker", shape, n, dev, src,
                                   "MOE_EP", 600)
        key = "x".join(map(str, shape))
        for r in ranks:
            for name in ("deepseek", "arctic_reduced"):
                h = r.get(name)
                if h is None:
                    continue
                if not (h["layer_rms"] <= LAYER_TOL and h["finite"]
                        and h["logits_rms"] <= LOGITS_RMS_TOL
                        and h["flash_launches"] == per_layer * h["layers"]):
                    raise AssertionError(f"{key} {name}: {h}")
            a = r.get("arctic")
            if a is not None and not (a["finite"] and a["topk_equal"]
                                      and a["flash_launches"]
                                      == 2 * per_layer * a["layers"]):
                raise AssertionError(f"{key} arctic: {a}")
        out[key] = {"ranks": ranks, "wall_s": time.perf_counter() - t0}
        for name in ("deepseek", "arctic_reduced"):
            if name not in ranks[0]:
                continue
            hs = [r[name] for r in ranks]
            log(f"  mesh {key} {hs[0]['arch']} ({hs[0]['layers']} layers, "
                f"batch {hs[0]['batch']}): moe layers within "
                f"{max(h['layer_rms'] for h in hs):.3e} of one GPU (limit "
                f"{LAYER_TOL}), logits {max(h['logits_rms'] for h in hs):.3e}"
                f" (limit {LOGITS_RMS_TOL}); {hs[0]['moe_calls']} moe calls, "
                f"{hs[0]['flash_launches']} flash launches a rank; mesh "
                f"{max(h['mesh_s'] for h in hs):.2f} s, one GPU "
                f"{max(h['one_gpu_s'] for h in hs):.2f} s (first calls)")
        if "arctic" in ranks[0]:
            a = [r["arctic"] for r in ranks]
            step_ms = max(sorted(x["decode_ms"])[len(x["decode_ms"]) // 2]
                          for x in a)
            from repro_torch.configs import get_arch, reduced
            from dataclasses import replace
            cfg = get_arch("arctic-480b")
            cfg = (reduced(cfg) if dev.type == "cpu"
                   else replace(cfg, n_layers=2))
            p_rank, p_whole = rule_bytes(shape, cfg)
            out[key]["rules"] = {"params_a_rank": p_rank, "params": p_whole}
            if {x["param_bytes_a_rank"] for x in a} != {p_rank}:
                raise AssertionError(
                    f"{key} arctic: held {a[0]['param_bytes_a_rank']} "
                    f"bytes a rank; the rules give {p_rank}")
            log(f"  mesh {key} {cfg.name}: under the reference's rules a "
                f"rank would hold {p_rank / 1e9:.2f} of the parameters' "
                f"{p_whole / 1e9:.2f} GB; the port holds "
                f"{a[0]['param_bytes_a_rank'] / 1e9:.2f} (every leaf as its "
                f"block)")
            log(f"  mesh {key} {a[0]['arch']} at full width "
                f"({a[0]['layers']} layers, batch {a[0]['batch']}): expert "
                f"block {a[0]['w_gate_block']} a rank, "
                f"{a[0]['param_bytes_a_rank'] / 1e9:.2f} GB of parameters a "
                f"rank, peak "
                + (", ".join(f"{x['peak_bytes'] / 2**30:.2f}" for x in a)
                   + " GiB" if dev.type == "cuda" else "not measured (CPU)")
                + f"; prefill cold / warm "
                f"{max(x['prefill_ms'][0] for x in a):.1f} / "
                f"{max(x['prefill_ms'][1] for x in a):.1f} ms, decode "
                f"{step_ms:.2f} ms a step (median, slowest rank); flash launches "
                f"{a[0]['flash_launches']}; logits finite; top-K = the "
                f"router alone ({a[0]['routed_calls']} calls)")
        log(f"  mesh {key}: {out[key]['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------

#: the train step's shape: global batch x sequence, AdamW steps (the batch
#: of chip_smoke.py phase 3j), by device
TRAIN_SHAPE = {"cuda": (4, 512, 8), "cpu": (4, 64, 4)}
#: the deepseek-v2-236b run at full width: layers, AdamW steps
TRAIN_MOE = (2, 2)
#: AdamW, as phase 3j trains (a short warmup, so that the loss moves)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2)
#: the loss against one GPU's: step 0, every later step (relative)
TRAIN_LOSS0_TOL, TRAIN_LOSS_TOL = 2e-3, 2e-2
#: a rank's matmul FLOPs of a step against one GPU's over the mesh's ranks
TRAIN_FLOPS_TOL = 1.15


def _matmul_flops(fn) -> int:
    """The matrix-product FLOPs ``torch.utils.flop_counter`` counts in one
    call of ``fn`` (forward, backward and the remat recompute)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _busy_ms(fn, dev) -> tuple:
    """(kernel ms of one call of ``fn`` from ``torch.profiler``, the part
    of it in NCCL kernels) on CUDA; (None, None) on the CPU or where the
    profiler records no device time."""
    import torch
    if dev.type != "cuda":
        fn()
        return None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in ev)
    nccl = sum(e.time_range.elapsed_us() for e in ev
               if "nccl" in e.name.lower())
    return (us / 1e3, nccl / 1e3) if us > 0 else (None, None)


def _held_bytes(*trees) -> int:
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree))


def _kernel_launches() -> int:
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.membench import membench as mb
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    return sum(v for mod in (mb, fa, sk) for v in mod.launch_counts.values())


def train_granite(mesh, dev) -> dict:
    """granite-3-2b (reduced on the CPU) through the ``Trainer`` on
    ``mesh`` (None: one device): TRAIN_SHAPE's steps with remat full, each
    step's loss and wall ms, one further step by device-busy time (and its
    NCCL share), the steps' peak memory (the whole tree each rank draws
    once before them excluded), the bytes this rank holds beside the
    rules' and hand-written kernel launches."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.distributed.sharding import AbstractMesh, ShardCtx
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.membench import membench as mb
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.common import spec_map
    from repro_torch.models.registry import build, held_axes
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer
    B, S, steps = TRAIN_SHAPE[dev.type]
    cfg = get_arch("granite-3-2b")
    cfg = reduced(cfg) if dev.type == "cpu" else cfg
    for mod in (mb, fa, sk):
        mod.reset_launch_counts()
    tcfg = TrainConfig(steps=steps, ckpt_every=steps + 1, log_every=1,
                       ckpt_dir=str(ROOT / "artifacts" / "mesh_train"),
                       opt=adamw.AdamWConfig(total_steps=steps, **TRAIN_OPT))
    trainer = Trainer(cfg, (B, S), mesh, tcfg, device=dev)
    inner = trainer.step_fn

    def step_fn(*args):
        if dev.type == "cuda" and not calls:
            # the peak of the steps, not of drawing the whole tree once
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        calls.append(1)
        return inner(*args)
    calls: list = []
    trainer.step_fn = step_fn
    with contextlib.redirect_stdout(io.StringIO()):
        params, opt_state, hist = trainer.train(resume=False)
    batch = trainer.pipeline.batch(steps)
    busy, nccl = _busy_ms(lambda: trainer.step_fn(params, opt_state, batch),
                          dev)
    flops = _matmul_flops(lambda: trainer.step_fn(params, opt_state, batch))
    shape = tuple(mesh.shape.values()) if mesh is not None else (1, 1, 1)
    rules = ShardCtx(AbstractMesh(shape, MESH_AXES)).layout(
        spec_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                       device="meta"),
                 build(cfg).param_specs()), held_axes(cfg))
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, S],
            "params": sum(r["bytes"] for r in rules.values()) // 4,
            "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_ms": [h["dt"] * 1e3 for h in hist],
            "busy_ms": busy, "nccl_ms": nccl, "matmul_flops": flops,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "held_bytes": _held_bytes(params, opt_state["mu"],
                                      opt_state["nu"]),
            "rule_bytes": 3 * sum(r["bytes_a_rank"] for r in rules.values()),
            "kernel_launches": _kernel_launches()}


def train_deepseek(ctx, dev) -> dict:
    """deepseek-v2-236b at full width on TRAIN_MOE's layers (reduced on
    the CPU), its blocks drawn rank by rank (``init_params_held``): the
    expert-parallel ``moe_layer`` differentiated, TRAIN_MOE's steps on
    this rank's block of one TRAIN_SHAPE batch (the same batch each step,
    so that the loss after an update is comparable), held bytes against
    the rules, peak memory, step ms, losses."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed.sharding import AbstractMesh, ShardCtx
    from repro_torch.models.common import spec_map
    from repro_torch.models.registry import (build, held_axes,
                                             init_params_held)
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    layers, steps = TRAIN_MOE
    B, S, _ = TRAIN_SHAPE[dev.type]
    cfg = get_arch("deepseek-v2-236b")
    cfg = reduced(cfg) if dev.type == "cpu" else replace(cfg, n_layers=layers)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_params_held(cfg, ctx, 0, dev)
    opt_state = adamw.init_state(params)
    step = make_train_step(cfg, ctx, adamw.AdamWConfig(
        total_steps=steps, **TRAIN_OPT))
    batch = make_pipeline(cfg, (B, S), ctx, seed=0, device=dev).batch(0)
    losses, ms = [], []
    for _ in range(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    rules = ShardCtx(AbstractMesh(tuple(ctx.mesh.shape.values()),
                                  MESH_AXES)).layout(
        spec_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                       device="meta"),
                 build(cfg).param_specs()), held_axes(cfg))
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, S],
            "block": list(batch["tokens"].shape), "losses": losses,
            "step_ms": ms,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "param_bytes": _held_bytes(params),
            "param_rule_bytes": sum(r["bytes_a_rank"]
                                    for r in rules.values()),
            "kernel_launches": _kernel_launches()}


def train_worker(shape, device: str) -> int:
    """One rank of the ``train`` step on mesh ``shape``: granite through
    the Trainer (one device where the shape has one position), and on a
    mesh with a model axis also deepseek.  Rank 0 prints one JSON line."""
    from repro_torch.bench import distributed as dist
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import make_mesh
    dist.ensure_initialized(device)
    mesh = make_mesh(shape, MESH_AXES, device=device)
    report = {"shape": list(shape), "coords": mesh.coords,
              "granite": train_granite(mesh, mesh.device)}
    if mesh.shape["model"] > 1 and mesh.shape["data"] > 1:
        report["deepseek"] = train_deepseek(ShardCtx(mesh), mesh.device)
    reports = dist._all_gather(report)
    if dist.is_primary():
        print("TRAIN " + json.dumps(reports), flush=True)
    return 0


def check_train(dev, n, src, log) -> dict:
    """Training on meshes (1, n, 1), (1, 2, n/2) and (1, 1, n) against one
    device of the same machine: granite-3-2b at full width (reduced on the
    CPU) through the Trainer, the same steps each; finite losses that fall,
    step 0 within TRAIN_LOSS0_TOL of one device's and every later step
    within TRAIN_LOSS_TOL, every rank's matmul FLOPs within
    TRAIN_FLOPS_TOL of one device's over the ranks, every rank holding the
    rules' bytes of parameters and moments, no hand-written kernel
    launched; on (1, 2,
    n/2) also deepseek-v2-236b at full width on 2 layers, a finite loss
    that falls and the rules' parameter bytes."""
    out = {}
    B, S, steps = TRAIN_SHAPE[dev.type]
    one = None
    one_flops = None
    for shape in dict.fromkeys(((1, 1, 1), (1, n, 1), (1, 2, n // 2),
                                (1, 1, n))):
        t0 = time.perf_counter()
        ranks, _ = _launch_workers("train_worker", shape, math.prod(shape),
                                   dev, src, "TRAIN", 1500)
        key = "x".join(map(str, shape))
        g = ranks[0]["granite"]
        losses = g["losses"]
        if not (len(losses) == steps and all(map(math.isfinite, losses))
                and losses[-1] < losses[0]):
            raise AssertionError(f"{key}: losses {losses}")
        for r in ranks:
            x = r["granite"]
            if x["held_bytes"] != x["rule_bytes"] or x["kernel_launches"]:
                raise AssertionError(f"{key} rank {r['coords']}: held "
                                     f"{x['held_bytes']} bytes, the rules "
                                     f"{x['rule_bytes']}; kernel launches "
                                     f"{x['kernel_launches']}")
        flops = [r["granite"]["matmul_flops"] for r in ranks]
        if one_flops is None:
            one_flops = flops[0]
        ratio = [f * math.prod(shape) / one_flops for f in flops]
        if max(ratio) > TRAIN_FLOPS_TOL:
            raise AssertionError(f"{key}: matmul FLOPs a rank {flops} "
                                 f"against one device's {one_flops} over "
                                 f"{math.prod(shape)} ranks")
        if one is None:
            one = losses
        else:
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, one)]
            if rel[0] > TRAIN_LOSS0_TOL or max(rel[1:]) > TRAIN_LOSS_TOL:
                raise AssertionError(f"{key}: losses {losses} against one "
                                     f"device's {one}")
            g["loss_rel"] = rel
        warm = sorted(g["step_ms"][1:])    # rank 0's: it keeps the history
        med = warm[len(warm) // 2]
        peak = [r["granite"]["peak_bytes"] for r in ranks]
        busy = [r["granite"]["busy_ms"] for r in ranks]
        nccl = [r["granite"]["nccl_ms"] for r in ranks]
        compute = [None if b is None else b - c
                   for b, c in zip(busy, nccl)]
        out[key] = {"ranks": ranks, "median_step_ms": med,
                    "tokens_per_s": B * S / (med / 1e3),
                    "matmul_flops": flops, "one_flops": one_flops,
                    "flops_over_ranks": ratio, "compute_ms": compute,
                    "wall_s": time.perf_counter() - t0}
        log(f"  mesh {key} {g['arch']} ({g['layers']} layers, "
            f"{g['params']} parameters, batch {B} x {S}, {steps} steps, "
            f"remat full): loss {losses[0]:.4f} -> {losses[-1]:.4f}"
            + ("" if "loss_rel" not in g else
               f", against one device step 0 {g['loss_rel'][0]:.2e} (limit "
               f"{TRAIN_LOSS0_TOL}), later <= {max(g['loss_rel'][1:]):.2e} "
               f"(limit {TRAIN_LOSS_TOL})"))
        log(f"  mesh {key}: median warm step {med:.1f} ms wall (rank 0, "
            f"which waits for the others at every collective), "
            f"{B * S / (med / 1e3):.0f} tokens/s; a further step "
            + ("device busy " + ", ".join(f"{b:.1f}" for b in busy)
               + " ms a rank, NCCL kernels " + ", ".join(
                   f"{c:.1f}" for c in nccl) + " ms of it"
               if dev.type == "cuda" and None not in busy else
               "device busy not measured")
            + f"; matmul FLOPs a rank {flops[0] / 1e9:.1f} G against one "
            f"GPU's {one_flops / 1e9:.1f} G ("
            + ", ".join(f"{x:.3f}" for x in ratio)
            + f" of it over the {math.prod(shape)} ranks, limit "
            f"{TRAIN_FLOPS_TOL}); compute a rank (busy less NCCL) "
            + (", ".join(f"{c:.1f}" for c in compute) + " ms"
               if None not in compute else "not measured")
            + "; peak " + (", ".join(f"{p / 2**30:.2f}" for p in peak)
                           + " GiB a GPU" if dev.type == "cuda" else
                           "not measured (CPU)")
            + f"; parameters and moments held {g['held_bytes'] / 1e9:.3f} "
            f"GB a rank = the rules' {g['rule_bytes'] / 1e9:.3f}; "
            f"hand-written kernel launches {g['kernel_launches']}; "
            f"{out[key]['wall_s']:.1f} s")
        d = ranks[0].get("deepseek")
        if d is not None:
            ls = d["losses"]
            for r in ranks:
                x = r["deepseek"]
                if x["param_bytes"] != x["param_rule_bytes"] \
                        or x["kernel_launches"]:
                    raise AssertionError(f"{key} deepseek: {x}")
            if not (all(map(math.isfinite, ls)) and ls[-1] < ls[0]):
                raise AssertionError(f"{key} deepseek: losses {ls}")
            log(f"  mesh {key} {d['arch']} ({d['layers']} layers, batch "
                f"{d['batch']}, block {d['block']} a rank): loss "
                f"{ls[0]:.4f} -> {ls[-1]:.4f}; step ms "
                + ", ".join(
                    f"{max(r['deepseek']['step_ms'][i] for r in ranks):.1f}"
                    for i in range(len(ls)))
                + f"; parameters held {d['param_bytes'] / 1e9:.3f} GB a "
                f"rank = the rules' {d['param_rule_bytes'] / 1e9:.3f}; peak "
                + (", ".join(f"{r['deepseek']['peak_bytes'] / 2**30:.2f}"
                             for r in ranks) + " GiB a GPU"
                   if dev.type == "cuda" else "not measured (CPU)"))
    return out


STEPS = ("enqueue", "sharded", "scaling", "launch", "fig4", "collectives",
         "stragglers", "flash_decode", "moe_ep", "train")
#: the steps whose every-rank reports stay out of the log's last line
MESH_STEPS = ("flash_decode", "moe_ep", "train")


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
    if set(MESH_STEPS) & set(steps):
        if n % 2:
            raise SystemExit(f"mesh_check: the serving and training steps "
                             f"need an even pool; {n} devices")
    if ("flash_decode" in steps or "moe_ep" in steps) and dev.type == "cuda":
        fa.LIBRARY.build_all()          # once, before the ranks load it
    if "flash_decode" in steps:
        log(f"== flash_decode: zamba2-2.7b's sequence-sharded decode on "
            f"(1, {n}, 1) and (1, 2, {n // 2})")
        summary["flash_decode"] = check_flash_decode(dev, n, src, log)
    if "moe_ep" in steps:
        log(f"== moe_ep: expert-parallel MoE on (1, 1, {n}) and "
            f"(1, 2, {n // 2})")
        summary["moe_ep"] = check_moe_ep(dev, n, src, log)
    if "train" in steps:
        log(f"== train: granite-3-2b on (1, 1, 1), (1, {n}, 1), (1, 2, "
            f"{n // 2}) and (1, 1, {n}); deepseek-v2-236b on (1, 2, "
            f"{n // 2})")
        summary["train"] = check_train(dev, n, src, log)
    launched = {k: v for mod in (mb, fa, sk)
                for k, v in mod.launch_counts.items() if v}
    allowed = {"chase"} | ({"load_sum"} if "stragglers" in steps else set())
    if set(launched) - allowed or (dev.type == "cpu" and launched):
        raise AssertionError(f"kernels launched: {launched}")
    log(f"== all checks passed in {time.perf_counter() - t0:.1f} s; "
        f"launches in this process {launched} (the chase probe of a CUDA "
        f"shard, the straggler probe's load_sum; the serving steps' ranks "
        f"count their own flash launches)")
    summary = {"mesh_check": summary}
    (out_dir / f"mesh_check{suffix}.json").write_text(
        json.dumps(summary, indent=1))
    # the mesh steps' every-rank reports stay in the file
    log(json.dumps({k: (v if k not in MESH_STEPS else
                        {m: {f: x for f, x in r.items() if f != "ranks"}
                         for m, r in v.items()})
                    for k, v in summary["mesh_check"].items()}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
