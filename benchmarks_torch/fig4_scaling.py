"""Fig 4 — multi-device scaling + STREAM-triad comparison.

Counterpart of ``benchmarks/fig4_scaling.py`` on the port.  The scaling
curve is the ``sharded`` backend swept over the ``devices`` knob (one spec
per device count, merged by ``run_many``), each shard running the torch
oracle over its block of rows, as the reference's shards run its xla ones;
per-count speedup comes from ``BenchResult.baseline_relative``.  The triad
reference (the paper compares against STREAM on A64FX) is the registry's
``triad`` mix as a one-size spec, on ``torch`` at one device where the
reference runs ``xla``.

The pool is the run's device kind: every visible GPU on CUDA, and on the
CPU ``REPRO_TORCH_CPU_DEVICES`` logical devices — which this script sets to
8 when run as a program, as the reference forces 8 host devices, unless the
environment sets it.

``--distributed`` takes the same sweep multi-process: the script respawns
itself as ``--processes`` coordinated workers
(``repro_torch.bench.distributed.launch_local``: NCCL and a GPU slice each
on CUDA, gloo and logical devices on the CPU), each running the identical
sweep on the ``distributed`` backend over the **global** mesh; process 0
gathers and emits.  On a real cluster, start one worker per host with the
REPRO_* env set instead of respawning.

    PYTHONPATH=src:. python -m benchmarks_torch.fig4_scaling --quick
"""
import argparse
import os
import sys
from pathlib import Path

from benchmarks_torch.common import add_device_flags, emit
from repro_torch.bench.distributed import ENV_COORDINATOR, ENV_NUM_PROCESSES

#: the env names ``repro_torch.bench.distributed`` reads, set in workers by
#: the launcher, on the hosts of a real cluster, or by torchrun.  Any one of
#: them marks a worker, so a worker never respawns: keying on a process
#: COUNT alone would send a --processes 1 child (or a torchrun rank, whose
#: WORLD_SIZE is set) back into the launcher branch, an infinite respawn
#: chain.
LAUNCHER_ENV = ENV_COORDINATOR + ENV_NUM_PROCESSES


def under_launcher() -> bool:
    return any(os.environ.get(k) for k in LAUNCHER_ENV)


#: logical CPU devices of the pool when this script runs as a program (the
#: reference's ``--xla_force_host_platform_device_count=8``); the pool is
#: read when a run starts, so setting it in ``__main__`` is early enough
CPU_DEVICES = 8

ROOT = Path(__file__).resolve().parents[1]


def sizes_for(quick: bool = False, smoke: bool = False) -> tuple[int, int]:
    """(bytes a device, reps) — the reference's."""
    per_dev = 2 * 2**20 if quick else 16 * 2**20
    if smoke:
        per_dev = 256 * 2**10
    return per_dev, 2 if smoke else (4 if quick else 8)


def row_name(tag: str, devices: int) -> str:
    return f"{tag}/devices{devices}"


def triad_row_name(tag: str, devices: int) -> str:
    return f"{tag}/stream_triad_{devices}dev"


def curve_specs(backend: str, per_dev: int, counts, reps: int):
    """The devices sweep's specs, one per device count."""
    from repro_torch.bench import BenchSpec
    return [BenchSpec(mixes=("load_sum",), sizes=(per_dev * k,),
                      backend=backend, devices=k, passes=4,
                      reps=reps, warmup=2)
            for k in counts]


def triad_spec(backend: str, per_dev: int, counts, reps: int):
    """The STREAM triad reference: plain ``torch`` at one device beside the
    sharded sweep (the reference's ``xla``); a distributed run keeps every
    process in the computation on the smallest covering mesh.  Sized per
    device like the sweep, so the rows always shard evenly."""
    from repro_torch.bench import BenchSpec
    t_backend, t_devs = (("torch", 1) if backend == "sharded"
                         else (backend, min(counts)))
    return BenchSpec(mixes=("triad",), sizes=(per_dev * t_devs,), reps=reps,
                     warmup=2, backend=t_backend, devices=t_devs,
                     target_bytes=5e7)


def run_curve(backend: str, per_dev: int, counts, reps: int, device):
    """The devices sweep + emit lines (shared by both modes).  Under a
    multi-process run, only process 0 emits (it holds the gathered result);
    the sweep itself is identical SPMD work on every process."""
    from repro_torch.bench import Runner
    from repro_torch.bench import distributed as dist
    runner = Runner(device=device)
    res = dist.gather_result(runner.run_many(
        curve_specs(backend, per_dev, counts, reps)))
    # NB every process must reach this point — the measurement is SPMD; only
    # the emission below is gated on process 0
    spec = triad_spec(backend, per_dev, counts, reps)
    t = dist.gather_result(runner.run(spec)).points[0]

    if not dist.is_primary():
        return res
    tag = "fig4_dist" if backend == "distributed" else "fig4"
    pc = res.machine.get("process_count", 1)
    for p, speedup in res.baseline_relative(group_key=lambda p: p.mix):
        emit(row_name(tag, p.devices), p.mean_s * 1e6,
             f"{p.gbps:.2f}GB/s;speedup={speedup:.2f}x;processes={pc}")
    emit(triad_row_name(tag, spec.devices), t.mean_s * 1e6,
         f"{t.gbps:.2f}GB/s")
    return res


def main(quick: bool = False, smoke: bool = False, distributed: bool = False,
         processes: int = 2, devices_per_process: int = 2,
         device: str = "cuda") -> int:
    per_dev, reps = sizes_for(quick, smoke)

    if distributed and not under_launcher():
        # launcher role: respawn this script as N coordinated workers; their
        # global mesh has processes * devices_per_process devices
        if processes < 2:
            print("error: --distributed needs --processes >= 2 "
                  "(use the plain sharded mode for one process)",
                  file=sys.stderr)
            return 2
        from repro_torch.bench.distributed import launch_local
        argv = [sys.executable, "-m", "benchmarks_torch.fig4_scaling",
                "--distributed", "--processes", str(processes),
                "--devices-per-process", str(devices_per_process),
                "--device", str(device)]
        argv += ["--quick"] if quick else []
        argv += ["--smoke"] if smoke else []
        # the workers import the port and this package from this checkout
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), str(ROOT)] + ([path] if path else [])))
        return launch_local(argv, processes=processes,
                            devices_per_process=devices_per_process,
                            env=env, stream_to=sys.stdout, device=device)

    if distributed:                     # worker role (spawned above)
        from repro_torch.bench import distributed as dist
        dist.ensure_initialized(device)
        # the mesh must give every process a shard; the shared helper also
        # falls back to the full global mesh when no ladder value qualifies
        run_curve("distributed", per_dev,
                  dist.covering_device_counts(device=device), reps, device)
        return 0

    from repro_torch.bench.distributed import DEVICE_LADDER
    from repro_torch.core.device import device_pool
    pool = len(device_pool(device))     # raises without a CUDA device
    run_curve("sharded", per_dev, tuple(k for k in DEVICE_LADDER if k <= pool),
              reps, device)
    return 0


if __name__ == "__main__":
    if not under_launcher():
        from repro_torch.core.device import CPU_DEVICES_ENV
        os.environ.setdefault(CPU_DEVICES_ENV, str(CPU_DEVICES))
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes / 2 reps (CI gate)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process mode: respawns itself via the "
                         "repro_torch.bench launcher")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--devices-per-process", dest="devices_per_process",
                    type=int, default=2)
    add_device_flags(ap, backend=None)
    sys.exit(main(**vars(ap.parse_args())))
