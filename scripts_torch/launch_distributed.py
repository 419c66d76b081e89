#!/usr/bin/env python
"""Launch a multi-process benchmark of the port on one machine.

Counterpart of ``scripts/launch_distributed.py``: a thin shell over
``repro_torch.bench.distributed.launch_local`` — the same engine behind
``python -m repro_torch.bench launch``; this script exists so cluster entry
points / schedulers that expect a file path (not ``-m``) have one.

    # 2 processes x 2 GPUs each (NCCL) = a 4-device global mesh
    python scripts_torch/launch_distributed.py --processes 2 \\
        --devices-per-process 2 -- --mixes load_sum,copy --sizes 2M \\
        --reps 2 --out out.json
    # the same on logical CPU devices (gloo)
    python scripts_torch/launch_distributed.py --processes 2 \\
        --devices-per-process 2 --device cpu -- --mixes load_sum --sizes 1M

Everything after ``--`` is forwarded verbatim to each worker's
``python -m repro_torch.bench run --backend distributed``; process 0 writes
the gathered result.  On a real cluster skip this launcher entirely: start
one process per host with REPRO_COORDINATOR / REPRO_NUM_PROCESSES /
REPRO_PROCESS_ID set (or under torchrun) and run the same ``run`` command
everywhere.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
sys.path.insert(0, SRC)


def main(argv=None) -> int:
    # allow_abbrev: a pre-`--` `--devices N` must error loudly, not silently
    # match --devices-per-process
    ap = argparse.ArgumentParser(
        description=__doc__, allow_abbrev=False,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=1)
    ap.add_argument("--backend", default="distributed")
    ap.add_argument("--device", default=None,
                    help="cuda (default: a GPU slice a process, NCCL) | cpu "
                         "(logical CPU devices, gloo)")
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("worker_flags", nargs=argparse.REMAINDER,
                    help="flags after -- go to `repro_torch.bench run` "
                         "verbatim")
    args = ap.parse_args(argv)
    flags = [f for f in args.worker_flags if f != "--"]

    # the workers (`python -m repro_torch.bench`) must import the port like
    # this script does: propagate the src dir into their PYTHONPATH
    paths = os.environ.get("PYTHONPATH", "")
    if SRC not in paths.split(os.pathsep):
        os.environ["PYTHONPATH"] = (f"{SRC}{os.pathsep}{paths}" if paths
                                    else SRC)

    # one launch implementation: delegate to the CLI's `launch` (it owns the
    # full-mesh --devices default and the worker-argv assembly)
    from repro_torch.bench.cli import main as bench_main
    launch = ["launch", "--processes", str(args.processes),
              "--devices-per-process", str(args.devices_per_process),
              "--backend", args.backend]
    if args.device is not None:
        launch += ["--device", args.device]
    if args.timeout is not None:
        launch += ["--timeout", str(args.timeout)]
    return bench_main(launch + flags)


if __name__ == "__main__":
    sys.exit(main())
