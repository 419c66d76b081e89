"""Benchmark runner — one entry per paper table/figure, on the port.

Counterpart of ``benchmarks/run.py``:

``python -m benchmarks_torch.run``              quick pass of every benchmark
``python -m benchmarks_torch.run --full``       full sweep (slower)
``python -m benchmarks_torch.run --only fig2``  one entry (comma list)

Every figure script is a BenchSpec declaration executed by the port's
Runner (``python -m repro_torch.bench`` is the standalone CLI; the ``bench``
entry here smoke-runs it).  Output: ``name,us_per_call,derived`` CSV lines
(+ analysis tables).  fig4 runs in a subprocess (it sets its own device
pool before anything else), and so does ``collectives``, which launches
its own ranks: 8 gloo processes on a 2x4 mesh on the CPU, one process a
GPU on a 1xN mesh on CUDA; everything else runs in-process.  ``roofline``
renders the records of ``repro_torch.launch.dryrun`` and ``launch.probe``
(counted on the CPU, whatever ``--device`` says); a record of a failed
cell makes the run exit non-zero.

``--backend`` and ``--device`` (default ``cuda`` and ``cuda``) go to every
entry that takes them; fig4 runs its ``sharded`` mesh on ``--device``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ENTRIES = ("bench", "fig1", "fig2", "fig3", "fig4", "fig5", "fig6", "fig7",
           "table1", "collectives", "roofline")


def _subproc(mod: str, quick: bool, device: str, *extra: str) -> int:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{ROOT}/src{os.pathsep}{ROOT}"
    cmd = [sys.executable, "-m", mod, "--device", device, *extra] + \
        (["--quick"] if quick else [])
    r = subprocess.run(cmd, env=env, cwd=ROOT, text=True, capture_output=True,
                       timeout=3600)
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        sys.stdout.write(f"# {mod} FAILED\n{r.stderr[-2000:]}\n")
    return r.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma list: " + ",".join(ENTRIES))
    ap.add_argument("--backend", default="cuda",
                    help="cuda (the hand-written kernels) | torch (the "
                         "plain PyTorch oracles)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) | "
                         "cpu (the plain versions; no device number)")
    args = ap.parse_args(argv)
    quick = not args.full
    only = set(args.only.split(",")) if args.only else None
    unknown = (only or set()) - set(ENTRIES)
    if unknown:
        ap.error(f"unknown entries {sorted(unknown)}; known: "
                 f"{','.join(ENTRIES)}")
    dev = dict(backend=args.backend, device=args.device)
    rc = 0

    def want(name):
        return only is None or name in only

    print("# Arm-membench (PyTorch/CUDA port) benchmark suite")
    print("# name,us_per_call,derived")

    if want("bench"):
        print("\n## bench: unified experiment API smoke "
              "(python -m repro_torch.bench)")
        from repro_torch.bench.cli import main as bench_main
        (ROOT / "artifacts" / "torch").mkdir(parents=True, exist_ok=True)
        rc |= bench_main(["run", "--quick", "--backend", args.backend,
                          "--device", args.device, "--force", "--out",
                          str(ROOT / "artifacts" / "torch" /
                              "bench_quick.json")])
    if want("fig2"):
        print("\n## fig2/5/6: hierarchy sweep x instruction mix "
              f"({args.device} measured)")
        from benchmarks_torch import fig2_hierarchy
        fig2_hierarchy.main(quick=quick, **dev)
    if want("fig1"):
        print("\n## fig1: addressing-mode / stream-count overhead")
        from benchmarks_torch import fig1_addressing
        fig1_addressing.main(quick=quick, **dev)
    if want("fig3"):
        print("\n## fig3: block-shape (registers-per-load) sweep")
        from benchmarks_torch import fig3_blockshape
        fig3_blockshape.main(quick=quick, **dev)
    if want("fig4"):
        print("\n## fig4: device scaling + STREAM triad (subprocess)")
        rc |= _subproc("benchmarks_torch.fig4_scaling", quick, args.device)
    if want("fig5"):
        print("\n## fig5: R:W-ratio sweep, store-path attribution (rw family)")
        from benchmarks_torch import fig5_rw_ratio
        fig5_rw_ratio.main(quick=quick, **dev)
    if want("fig6"):
        print("\n## fig6: instruction-stream classification "
              "(bandwidth- vs issue-bound)")
        from benchmarks_torch import fig6_istream
        fig6_istream.main(quick=quick, device=args.device)
    if want("fig7"):
        print("\n## fig7: loaded-latency surface (bandwidth-latency curves)")
        from benchmarks_torch import fig7_loaded_latency
        fig7_loaded_latency.main(quick=quick, **dev)
    if want("collectives"):
        print("\n## collectives: collective throughput on a process mesh "
              "(subprocess)")
        if args.device == "cpu":
            mesh = "2x4"
        else:
            import torch
            mesh = f"1x{torch.cuda.device_count()}"
        rc |= _subproc("benchmarks_torch.collective_bench_main", quick,
                       args.device, "--mesh", mesh)
    if want("roofline"):
        print("\n## roofline: the dry-run table (reads artifacts/torch/"
              "dryrun, artifacts/torch/probe)")
        from benchmarks_torch import roofline_table
        rc |= roofline_table.main()
    if want("table1"):
        print("\n## table1: machine models (documented vs measured)")
        from benchmarks_torch import table1_machine
        table1_machine.main(quick=quick, device=args.device)
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
