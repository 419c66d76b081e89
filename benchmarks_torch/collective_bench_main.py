"""Collective throughput (all-reduce / all-gather / reduce-scatter /
all-to-all / ppermute) on a (data, model) mesh of processes — counterpart
of ``benchmarks/collective_bench_main.py``.

    python -m benchmarks_torch.collective_bench_main --device cpu  # 2x4 gloo
    python -m benchmarks_torch.collective_bench_main --mesh 1x4    # 4 GPUs

Where the reference forces 8 host devices in one process, the port starts
one process a mesh position with ``bench.distributed.launch_local``: gloo
processes on the CPU, one process a GPU on CUDA (NCCL between the cards).
Rank 0 prints one ``collectives/{op}/{axis}{n}`` row per op and axis of
two or more devices; a mesh with no such axis prints a line saying so and
measures nothing, as the reference's ``bench_all`` does.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from benchmarks_torch.common import add_device_flags, emit

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")


def parse_mesh(text: str) -> tuple[int, int]:
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh {text!r}: want DxM, e.g. 2x4") from None
    if d < 1 or m < 1:
        raise argparse.ArgumentTypeError(f"--mesh {text!r}: sizes must be "
                                         f">= 1")
    return d, m


class _Rank0Rows:
    """The launcher's sink: rank 0's lines on stdout without their ``[p0]``
    prefix, every other rank's on stderr as they come."""

    def write(self, line: str) -> None:
        if line.startswith("[p0] "):
            sys.stdout.write(line[5:])
        else:
            sys.stderr.write(line)

    def flush(self) -> None:
        sys.stdout.flush()
        sys.stderr.flush()


def worker(mesh_shape, quick: bool, device) -> int:
    """One rank: join the world, lay the mesh, measure, rank 0 prints."""
    from repro_torch.bench import distributed as dist
    from repro_torch.core.collective_bench import bench_all
    from repro_torch.launch.mesh import make_mesh
    dist.ensure_initialized(device)
    mesh = make_mesh(mesh_shape, AXES, device=device)
    res = bench_all(mesh, nbytes=(1 if quick else 8) * 2**20,
                    reps=4 if quick else 10)
    if dist.is_primary():
        if not res:
            print(f"# collectives: no axis of the {mesh_shape} mesh has two "
                  f"devices; nothing measured")
        for r in res:
            emit(f"collectives/{r.op}/{r.axis}{r.group_size}", r.mean_s * 1e6,
                 f"algo={r.algo_gbps:.2f}GB/s;link={r.link_gbps:.2f}GB/s")
    return 0


def main(quick: bool = False, mesh=(2, 4), device: str = "cuda") -> int:
    from repro_torch.bench import distributed as dist
    from repro_torch.core.device import resolve_device
    if dist.env_info()[0] is not None:      # a rank the launcher started
        return worker(mesh, quick, device)
    resolve_device(device)                  # raises without a CUDA device
    argv = [sys.executable, "-m", "benchmarks_torch.collective_bench_main",
            "--mesh", f"{mesh[0]}x{mesh[1]}", "--device", str(device)]
    argv += ["--quick"] if quick else []
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([path] if path else [])))
    return dist.launch_local(argv, processes=mesh[0] * mesh[1], env=env,
                             stream_to=_Rank0Rows(), device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--mesh", type=parse_mesh, default=(2, 4),
                    help="DxM processes over (data, model); default 2x4")
    add_device_flags(ap, backend=None)
    sys.exit(main(**vars(ap.parse_args())))
