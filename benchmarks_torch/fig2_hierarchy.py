"""Fig 2/5/6 — memory-hierarchy throughput sweep under instruction mixes.

Counterpart of ``benchmarks/fig2_hierarchy.py`` on the port: the same
BenchSpec declaration, run by the port's Runner on one device — on CUDA the
card's L2 and HBM, measured through the hand-written kernels (``cuda``) or
the oracles (``torch``).  The per-level table and mix-penalty ratios (the
paper's FADD 69% / NOP 88% / LOAD 99% analysis) come from
``core.analysis`` against the device's levels: ``detect_device`` on a CUDA
device (the L2 and the device memory, named ``DRAM``), ``detect_host`` on
the CPU.

Results go under ``artifacts/torch/`` (``fig2_sweep.json``,
``machine_model_<cuda|cpu>.json``), never over the reference's files.

    PYTHONPATH=src:. python -m benchmarks_torch.fig2_hierarchy --quick
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from benchmarks_torch.common import add_device_flags, emit
from repro_torch.bench import BenchSpec, Runner
from repro_torch.core import analysis
from repro_torch.core.buffers import hierarchy_grid
from repro_torch.core.machine_model import detect_device, detect_host

ART = Path(__file__).resolve().parents[1] / "artifacts" / "torch"


def spec_for(quick: bool, backend: str = "cuda") -> BenchSpec:
    if quick:
        return BenchSpec(
            mixes=("load_sum", "copy", "fma_8"),
            sizes=hierarchy_grid(quick=True),
            reps=5, warmup=2, target_bytes=5e7, backend=backend)
    return BenchSpec(
        mixes=("load_sum", "copy", "fma_2", "fma_8", "fma_32"),
        sizes=hierarchy_grid(),
        reps=10, warmup=2, target_bytes=2e8, backend=backend)


def row_name(mix: str, nbytes: int) -> str:
    return f"fig2/{mix}/{nbytes}B"


def levels_of(device):
    """The hierarchy the sweep is attributed to: the card's on CUDA, the
    host's on the CPU."""
    dev = torch.device(device)
    return detect_device(dev) if dev.type == "cuda" else detect_host()


def model_path(device) -> Path:
    return ART / f"machine_model_{torch.device(device).type}.json"


def main(quick: bool = False, backend: str = "cuda", device: str = "cuda"):
    runner = Runner(device=device)          # raises without a CUDA device
    res = runner.run(spec_for(quick, backend))
    model = analysis.build_machine_model(res, levels_of(runner.device))

    ART.mkdir(parents=True, exist_ok=True)
    res.to_json(ART / "fig2_sweep.json")
    model.to_json(model_path(runner.device))

    for p in res.points:
        emit(row_name(p.mix, p.nbytes), p.mean_s * 1e6,
             f"{p.gbps:.2f}GB/s")
    print()
    print(analysis.format_table(model.level_bw, model.mix_penalty))
    if model.ridge_flops_per_byte:
        print(f"\nmeasured ridge point: "
              f"{model.ridge_flops_per_byte:.1f} flop/B")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    add_device_flags(ap)
    main(**vars(ap.parse_args()))
