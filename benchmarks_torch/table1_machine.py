"""Table 1 — system specification table: documented peaks (the paper's
systems and the port's target card) vs what this harness measures.

Counterpart of ``benchmarks/table1_machine.py`` on the port.  Where the
reference prints its TPU target, this prints the H100 SXM's data sheet
(``H100_SXM``), then the paper's A64FX, Altra and ThunderX2, then the
measured device: ``detect_device`` on CUDA (its L2 and device memory), with
the level bandwidths of fig2's model (``artifacts/torch/``); on the CPU
``detect_host``.

    PYTHONPATH=src:. python -m benchmarks_torch.table1_machine
"""
from __future__ import annotations

import argparse
import json

from benchmarks_torch.common import add_device_flags, emit
from benchmarks_torch.fig2_hierarchy import levels_of, model_path
from repro_torch.core.device import resolve_device
from repro_torch.core.machine_model import A64FX, ALTRA, H100_SXM, THUNDERX2


def show(hw, measured=None):
    print(f"\n## {hw.name}")
    if hw.frequency_hz:
        print(f"  frequency: {hw.frequency_hz/1e9:.1f} GHz")
    if hw.peak_flops:
        print(f"  peak compute: {hw.peak_flops/1e12:.1f} TFLOP/s")
    for lvl in hw.levels:
        size = f"{lvl.size_bytes/2**10:.0f} KiB" if lvl.size_bytes and \
            lvl.size_bytes < 2**20 else \
            (f"{lvl.size_bytes/2**20:.0f} MiB" if lvl.size_bytes else "-")
        bw = f"{lvl.read_bw/1e9:.1f} GB/s" if lvl.read_bw else "undocumented"
        meas = ""
        if measured and lvl.name in measured:
            best = max(measured[lvl.name].values())
            meas = f"  measured(best mix): {best:.1f} GB/s"
        print(f"  {lvl.name:6s} size={size:>9s}  documented={bw}{meas}")
    if hw.link_bw:
        print(f"  interconnect: {hw.link_bw/1e9:.0f} GB/s per link")
    if hw.notes:
        print(f"  notes: {hw.notes}")


ROW = "table1/systems"


def main(quick: bool = False, device: str = "cuda"):
    dev = resolve_device(device)            # raises without a CUDA device
    measured = None
    mm_path = model_path(dev)
    if mm_path.exists():
        measured = json.loads(mm_path.read_text()).get("level_bw")
    for hw in (H100_SXM, A64FX, ALTRA, THUNDERX2):
        show(hw)
    show(levels_of(dev), measured)
    emit(ROW, 0.0,
         "5 systems (3 paper + h100 target + measured device)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    add_device_flags(ap, backend=None)
    main(**vars(ap.parse_args()))
