"""Roofline table — renders the port's dry-run and probe records
(``artifacts/torch/{dryrun,probe}/*.json``) as markdown (counterpart of
``benchmarks/roofline_table.py``).

One row per (arch x shape x mesh): the three roofline terms at the H100's
data-sheet constants (``repro_torch.roofline.analyze``), the dominant
term, MODEL_FLOPS over the counted FLOPs, the peak a GPU holds and whether
it fits the card's 80 GB.  Counted on the CPU, not measured on a card:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.probe --mesh both
    PYTHONPATH=src:. python -m benchmarks_torch.roofline_table --mesh pod1
"""
from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

from benchmarks_torch.common import emit

ART = Path(__file__).resolve().parents[1] / "artifacts" / "torch" / "dryrun"
PROBE = Path(__file__).resolve().parents[1] / "artifacts" / "torch" / "probe"

MESHES = {"pod1": (False,), "pod2": (True,), "both": (False, True)}


def load(variant: str = "baseline", mesh: str = "both"):
    """Prefer probe records (the composed parts, checked against the whole)
    for the roofline terms; merge the dry run's memory fields (fit
    proof), its trace time and its collective breakdown."""
    rows = []
    for f in sorted(glob.glob(str(ART / f"*__{variant}.json"))):
        d = json.loads(Path(f).read_text())
        if d.get("multi_pod", False) not in MESHES[mesh]:
            continue
        p = PROBE / Path(f).name
        if p.exists():
            pd = json.loads(p.read_text())
            if pd.get("status") == "ok":
                keep = {k: d.get(k) for k in ("peak_device_bytes", "fits_hbm",
                                              "arg_bytes",
                                              "sharding_fallbacks", "trace_s",
                                              "collective_breakdown")}
                d = {**d, **pd, **{k: v for k, v in keep.items()
                                   if v is not None}}
        rows.append(d)
    return rows


def render(rows, show_skips=False):
    hdr = ("| arch | shape | mesh | t_comp (s) | t_mem (s) | t_coll (s) | "
           "dominant | useful_flops | peak GiB | fits 80 GB |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    for r in rows:
        mesh = "2x16x16" if r.get("multi_pod") else "16x16"
        if r["status"] == "skipped":
            if show_skips:
                out.append(f"| {r['arch']} | {r['shape']} | {mesh} | - | - | - "
                           f"| skipped | - | - | - |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {mesh} | ERROR: "
                       f"{r['error'][:40]} | | | | | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {mesh} "
            f"| {r['t_compute_s']:.4f} | {r['t_memory_s']:.4f} "
            f"| {r['t_collective_s']:.4f} | **{r['dominant']}** "
            f"| {r.get('useful_flop_ratio', 0):.2f} "
            f"| {r['peak_device_bytes'] / 2**30:.2f} "
            f"| {'Y' if r.get('fits_hbm') else 'N'} |")
    return "\n".join(out)


def main(variant: str = "baseline", mesh: str = "both") -> int:
    """Print the table (a note where there is no record yet); 1 where a
    cell is an error."""
    rows = load(variant, mesh)
    if not rows:
        print(f"# no dry-run records for variant {variant} under {ART}: "
              f"run python -m repro_torch.launch.dryrun first")
    print(render(rows, show_skips=True))
    ok = [r for r in rows if r["status"] == "ok"]
    errors = [r for r in rows if r["status"] not in ("ok", "skipped")]
    emit("roofline/cells", 0.0,
         f"{len(ok)} traced cells, {len(errors)} errors, variant={variant}")
    return 1 if errors else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--mesh", choices=sorted(MESHES), default="both")
    raise SystemExit(main(**vars(ap.parse_args())))
