"""Generate the data-driven tables of the port's dry run and roofline from
``artifacts/torch/`` (counterpart of ``scripts/gen_experiments.py``).

    PYTHONPATH=src:. python scripts_torch/gen_experiments.py [variant]

Reads the records of ``repro_torch.launch.dryrun`` and ``launch.probe``:
the dry-run table here, the roofline table by
``benchmarks_torch.roofline_table``'s own ``load`` and ``render``.  Every
number is counted on the CPU with the H100's data-sheet constants
(``repro_torch.roofline.analyze``), none measured on a card.
"""
import sys

from benchmarks_torch.roofline_table import load, render


def dryrun_table(rows) -> str:
    hdr = ("| arch | shape | mesh | status | trace s | peak GiB/dev | fits "
           "80 GB | collectives (count) |")
    out = [hdr, "|" + "---|" * 8]
    for d in sorted(rows, key=lambda r: (r["arch"], r["shape"],
                                         r.get("multi_pod", False))):
        arch, shape = d["arch"], d["shape"]
        mesh = "2x16x16" if d.get("multi_pod") else "16x16"
        if d["status"] == "skipped":
            out.append(f"| {arch} | {shape} | {mesh} | skipped "
                       f"(sub-quadratic-only shape) | - | - | - | - |")
            continue
        if d["status"] != "ok":
            out.append(f"| {arch} | {shape} | {mesh} | **ERROR** | - | - | - "
                       f"| {d['error'][:40]} |")
            continue
        colls = d.get("collective_breakdown", {})
        cstr = ", ".join(f"{k}x{v['count']}" for k, v in sorted(colls.items()))
        out.append(
            f"| {arch} | {shape} | {mesh} | ok | {d.get('trace_s', '-')} "
            f"| {d['peak_device_bytes'] / 2**30:.2f} "
            f"| {'yes' if d.get('fits_hbm') else 'NO'} | {cstr} |")
    return "\n".join(out)


if __name__ == "__main__":
    rows = load(sys.argv[1] if len(sys.argv) > 1 else "baseline")
    print("### Dry-run table\n")
    print(dryrun_table(rows))
    print("\n### Roofline table\n")
    print(render(rows))
