"""Characterization report — the paper's §5-§6 narrative as markdown/JSON.

Renders one FittedMachineModel (+ the adaptive sweep that produced it) as:
level table with capacity brackets and per-mix bandwidth CIs, mix-penalty
ratios, measured ridge point, sysfs-prior cross-check, measured-vs-documented
comparison (the Table-1 deltas), and the sweep economics (adaptive points vs
the dense grid the same resolution would have cost).

Counterpart of ``repro.characterize.report``: the same headings and layout.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.characterize.fit import FittedMachineModel
from repro_torch.core.machine_model import HardwareSpec


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if n >= div:
            return f"{n / div:.1f} {unit}".replace(".0 ", " ")
    return f"{n} B"


def _fmt_ci(ci) -> str:
    if not ci:
        return "-"
    return f"[{ci[0]:.1f}, {ci[1]:.1f}]"


def render_markdown(model: FittedMachineModel, sweep=None,
                    documented: HardwareSpec | None = None) -> str:
    lines = [f"# Machine characterization: `{model.name}`", ""]
    prov = model.provenance
    if prov.get("backend"):
        lines.append(f"backend: `{prov['backend']}` · "
                     f"points: {prov.get('source_points', '?')}")
        lines.append("")

    lines += ["## Detected hierarchy (measurement only — no sysfs, no docs)",
              "",
              "| level | capacity | bracket | best mix | GB/s | CI |",
              "|---|---|---|---|---|---|"]
    for l in model.levels:
        br = (f"{_fmt_bytes(l.capacity_ci[0])} … {_fmt_bytes(l.capacity_ci[1])}"
              if l.capacity_ci else "-")
        best = l.best_mix
        cell = l.bandwidth.get(best) if best else None
        lines.append(
            f"| {l.name} | {_fmt_bytes(l.capacity_bytes)} | {br} "
            f"| {best or '-'} | {cell['gbps']:.2f} "
            f"| {_fmt_ci(cell.get('ci'))} |" if cell else
            f"| {l.name} | {_fmt_bytes(l.capacity_bytes)} | {br} | - | - | - |")
    lines.append("")

    if model.mix_penalty:
        lines += ["## Per-level instruction-mix bandwidth (GB/s, rel to best)",
                  ""]
        mixes: list[str] = []
        for cells in (l.bandwidth for l in model.levels):
            mixes.extend(m for m in cells if m not in mixes)
        lines.append("| level | " + " | ".join(mixes) + " |")
        lines.append("|---|" + "---|" * len(mixes))
        for l in model.levels:
            row = [l.name]
            for m in mixes:
                c = l.bandwidth.get(m)
                rel = model.mix_penalty.get(l.name, {}).get(m)
                row.append(f"{c['gbps']:.1f} ({rel:.2f})" if c else "-")
            lines.append("| " + " | ".join(row) + " |")
        lines.append("")

    if model.ridge_flops_per_byte:
        lines += [f"measured ridge point: "
                  f"**{model.ridge_flops_per_byte:.1f} flop/B**", ""]

    if sweep is not None:
        s = sweep.summary() if hasattr(sweep, "summary") else sweep
        lines += ["## Sweep economics (adaptive vs dense)",
                  "",
                  f"- rounds: {s['rounds']}, measured sizes: {s['n_points']}",
                  f"- dense grid at the same {s['resolution']:.0%} boundary "
                  f"resolution: ~{s['dense_equivalent']} sizes "
                  f"({s['n_points'] / max(s['dense_equivalent'], 1):.0%} "
                  f"of the samples)",
                  f"- converged: {s['converged']}", ""]

    if model.sysfs_prior and model.sysfs_prior.get("checks"):
        lines += ["## sysfs prior cross-check (prior ONLY — detection is "
                  "authoritative)", "",
                  "| prior level | size | inside measured bracket? | note |",
                  "|---|---|---|---|"]
        for c in model.sysfs_prior["checks"]:
            if c["within_bracket"]:
                note = f"bracket {_fmt_bytes(c['bracket'][0])} … " \
                       f"{_fmt_bytes(c['bracket'][1])}"
            elif c.get("nearest_detected"):
                note = f"nearest detected {_fmt_bytes(c['nearest_detected'])}" \
                       f" ({c['ratio']:.2f}x)"
            else:
                note = "no boundary detected"
            lines.append(f"| {c['prior']} | {_fmt_bytes(c['size_bytes'])} "
                         f"| {'yes' if c['within_bracket'] else 'NO'} "
                         f"| {note} |")
        lines.append("")

    if documented is not None:
        cmp = model.compare_to(documented)
        lines += [f"## Measured vs documented: `{documented.name}` "
                  f"(the paper's Table-1 deltas)", "",
                  f"levels: detected {cmp['n_detected']} vs documented "
                  f"{cmp['n_documented']}", "",
                  "| detected | documented | capacity (meas/doc) | "
                  "BW GB/s (meas/doc) |",
                  "|---|---|---|---|"]
        for r in cmp["levels"]:
            capc = (f"{_fmt_bytes(r['capacity_bytes'])} / "
                    f"{_fmt_bytes(r['documented_bytes'])} "
                    f"({r['capacity_ratio']:.2f}x)"
                    if "capacity_ratio" in r else "-")
            bwc = (f"{r['gbps']:.1f} / {r['documented_gbps']:.1f} "
                   f"({r['bw_ratio']:.2f}x)" if "bw_ratio" in r else "-")
            lines.append(f"| {r['detected'] or '-'} | {r['documented'] or '-'} "
                         f"| {capc} | {bwc} |")
        lines.append("")
    return "\n".join(lines)


def render_json(model: FittedMachineModel, sweep=None,
                documented: HardwareSpec | None = None) -> dict:
    out = {"model": model.to_dict()}
    if sweep is not None:
        out["sweep"] = sweep.summary() if hasattr(sweep, "summary") else sweep
    if documented is not None:
        out["compare"] = model.compare_to(documented)
    return out


def write_report(model: FittedMachineModel, path: str | Path, sweep=None,
                 documented: HardwareSpec | None = None) -> Path:
    path = Path(path)
    if path.suffix == ".json":
        path.write_text(json.dumps(render_json(model, sweep, documented),
                                   indent=2))
    else:
        path.write_text(render_markdown(model, sweep, documented))
    return path
