"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, metric or
model family lives in files of its own, found by name:

- ``chipbench/configs/<config>.json``: the configuration as it is run
  (``arch``: the program's ``ArchConfig`` fields) with its source;
- ``chipbench/traffic/<traffic>.json``: the mix's parameters; its
  ``kind`` names the loop module ``chipbench/loops/<kind>.py``;
- ``chipbench/loops/<kind>.py``: its ``measure`` builds the cell, runs
  the window and keeps the sample that its ``compare`` holds against the
  reference;
- ``chipbench/metrics/<metric>.py``: a reader, ``read(run)`` -> a number,
  or None where it finds nothing to read;
- ``chipbench/reference/<family>.py``: the plain float32 forward pass;
- ``chipbench/counts/model_<family>.py``: model FLOPs and the hand-written
  kernels' launches of a prefill; ``counts/<kernel>.py`` a launch's work
  and the program's launch counter;
- ``chipbench/limits/<workload>.json``: the limits of the comparison.

The run prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number the
comparison read beside its limit (also the last lines of standard error).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

#: the checkout's root: chipbench/harness.py -> ..
ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "chipbench"
#: modules the process may not hold once the window has closed, by whole
#: top-level name
BARRED = ("jax", "jaxlib", "flax", "repro")


def cache_env() -> dict:
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX loaded by a library on the program's behalf."""
    build = ROOT / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "CUDA_CACHE_PATH": str(build / "cuda_cache"),
            "USE_FLAX": "0"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(spec: dict, workload: str) -> dict:
    """The workload entry, its configuration entry, the configuration's
    ``arch``, its traffic, its limits and its metrics."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(by_name)}")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    arch = load_json(ROOT / conf["file"])["arch"]
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH / "limits" / f"{workload}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() \
        else None

    def mine(m):
        return workload in m.get("workloads", [workload])
    return {"workload": w, "arch": arch, "traffic": traffic,
            "limits": limits,
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def load_module(directory: str, name: str):
    """``chipbench/<directory>/<name>.py`` as a module (a name may hold
    dots and dashes)."""
    path = BENCH / directory / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench.{directory}._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    return load_module("metrics", name)


def counts(family: str):
    return importlib.import_module(f"chipbench.counts.model_{family}")


@dataclass
class Run:
    """What a metric reader reads: the cell's configuration (``arch``) and
    traffic, the set-up seconds, the window's length asked for, and what
    the cell's loop left of its window."""
    arch: dict
    traffic: dict
    setup_s: float
    seconds: float
    window: object

    @property
    def counts(self):
        return counts(self.arch["family"])


def barred_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BARRED))


def metric_value(m: dict, run: Run):
    v = reader(m["name"]).read(run)
    return None if v is None else {"value": v, "unit": m["unit"]}


def judge(numbers: dict, limits: dict) -> bool:
    """True where the comparison read every limited number, each finite
    and within its limit."""
    return all(k in numbers and numbers[k] == numbers[k]
               and numbers[k] <= limit for k, limit in limits.items())


def execute(workload: str, seed: int, seconds: float, trace: bool, t_start,
            device=None, arch_override=None, traffic_override=None) -> dict:
    """One run of ``workload``; returns the result object. The loop
    ``chipbench/loops/<kind>.py`` of the cell's traffic does set-up, the
    window and the comparison (its ``measure``). ``device`` None means the
    card (checked by the caller); the overrides let a test drive the same
    run on the CPU at a small size."""
    import torch

    c = cell(bench(), workload)
    arch = arch_override or c["arch"]
    traffic = traffic_override or c["traffic"]
    limits = c["limits"]
    if limits is None:
        raise SystemExit(f"no limits for {workload}: chipbench/limits/"
                         f"{workload}.json")
    device = device or torch.device("cuda", 0)
    loop = importlib.import_module(f"chipbench.loops.{traffic['kind']}")
    m = loop.measure(arch, traffic, seed, seconds, trace, t_start, device)
    w = m.window
    run = Run(arch=arch, traffic=traffic, setup_s=m.setup_s,
              seconds=seconds, window=w)
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    metrics = {}
    for spec in (c["per_layer"] if trace else c["end_to_end"]):
        v = metric_value(spec, run)
        if v is not None:
            metrics[spec["name"]] = v
    result = {"correct": False, "attempted": m.attempted, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": memory_peak}}
    if trace and w.trace is not None and w.trace.serve:
        from chipbench import trace as tr
        a, b = w.trace.window()
        result["device"]["busy_s"] = tr.total(w.trace.busy([(a, b)]))
        result["device"]["window_s"] = b - a
        result["breakdown"] = tr.breakdown(w.trace, w.trace.serve)
    # the comparison, after the window and the peak
    t = time.perf_counter()
    got = m.compare()
    m.notes["comparison_s"] = round(time.perf_counter() - t, 3)
    result["correct"] = judge(got, limits)
    result["checks"] = {k: {"value": got.get(k), "limit": v}
                        for k, v in limits.items()}
    result["notes"] = m.notes     # for standard error, not the result line
    return result


def parse(argv):
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start) -> int:
    args = parse(argv)
    import torch

    chips = cell(bench(), args.workload)["workload"]["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA device(s); "
              f"{seen} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    import repro_torch
    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        print(f"chipbench: repro_torch comes from {repro_torch.__file__}, "
              f"not from this checkout's src/", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start)
    barred = barred_modules()
    if barred:
        print(f"chipbench: the process holds {barred} after the window",
              file=sys.stderr)
        return 3
    for k, v in result.pop("notes").items():
        print(f"chipbench: {k} {v}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
