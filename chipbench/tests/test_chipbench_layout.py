"""The benchmark's layout: nothing under ``chipbench/`` imports JAX or the
JAX package (top-level names compared whole), the harness finds every
configuration, traffic mix, reader, reference, count and limit by name,
and ``BENCHMARK.json`` keeps to its contract's names and ranges."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from chipbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(harness.BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_imported(path):
    assert not _imports(path) & set(harness.BARRED)


def test_whole_name_comparison():
    assert harness.BARRED == ("jax", "jaxlib", "flax", "repro")
    assert "repro_torch" not in harness.BARRED


def test_the_programs_imports_hold_no_jax():
    """What a run imports before its window, in a process of its own."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src'];"
            "import chipbench.harness as h, chipbench.check,"
            " chipbench.loops.prefill, repro_torch.models.registry,"
            " repro_torch.launch.serve, repro_torch.distributed.sharding,"
            " repro_torch.kernels.flash_attention.flash_attention;"
            "print(h.barred_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    import importlib
    c = harness.cell(BENCH, workload)
    assert callable(importlib.import_module(
        f"chipbench.loops.{c['traffic']['kind']}").measure)
    fam = c["arch"]["family"]
    assert importlib.import_module(f"chipbench.reference.{fam}").forward
    assert harness.counts(fam).model_flops
    for kernel in harness.counts(fam).launches(c["arch"], 1, 1):
        assert callable(importlib.import_module(
            f"chipbench.counts.{kernel}").launched)
    assert set(c["limits"]) == {"token_gap", "logit_err", "cache_err"}
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config",
                                                           "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    assert {m["source"] for m in BENCH["end_to_end"]} <= {"host_clock",
                                                           "device_trace"}


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    assert {w["config"] for w in BENCH["workloads"]} == \
        {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("chipbench/")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        ends = [m for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        layers = [m for m in BENCH["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:
            assert m["moves"] in {e["name"] for e in ends}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_run_refuses_without_a_card(tmp_path):
    """Here, with no CUDA device: a non-zero exit and no result."""
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2 ** 33 + 1),
         "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
