"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX reference package ``repro``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # a relative import stays in the package
                continue
            yield node.module or "", node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value), node.lineno


def test_the_port_has_the_slice_modules():
    have = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES[:-1]}
    for want in ("bench/mixes.py", "bench/spec.py", "bench/result.py",
                 "bench/backends.py", "bench/runner.py", "bench/cli.py",
                 "bench/__main__.py", "core/buffers.py", "core/timing.py",
                 "core/instruction_mix.py", "obs/trace.py", "obs/metrics.py",
                 "obs/ledger.py", "kernels/membench/membench.py",
                 "kernels/membench/ops.py", "kernels/membench/ref.py",
                 "convert.py"):
        assert want in have, want
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "membench" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == \
        {"acc.cu", "mxu.cu", "copy.cu", "triad.cu"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_reference(path):
    bad = [(mod, line) for mod, line in _imports(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


def test_bench_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"       # import of a None entry raises
        "import repro_torch.bench, repro_torch.bench.cli\n"
        "import repro_torch.bench.runner, repro_torch.bench.backends\n"
        "import repro_torch.kernels.membench.ops, repro_torch.convert\n"
        "import repro_torch.obs, repro_torch.core.instruction_mix\n"
        "from repro_torch.bench import Runner, BenchSpec\n"
        "r = Runner(device='cpu').run(BenchSpec(mixes=('load_sum',),\n"
        "    sizes=(4096,), backend='cuda', reps=1, warmup=0))\n"
        "assert len(r.points) == 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_nothing_is_built_at_import():
    from repro_torch.kernels.membench import membench as mb
    assert mb._libs == {}
    assert all(v == 0 for v in mb.launch_counts.values())   # no card here
    assert (mb.CSRC / "membench_common.cuh").exists()
