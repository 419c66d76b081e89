"""The port stands alone: no module of ``src/repro_torch``, no figure
script of ``benchmarks_torch/``, no script of ``scripts_torch/`` or
``examples_torch/`` and not ``chip_smoke.py`` imports ``jax``, the JAX
reference package ``repro`` or the reference's ``benchmarks``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
#: the port's diagnostic scripts, figure scripts and launcher (they import
#: torch, numpy and the port only)
TOOLS = sorted((ROOT / "tools").glob("*.py"))
FIGURES = sorted((ROOT / "benchmarks_torch").glob("*.py")) \
    + sorted((ROOT / "scripts_torch").glob("*.py")) \
    + sorted((ROOT / "examples_torch").glob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "repro", "benchmarks"}


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
                 "characterize/loaded.py", "characterize/detect.py",
                 "characterize/adaptive.py", "characterize/fit.py",
                 "characterize/report.py", "core/machine_model.py",
                 "core/analysis.py", "core/sweep.py", "core/autotune.py",
                 "convert.py", "kernels/build.py",
                 "configs/base.py", "configs/zamba2_2p7b.py",
                 "configs/__init__.py", "models/common.py",
                 "models/variant.py", "models/attention.py", "models/ssm.py",
                 "models/hybrid.py", "models/registry.py",
                 "kernels/flash_attention/flash_attention.py",
                 "kernels/flash_attention/ops.py",
                 "kernels/flash_attention/ref.py",
                 "kernels/ssd_scan/ssd_scan.py", "kernels/ssd_scan/ops.py",
                 "kernels/ssd_scan/ref.py", "launch/serve.py",
                 "istream/__init__.py", "istream/extract.py",
                 "istream/emulate.py", "istream/analyze.py",
                 "istream/classify.py", "audit/__init__.py",
                 "audit/verify.py", "audit/ecm.py", "bench/distributed.py",
                 "core/scaling.py", "core/device.py",
                 "core/collective_bench.py", "launch/mesh.py",
                 "ft/__init__.py", "ft/stragglers.py",
                 "models/transformer.py", "configs/granite_3_2b.py",
                 "configs/stablelm_3b.py", "configs/internlm2_20b.py",
                 "configs/phi3_medium_14b.py", "configs/chameleon_34b.py",
                 "configs/mamba2_2p7b.py", "configs/whisper_medium.py",
                 "configs/arctic_480b.py", "configs/deepseek_v2_236b.py",
                 "models/ssm_lm.py", "models/encdec.py", "models/moe.py",
                 "models/mla.py", "optim/adamw.py", "optim/compression.py",
                 "data/pipeline.py", "checkpoint/checkpoint.py",
                 "train/step.py", "train/trainer.py", "launch/train.py",
                 "distributed/__init__.py", "distributed/sharding.py",
                 "serve/__init__.py", "serve/flash_decode.py",
                 "roofline/__init__.py", "roofline/analyze.py",
                 "roofline/model_bytes.py", "launch/dryrun.py",
                 "launch/probe.py"):
        assert want in have, want
    kernels = ROOT / "src" / "repro_torch" / "kernels"
    for package, sources in (
            ("membench", {"acc.cu", "mxu.cu", "copy.cu", "triad.cu", "rw.cu",
                          "chase.cu"}),
            ("flash_attention", {"flash_attn.cu"}),
            ("ssd_scan", {"ssd_scan.cu"})):
        assert {p.name for p in (kernels / package / "csrc").glob("*.cu")} \
            == sources, package


def test_the_port_has_the_figure_scripts():
    """Every script of ``benchmarks/`` that the port runs has its
    counterpart of the same name; ``scripts/launch_distributed.py`` too."""
    have = {p.name for p in FIGURES}
    for want in ("common.py", "fig1_addressing.py", "fig2_hierarchy.py",
                 "fig3_blockshape.py", "fig4_scaling.py", "fig5_rw_ratio.py",
                 "fig6_istream.py", "fig7_loaded_latency.py",
                 "table1_machine.py", "run.py", "launch_distributed.py",
                 "collective_bench_main.py", "characterize_machine.py",
                 "serve_lm.py", "train_lm.py", "quickstart.py",
                 "roofline_table.py", "gen_experiments.py"):
        assert want in have, want
        assert any((ROOT / d / want).exists()
                   for d in ("benchmarks", "scripts", "examples")), want


@pytest.mark.parametrize("path", FILES + TOOLS + FIGURES,
                         ids=lambda p: str(p.relative_to(ROOT)))
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
        "import repro_torch.characterize\n"
        "import repro_torch.core.analysis, repro_torch.core.autotune\n"
        "import repro_torch.istream, repro_torch.audit\n"
        "import repro_torch.core.sweep, repro_torch.core.machine_model\n"
        "import repro_torch.launch.serve, repro_torch.models.hybrid\n"
        "import repro_torch.bench.distributed, repro_torch.core.scaling\n"
        "import repro_torch.core.collective_bench, repro_torch.launch.mesh\n"
        "import repro_torch.ft.stragglers, repro_torch.models.transformer\n"
        "import repro_torch.models.registry, repro_torch.train.trainer\n"
        "import repro_torch.launch.train, repro_torch.optim.compression\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.serve.flash_decode\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.probe\n"
        "import repro_torch.roofline.analyze\n"
        "from repro_torch.bench import Runner, BenchSpec\n"
        "from repro_torch.characterize import characterize\n"
        "m, s = characterize(('copy', 'load_sum'), primary='copy',\n"
        "    runner=Runner(device='cpu'), backend='cuda', register=False,\n"
        "    lo=16384, hi=65536, max_rounds=1, reps=1, target_bytes=1e5)\n"
        "assert m.schema_version == 3 and m.levels\n"
        "r = Runner(device='cpu').run(BenchSpec(mixes=('load_sum',),\n"
        "    sizes=(4096,), backend='cuda', reps=1, warmup=0))\n"
        "assert len(r.points) == 1\n"
        "r = Runner(device='cpu').run(BenchSpec(mixes=('latency_chase',),\n"
        "    sizes=(4096,), backend='cuda', reps=1, warmup=0, load=1))\n"
        "assert r.points[0].latency_ns > 0\n"
        "from repro_torch.core.scaling import scaling_curve\n"
        "pts = scaling_curve(4096, device_counts=[1], passes=1, reps=1,\n"
        "    runner=Runner(device='cpu'))\n"
        "assert pts[0].devices == 1 and pts[0].speedup == 1.0\n"
        "import dataclasses, torch\n"
        "from repro_torch.configs import get_arch, reduced\n"
        "from repro_torch.models.common import init_params\n"
        "from repro_torch.models.registry import build\n"
        "from repro_torch.models.variant import BASELINE\n"
        "cfg = reduced(get_arch('zamba2-2.7b'))\n"
        "m = build(cfg)\n"
        "p = init_params(m.param_specs(), torch.Generator().manual_seed(0))\n"
        "toks = torch.zeros((1, 32), dtype=torch.int64)\n"
        "v = dataclasses.replace(BASELINE, use_pallas=True)\n"
        "logits, cache = m.prefill(p, toks, None, v)\n"
        "assert logits.shape == (1, 512) and bool(logits.isfinite().all())\n"
        "from repro_torch.distributed.sharding import make_smoke_ctx\n"
        "from repro_torch.train.step import make_decode_step\n"
        "from repro_torch.launch.serve import pad_cache\n"
        "cache = pad_cache(cfg, cache, 1, 32, 1)\n"
        "lg, _ = make_decode_step(cfg, make_smoke_ctx(), BASELINE, True)(\n"
        "    p, cache, {'tokens': toks[:, :1]}, 32)\n"
        "assert bool(lg.isfinite().all())\n"
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
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.membench import membench as mb
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    assert mb._libs == {}
    assert all(v == 0 for v in mb.launch_counts.values())   # no card here
    assert (mb.CSRC / "membench_common.cuh").exists()
    for lib, counts in ((fa.LIBRARY, fa.launch_counts),
                        (sk.LIBRARY, sk.launch_counts)):
        assert lib.libs == {} and all(v == 0 for v in counts.values())
        assert all((lib.csrc / src).exists() for src in lib.entries)
        # one output directory for every kernel package: build/<package>
        assert lib.build_dir == mb.LIBRARY.build_dir.parent / lib.name
