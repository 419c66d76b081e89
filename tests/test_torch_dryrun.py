"""The dry run and the probe (``repro_torch.launch.dryrun``, ``launch.probe``)
on two production cells, each in a subprocess of its own (the fake world
of 256 ranks is process-wide): granite-3-2b x train_4k and phi3-medium-14b
x prefill_32k on the single-pod mesh (16, 16), as the rank of the last
``model`` coordinate; and two decode cells whose caches differ
(mamba2-2.7b x decode_32k, zamba2-2.7b x long_500k), status and parts.

- both records ``ok``, and the probe's parts composed equal to the dry
  run's whole step (FLOPs and collective bytes within 1 %);
- ``useful_flop_ratio`` in (0, 1.5], the reference's bound on its own
  (``tests/test_roofline.py``), and MODEL_FLOPS over the counted FLOPs;
- the parameters the rank holds equal the rules' bytes
  (``ShardCtx.layout``), float32 in training, bfloat16 in serving;
- ``sharding_fallbacks`` equal to the reference's resolution on the same
  mesh (``repro.distributed.sharding.ShardCtx`` on an ``AbstractMesh``) of
  every parameter, the batch and the attention's constraints;
- phi3's 40 heads over 16 fall back to the sequence: the rank's attention
  FLOPs at most (2n - 1) / n**2 of one device's (n = 16), not all of it;
- the CLI and the table: ``benchmarks_torch.roofline_table`` renders both
  records.

Measured on the CPU: granite train_4k useful_flop_ratio 0.41 (the
recompute of remat "full", 6 N against 8 N a token, the KV projections
every rank computes whole where 8 KV heads do not divide 16, and the
``masked`` attention's whole square), phi3 prefill_32k 0.54; phi3's
rank's attention forward (projections included) 0.0625 of one device's
(its 1 / 16 of the queries against every key, masked; 31 / 256 = 0.121
the bound).
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.distributed.sharding import ShardCtx as JShardCtx
from repro.models.common import logical_axes
from repro.models.registry import build as j_build
from repro.models.registry import input_abstract as j_input_abstract
from repro.models.variant import BASELINE as J_BASELINE
from repro.models.variant import apply_rules as j_apply_rules
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.models.common import spec_map
from repro_torch.models.registry import build, held_axes

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("granite-3-2b", "train_4k"), ("phi3-medium-14b", "prefill_32k")]
#: decode cells of the families whose caches differ: the SSM's (no
#: attention), the hybrid's sequence-sharded KV at batch 1
DECODE_CELLS = [("mamba2-2.7b", "decode_32k"), ("zamba2-2.7b", "long_500k")]
MESH = ((16, 16), ("data", "model"))

CELL = r"""
import sys
from pathlib import Path
from repro_torch.launch import dryrun, probe
arch, shape, out = sys.argv[1], sys.argv[2], Path(sys.argv[3])
rec = dryrun.run_cell(arch, shape, False, "baseline", force=True,
                      art=out / "dryrun")
assert rec["status"] == "ok", rec.get("traceback", rec)
rec = probe.run_cell(arch, shape, False, "baseline", force=True,
                     art=out / "probe", dryrun_dir=out / "dryrun")
assert rec["status"] in ("ok", "error"), rec.get("traceback", rec)
print("CELL_OK")
"""


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def _cell(arch, shape, out):
    r = subprocess.run([sys.executable, "-c", CELL, arch, shape, str(out)],
                       capture_output=True, text=True, env=_env(),
                       timeout=900)
    assert r.returncode == 0 and "CELL_OK" in r.stdout, r.stderr[-3000:]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    cells = CELLS + DECODE_CELLS
    with ThreadPoolExecutor(len(cells)) as ex:
        for f in [ex.submit(_cell, a, s, out) for a, s in cells]:
            f.result()
    name = "{}__{}__pod1__baseline.json"
    return out, {(a, s): (json.loads((out / "dryrun" / name.format(a, s))
                                     .read_text()),
                          json.loads((out / "probe" / name.format(a, s))
                                     .read_text()))
                 for a, s in cells}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "x".join(c))
def test_cell_is_ok_and_the_parts_compose_to_the_whole(records, cell):
    dry, probe = records[1][cell]
    assert dry["status"] == "ok" and dry["rank"] == 15
    assert dry["mesh"] == {"data": 16, "model": 16}
    assert dry["n_devices"] == 256
    assert probe["status"] == "ok", probe.get("error")
    assert probe["source"] == "probe"
    assert all(abs(v) <= 0.01 for v in probe["match"].values())
    assert probe["flops_counted"] == pytest.approx(dry["flops"], rel=1e-2)
    assert probe["hbm_bytes_upper"] > probe["hbm_bytes"]
    for rec in (dry, probe):
        assert 0 < rec["useful_flop_ratio"] <= 1.5
        assert rec["useful_flop_ratio"] == pytest.approx(
            rec["model_flops"] / rec["flops"])
    assert dry["fits_hbm"] and 0 < dry["peak_device_bytes"] <= 80 * 2**30


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "x".join(c))
def test_held_parameters_are_the_rules_bytes(records, cell):
    arch, shape = cell
    dry, _ = records[1][cell]
    cfg = get_arch(arch)
    dtype = None if shape.startswith("train") else torch.bfloat16
    tree = spec_map(lambda s: torch.empty(s.shape, dtype=dtype or s.dtype,
                                          device="meta"),
                    build(cfg).param_specs())
    ctx = sh.ShardCtx(sh.AbstractMesh(*MESH))
    rules = ctx.layout(tree, held_axes(cfg))
    assert dry["param_bytes"] == sum(r["bytes_a_rank"]
                                     for r in rules.values())


def _reference_fallbacks(arch: str, shape: str) -> set:
    """The reference's fallbacks on the mesh: every parameter, the batch,
    and the attention's ``_constrain_qkv`` dims (act_heads, and kv_heads
    or act_seq), as its dry run's tracing resolves them."""
    cfg = j_get_arch(arch)
    j = j_apply_rules(JShardCtx(JAbstractMesh(*MESH)), J_BASELINE)
    specs = j_build(cfg).param_specs()
    import jax
    for leaf, axes in zip(
            jax.tree.leaves(specs, is_leaf=lambda s: hasattr(s, "axes")),
            jax.tree.leaves(logical_axes(specs),
                            is_leaf=lambda t: isinstance(t, tuple))):
        j.spec(leaf.shape, axes)
    batch, axes = j_input_abstract(cfg, J_SHAPES[shape])
    for k, t in batch.items():
        j.spec(t.shape, axes[k])
    if j.resolve_dim("act_heads", cfg.n_heads) is not None:
        j.resolve_dim("kv_heads", cfg.n_kv_heads)
    else:
        j.resolve_dim("act_seq", J_SHAPES[shape].seq_len)
    return set(j.fallbacks)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "x".join(c))
def test_fallbacks_are_the_references(records, cell):
    dry, _ = records[1][cell]
    assert set(dry["sharding_fallbacks"]) == _reference_fallbacks(*cell)


@pytest.mark.parametrize("cell", DECODE_CELLS, ids=lambda c: "x".join(c))
def test_decode_cells_are_ok(records, cell):
    """The caches as the port's prefill hands them to the decode: an SSM
    layer's state at the rank's SSD heads, the hybrid's KV sequence-sharded
    over ``data`` at batch 1; the probe's parts equal the whole."""
    dry, probe = records[1][cell]
    assert dry["status"] == "ok" and probe["status"] == "ok"
    assert all(abs(v) <= 0.01 for v in probe["match"].values())
    assert dry["fits_hbm"] and dry["attention_flops"] is None


def test_phi3_attention_splits_its_sequence(records):
    """40 heads over 16: the record lists the ``act_heads`` fallback, and
    the rank's attention (its 2048 query rows of 32768 against the keys up
    to its block's end) costs at most (2n - 1) / n**2 of one device's."""
    dry, _ = records[1][("phi3-medium-14b", "prefill_32k")]
    n = 16
    assert "act_heads(40) !% ('model',)(16)" in dry["sharding_fallbacks"]
    a = dry["attention_flops"]
    assert 0 < a["rank"] <= (2 * n - 1) / n ** 2 * a["one_device"]


def test_the_table_renders_the_records(records, monkeypatch, capsys):
    from benchmarks_torch import roofline_table
    out, _ = records
    monkeypatch.setattr(roofline_table, "ART", out / "dryrun")
    monkeypatch.setattr(roofline_table, "PROBE", out / "probe")
    assert roofline_table.main(mesh="pod1") == 0
    text = capsys.readouterr().out
    for arch, shape in CELLS:
        assert f"| {arch} | {shape} | 16x16 |" in text
    assert "fits 80 GB" in text and "4 traced cells, 0 errors" in text
