"""The port's train step on a mesh (``train.step.make_train_step`` with a
``ShardCtx`` over gloo ranks; the parameters held by
``registry.held_axes``, gathered at use; the batch split over the data
axes) against the reference's SPMD step, on the CPU: granite-3-2b reduced
on (pod, data, model) = (2, 2, 2), the reference's own shape in
``tests/test_system.py``, 8 processes.  The harness is
``tests/_train_mesh.py``.

Limits: those of ``tests/test_torch_train.py`` (loss and metrics 2e-3
relative, every gradient leaf 2e-2 relative RMS).  ``grad_compression``
on the mesh: exactly the port's own one-device compression of the whole
reduced gradient (the scale is the whole leaf's), and against the
reference's ``compress_grads`` of its gradients the gradients' 2e-2 plus
one int8 step of the leaf (its max / 127) over the leaf's RMS: an
element whose two gradients differ by a rounding may round to the next
step.
"""
import numpy as np
import pytest
import torch

from _train_mesh import GRAD_RMS_TOL, LOSS_RTOL, hold_case, rel_rms, \
    run_cases, tag
from repro_torch.convert import params_from_reference
from repro_torch.optim.compression import compress_grads

CASES = [("granite-3-2b", (2, 2, 2))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("train_mesh"), CASES,
                     compress=True)


@pytest.mark.parametrize("case", CASES, ids=lambda c: tag(*c))
def test_mesh_step_matches_the_reference(runs, case):
    hold_case(runs, *case)


def test_grad_norm_is_the_global_one(runs):
    """``grad_norm`` sums each leaf's squares over the axes it is split on:
    the reference's ``global_norm`` of its global gradient."""
    t = tag(*CASES[0])
    want = float(runs["ref"][f"{t}/grad_norm"])
    got = float(runs["port"][f"{t}/m/grad_norm"])
    assert abs(got - want) <= LOSS_RTOL * want, (got, want)


def test_grad_compression_uses_the_whole_leaf_scale(runs):
    """The compressed gradient the mesh step hands AdamW equals, bit for
    bit, the one-device compression of the whole reduced gradient, and
    lies within GRAD_RMS_TOL of the reference's."""
    t = tag(*CASES[0])
    port, ref = runs["port"], runs["ref"]
    before = {k[len(t) + 8:]: v for k, v in port.items()
              if k.startswith(f"{t}/before/")}
    got = {k[len(t) + 3:]: v for k, v in port.items()
           if k.startswith(f"{t}/c/")}
    assert before.keys() == got.keys() and got
    names = sorted(before)
    whole = {n: torch.from_numpy(before[n]) for n in names}
    want, _ = compress_grads(whole, {n: torch.zeros_like(whole[n])
                                     for n in names})
    for n in names:
        assert np.array_equal(got[n], want[n].numpy()), n
        c = ref[f"{t}/c/{n}"].astype(np.float64)
        step = np.abs(c).max() / 127 / np.sqrt(np.mean(c * c))
        assert rel_rms(got[n], c) <= GRAD_RMS_TOL + step, n


def test_blocks_are_the_rules(runs):
    """Every leaf a rank holds is its ``ShardCtx.spec`` block on (2, 2,
    2): embed over (pod, data), vocab, heads and ffn over model."""
    t = tag(*CASES[0])
    blocks = runs["rep"][0][t]["blocks"]
    emb = blocks["embed/embedding"]
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.common import vocab_padded
    cfg = reduced(get_arch("granite-3-2b"))
    assert emb == [vocab_padded(cfg) // 2, cfg.d_model // 4]
    assert blocks["blocks/mlp/w_gate"] == [cfg.n_layers, cfg.d_model // 4,
                                           cfg.d_ff // 2]
    assert blocks["ln_f/scale"] == [cfg.d_model // 4]
    for rep in runs["rep"]:
        assert rep[t]["held"] == rep[t]["rules"]
