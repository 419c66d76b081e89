"""The port's checkpoints (``repro_torch.checkpoint.checkpoint``): the
reference's tests (``tests/test_ft.py`` checkpoint section), and the two
packages reading each other's checkpoints bit for bit, on the CPU.

The layout is the reference's: one ``.npy`` a leaf named by its path,
``manifest.json``, an atomic ``LATEST``.  A bfloat16 leaf crosses through
its bits: the reference writes an ``ml_dtypes`` array (a two-byte void
``.npy``), the port its uint16 bits, both with ``"bfloat16"`` in the
manifest.  The reference restores a leaf as the array its file holds: the
port's bf16 leaf comes back to it as uint16 with the same bits, and its
own bf16 leaf not at all (``jnp.asarray`` refuses the void array;
ROADMAP Queue C).
"""
import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.convert import params_from_reference, tree_to_reference


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": {"a": torch.randn((16, 8), generator=g),
                  "b": torch.randn((4,), generator=g)},
            "step_arr": torch.arange(5)}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree(0)
    ckpt.save(tmp_path, 7, tree)
    restored, manifest = ckpt.restore(tmp_path, tree)
    assert manifest["step"] == 7
    assert _equal(restored, tree)


def test_checkpoint_latest_and_multiple(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    ckpt.save(tmp_path, 10, t1)
    ckpt.save(tmp_path, 20, t2)
    assert ckpt.latest_step(tmp_path) == 20
    restored, _ = ckpt.restore(tmp_path, t2, step=10)
    assert torch.equal(restored["w"]["a"], t1["w"]["a"])


def test_checkpoint_async(tmp_path):
    ckpt.save(tmp_path, 5, _tree(3), blocking=False)
    ckpt.wait_async()
    assert ckpt.latest_step(tmp_path) == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_async_holds_the_tree_as_it_was_saved(tmp_path,
                                                         monkeypatch, dtype):
    """An async save writes the tree as it stood at ``save``, although the
    next training step updates the host tensors in place while the
    background thread writes: the file writes are held back until the
    update has happened."""
    tree = {"w": {"a": _tree(6)["w"]["a"].to(dtype)}, "step_arr":
            torch.arange(5)}
    before = {"w": {"a": tree["w"]["a"].clone()},
              "step_arr": tree["step_arr"].clone()}
    updated = threading.Event()
    np_save = np.save

    def held_save(*args, **kwargs):
        updated.wait(timeout=30)
        np_save(*args, **kwargs)
    monkeypatch.setattr(np, "save", held_save)
    ckpt.save(tmp_path, 3, tree, blocking=False)
    with torch.no_grad():
        tree["w"]["a"].add_(1.0)
        tree["step_arr"].copy_(tree["step_arr"] + 1)
    updated.set()
    ckpt.wait_async()
    restored, _ = ckpt.restore(tmp_path, tree)
    assert _equal(restored, before)


def test_checkpoint_torn_write_fallback(tmp_path):
    ckpt.save(tmp_path, 5, _tree(4))
    # LATEST names a directory that never got published (a preemption
    # mid-publish): the newest complete step is used
    (Path(tmp_path) / "LATEST").write_text("step_99999999")
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_step(tmp_path / "none") is None


def test_checkpoint_structure_mismatch_detected(tmp_path):
    ckpt.save(tmp_path, 1, _tree(5))
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(tmp_path, {"different": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", _tree(5))


def _state(seed):
    """A training-state tree as the Trainer saves it: params, bf16 and
    float32 moments, the int32 step."""
    rng = np.random.default_rng(seed)
    w = {"blocks": {"w": rng.standard_normal((2, 8, 4)).astype(np.float32)},
         "ln": {"scale": rng.standard_normal(8).astype(np.float32)}}
    mu = jax.tree.map(lambda a: jnp.asarray(a * 0.1, jnp.bfloat16), w)
    nu = jax.tree.map(lambda a: jnp.asarray(a * a * 1e-3, jnp.float32), w)
    return {"params": jax.tree.map(jnp.asarray, w),
            "opt": {"mu": mu, "nu": nu, "step": jnp.int32(9)}}


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    """Written by the reference (bf16 moments and all), read by the port:
    every leaf's dtype, shape and bits."""
    jstate = _state(0)
    j_ckpt.save(tmp_path, 9, jstate)
    like = params_from_reference(jax.tree.map(np.asarray, jstate))
    restored, manifest = ckpt.restore(tmp_path, like)
    assert manifest["step"] == 9
    assert restored["opt"]["mu"]["ln"]["scale"].dtype == torch.bfloat16
    assert restored["opt"]["step"].shape == ()
    assert _equal(restored, like)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    """Written by the port, read by the reference's ``restore``: float32
    and int32 leaves as they were, the bf16 moments as their uint16 bits;
    the layout (file names, manifest) is the reference's own."""
    jstate = _state(1)
    tstate = params_from_reference(jax.tree.map(np.asarray, jstate))
    ckpt.save(tmp_path / "port", 9, tstate)
    j_ckpt.save(tmp_path / "ref", 9, jstate)
    restored, manifest = j_ckpt.restore(tmp_path / "port", jstate)
    assert manifest["step"] == 9
    want = jax.tree.map(np.asarray, jstate)
    got = jax.tree.map(np.asarray, restored)
    for path in (("params", "blocks", "w"), ("params", "ln", "scale"),
                 ("opt", "nu", "blocks", "w"), ("opt", "step")):
        a, b = want, got
        for k in path:
            a, b = a[k], b[k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    bits = got["opt"]["mu"]["blocks"]["w"]
    assert bits.dtype == np.uint16
    assert bits.tobytes() == want["opt"]["mu"]["blocks"]["w"].tobytes()
    # the same files and the same manifest but its time
    port, ref = (tmp_path / d / "step_00000009" for d in ("port", "ref"))
    assert sorted(p.name for p in port.iterdir()) \
        == sorted(p.name for p in ref.iterdir())
    mp, mr = (json.loads((d / "manifest.json").read_text())
              for d in (port, ref))
    mp.pop("time"), mr.pop("time")
    assert mp == mr
    for name in ("params__blocks__w.npy", "opt__step.npy"):
        assert (port / name).read_bytes() == (ref / name).read_bytes()
    assert (tmp_path / "port" / "LATEST").read_text() == "step_00000009"


def test_the_reference_cannot_restore_its_own_bf16_leaf(tmp_path):
    """The fault the port works around (ROADMAP Queue C): the reference
    writes a bf16 leaf as two-byte void, and its ``restore`` hands that to
    ``jnp.asarray``, which refuses it.  The port reads the same file."""
    jstate = _state(2)
    j_ckpt.save(tmp_path, 1, jstate)
    with pytest.raises(TypeError):
        j_ckpt.restore(tmp_path, jstate)
    like = params_from_reference(jax.tree.map(np.asarray, jstate))
    restored, _ = ckpt.restore(tmp_path, like)
    assert _equal(restored, like)
    assert tree_to_reference(restored)["opt"]["mu"]["ln"]["scale"].tobytes() \
        == np.asarray(jstate["opt"]["mu"]["ln"]["scale"]).tobytes()
