"""What crosses between this package and the JAX reference package: buffers,
model weights and caches, optimiser states and batches, specs and results.

Nothing here imports ``jax`` or ``repro``: buffers cross as numpy arrays
(``np.asarray(jax_array)`` on the reference's side), weight, cache,
optimiser-state and batch trees as nested dicts of them
(``jax.tree.map(np.asarray, params)``), specs and results as the plain
dicts of ``to_dict()``.

bfloat16 is the trap: numpy has no bfloat16, the reference hands back an
``ml_dtypes`` array that ``torch.from_numpy`` refuses, so the bits go across
as uint16 and are re-viewed on the other side.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

#: backend names of the reference -> this package's (and back)
BACKEND_FROM_REFERENCE = {"xla": "torch", "pallas": "cuda"}
BACKEND_TO_REFERENCE = {v: k for k, v in BACKEND_FROM_REFERENCE.items()}


def tensor_from_reference(a, device=None) -> torch.Tensor:
    """A numpy array taken from the reference (``np.asarray(jax_array)``) ->
    a torch tensor of the same dtype, shape and bits.  ``device=None`` keeps
    it on the CPU (this is a conversion, not a measurement entry point)."""
    a = np.array(a, order="C")      # ascontiguousarray would make 0-d 1-d
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).copy())
        t = bits.view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t if device is None else t.to(device)


def to_reference(t: torch.Tensor) -> np.ndarray:
    """A torch tensor -> a numpy array of the same dtype, shape and bits that
    ``jnp.asarray`` accepts (bfloat16 comes back as an ``ml_dtypes`` array
    when that package is present, else as its uint16 bits)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_reference(tree, device=None):
    """A reference parameter tree taken across as numpy
    (``jax.tree.map(np.asarray, params)``: nested dicts of arrays) -> the
    same nested dict of tensors, leaf for leaf, same dtypes and bits
    (bfloat16 through its uint16 bits), on ``device`` (None keeps the CPU)."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return tensor_from_reference(tree, device)


def cache_from_reference(tree, device=None):
    """A reference decode cache (nested dicts of arrays, as the reference's
    ``prefill`` returns it or ``init_cache`` makes it) -> the port's, leaf
    for leaf."""
    return params_from_reference(tree, device)


def batch_from_reference(batch, device=None) -> dict:
    """A reference batch (``tokens`` / ``labels`` int32, encdec's ``frames``
    bfloat16) -> the port's: the token ids as int64, as the port's
    pipeline draws them, the frames bit for bit."""
    out = params_from_reference(batch, device)
    for k in ("tokens", "labels"):
        if k in out:
            out[k] = out[k].long()
    return out


def tree_to_reference(tree):
    """A nested dict of tensors (parameters, gradients, an optimiser
    state) -> the same nested dict of numpy arrays, bits kept, that
    ``jax.tree.map(jnp.asarray, ...)`` takes."""
    if isinstance(tree, dict):
        return {k: tree_to_reference(v) for k, v in tree.items()}
    return to_reference(tree)


def _map_backend(name, table):
    return table.get(name, name)


def _map_spec(d: dict, table: dict) -> dict:
    d = copy.deepcopy(d)
    if "backend" in d:
        d["backend"] = _map_backend(d["backend"], table)
    if "many" in d:                      # run_many envelopes nest their specs
        d["many"] = [_map_spec(s, table) for s in d["many"]]
    return d


def _map_result(d: dict, table: dict) -> dict:
    d = copy.deepcopy(d)
    if d.get("spec"):
        d["spec"] = _map_spec(d["spec"], table)
    for p in d.get("points", []):
        p["backend"] = _map_backend(p["backend"], table)
    return d


def spec_from_reference(d: dict) -> dict:
    """A reference ``BenchSpec.to_dict()`` -> one this package's
    ``BenchSpec.from_dict`` loads: backend names mapped (``xla`` -> ``torch``,
    ``pallas`` -> ``cuda``), every other field untouched."""
    return _map_spec(d, BACKEND_FROM_REFERENCE)


def spec_to_reference(d: dict) -> dict:
    return _map_spec(d, BACKEND_TO_REFERENCE)


def result_from_reference(d: dict) -> dict:
    """A reference ``BenchResult.to_dict()`` -> one this package's
    ``BenchResult.from_dict`` loads (backend names mapped in the spec and on
    every point; everything else untouched)."""
    return _map_result(d, BACKEND_FROM_REFERENCE)


def result_to_reference(d: dict) -> dict:
    return _map_result(d, BACKEND_TO_REFERENCE)
