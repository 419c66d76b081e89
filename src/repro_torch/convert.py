"""What crosses between this package and the JAX reference package: buffers,
specs and results.  (The slice has no weights.)

Nothing here imports ``jax`` or ``repro``: buffers cross as numpy arrays
(``np.asarray(jax_array)`` on the reference's side), specs and results as the
plain dicts of ``to_dict()``.

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
    a = np.ascontiguousarray(a)
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
