"""Checkpointing: one ``.npy`` a leaf + a JSON manifest, atomic publish,
async save (counterpart of ``repro.checkpoint.checkpoint``).

The reference's layout, kept exactly, so that either package reads the
other's checkpoints:

    step_00000100/
      manifest.json        {step, time, treedef, leaves: [name, shape, dtype]}
      <a>__<b>__<c>.npy    the full array of leaf a/b/c
    LATEST                 -> step_00000100   (atomic rename publish)

Leaves are flattened in sorted-key order, as ``jax.tree_util`` flattens a
dict.  numpy has no bfloat16: a bfloat16 leaf is written as its uint16
bits with ``"bfloat16"`` as its manifest dtype, and a bfloat16 leaf is read
back through its bits whatever numpy type its file holds (the reference's
files hold an ``ml_dtypes`` bfloat16 array, whose ``.npy`` type is
two-byte void).

On a mesh (``ctx`` and the tree's ``specs``: the ``ParamSpec`` of each
leaf held as a block, None for a leaf held whole) ``save`` gathers each
leaf whole, one leaf at a time, and rank 0 writes the format above, so the
files do not depend on the mesh; ``restore`` reads each whole leaf and
keeps this rank's block of it, so a checkpoint restores onto any mesh, one
device included (the reference's elastic restore).
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import tree_leaves_with_paths

_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _treedef(tree) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` writes it."""
    def inner(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {inner(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({inner(tree)})"


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(a copy of the leaf to write, its manifest dtype): a copy even of a
    host leaf, since training updates its tensors in place while an async
    save is still writing."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.array(arr, order="C")       # a copy torch may own; keeps 0-d
    if dtype in _TORCH_DTYPES:
        t = torch.from_numpy(arr.view(np.int16)).view(_TORCH_DTYPES[dtype])
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def config_hash(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


_ASYNC_THREADS: list[threading.Thread] = []


def _whole(ctx, specs, tree):
    """(name, the whole leaf) for every leaf of ``tree``, gathered one at a
    time on a mesh."""
    leaves = tree_leaves_with_paths(tree)
    if ctx is None or ctx.n_ranks == 1:
        yield from leaves
        return
    held = dict(tree_leaves_with_paths(specs))
    for name, leaf in leaves:
        s = held.get(name)
        yield name, (leaf if s is None else
                     ctx.gather(leaf, ctx.held_spec(leaf, s.shape, s.axes)))


def save(ckpt_dir: str | Path, step: int, tree, extra: Optional[dict] = None,
         blocking: bool = True, ctx=None, specs=None) -> Path:
    """Write a checkpoint; returns the step directory.  With
    ``blocking=False`` the file writes happen on a background thread (every
    leaf is first copied to the host, synchronously), so that training
    proceeds while the disk I/O runs; ``wait_async`` joins them.  On a mesh
    every rank takes part in the gathers and rank 0 alone writes; a
    blocking save returns on every rank once the checkpoint is published."""
    ckpt_dir = Path(ckpt_dir)
    step_dir = ckpt_dir / f"step_{step:08d}"
    tmp_dir = ckpt_dir / f".tmp_step_{step:08d}"
    writer = ctx is None or ctx.n_ranks == 1 or \
        torch.distributed.get_rank() == 0
    host = []
    with torch.no_grad():
        for name, leaf in _whole(ctx, specs, tree):
            if writer:
                host.append((name, *_to_host(leaf)))
    if not writer:
        if blocking:
            torch.distributed.barrier()         # rank 0 has published
        return step_dir
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir(parents=True)
    manifest = {
        "step": step,
        "time": time.time(),
        "treedef": _treedef(tree),
        "leaves": [{"name": n, "shape": list(a.shape), "dtype": dt}
                   for n, a, dt in host],
        "extra": extra or {},
    }

    def _write():
        for name, arr, _ in host:
            np.save(tmp_dir / (name.replace("/", "__") + ".npy"), arr)
        (tmp_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp_dir.rename(step_dir)                       # atomic publish
        tmp_latest = ckpt_dir / ".LATEST.tmp"
        tmp_latest.write_text(step_dir.name)
        tmp_latest.rename(ckpt_dir / "LATEST")

    if blocking:
        _write()
        if ctx is not None and ctx.n_ranks > 1:
            torch.distributed.barrier()
    else:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _ASYNC_THREADS.append(t)
    return step_dir


def wait_async():
    """Join every background save started so far."""
    for t in _ASYNC_THREADS:
        t.join()
    _ASYNC_THREADS.clear()


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The step LATEST names or, where its directory has no manifest (a
    torn write), the newest complete step directory; None if there is
    none."""
    latest = Path(ckpt_dir) / "LATEST"
    if not latest.exists():
        return None
    d = Path(ckpt_dir) / latest.read_text().strip()
    if not (d / "manifest.json").exists():
        steps = sorted(Path(ckpt_dir).glob("step_*/manifest.json"))
        if not steps:
            return None
        d = steps[-1].parent
    return int(d.name.split("_")[1])


def restore(ckpt_dir: str | Path, tree_like, device=None,
            step: Optional[int] = None, ctx=None, specs=None):
    """Restore into the structure of ``tree_like`` (nested dicts of
    tensors): (tree, manifest).  Each leaf keeps the dtype it was written
    with and goes to ``device`` (None: the device of ``tree_like``'s leaf).
    On a mesh (``ctx``, ``specs`` as for ``save``) each leaf is this rank's
    block of the whole one, held as ``tree_like``'s leaf is.  Raises
    ValueError when the checkpoint's leaves are not the tree's."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())

    entries = manifest["leaves"]
    leaves = tree_leaves_with_paths(tree_like)
    if [n for n, _ in leaves] != [e["name"] for e in entries]:
        raise ValueError(f"checkpoint/tree structure mismatch: {step_dir} "
                         f"holds {[e['name'] for e in entries]}, the tree "
                         f"{[n for n, _ in leaves]}")
    held = dict(tree_leaves_with_paths(specs)) if specs is not None else {}
    out = {}
    for (name, like), e in zip(leaves, entries):
        dev = device if device is not None else getattr(like, "device", "cpu")
        t = _from_host(np.load(step_dir / (name.replace("/", "__") + ".npy")),
                       e["dtype"], "cpu")
        s = held.get(name)
        if ctx is not None and s is not None:
            t = ctx.shard(t, ctx.held_spec(like, s.shape, s.axes))
        out[name] = t.to(dev)

    def rebuild(t, prefix=""):
        if isinstance(t, dict):
            return {k: rebuild(t[k], f"{prefix}{k}/") for k in t}
        return out[prefix[:-1]]
    return rebuild(tree_like), manifest
