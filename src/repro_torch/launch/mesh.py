"""Mesh factory (counterpart of ``repro.launch.mesh``): a named grid of the
ranks of the ``torch.distributed`` world.

Where the reference lays a ``jax.make_mesh`` over the host's devices, the
port lays the mesh over the processes of the world that
``bench.distributed`` starts (NCCL on CUDA, gloo on the CPU; one device a
process).  Ranks are placed row-major, as ``jax.make_mesh`` places host
devices, and each axis gets one process group per line of the grid along
it.  Every rank creates every group, in the same order (``new_group`` is
collective over the world), and keeps the one it belongs to.

A function, not a module-level constant: importing this module touches no
process group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

#: the axis names the sharding rules know
AXES = ("pod", "data", "model")


@dataclass
class Mesh:
    """The grid this rank sees: ``shape`` maps each axis, in order, to its
    size (as ``jax.sharding.Mesh.shape`` does); ``groups`` / ``coords`` give
    this rank's process group along each axis and its coordinate there;
    ``ranks`` the global ranks of that group, in axis order."""
    shape: dict[str, int]
    groups: dict
    coords: dict[str, int]
    ranks: dict[str, list[int]]
    device: object

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)


def _lines(shape: tuple[int, ...], axis: int) -> list[list[int]]:
    """The ranks of every line of the row-major grid along ``axis``, lines
    in row-major order of the other coordinates."""
    import numpy as np
    grid = np.arange(math.prod(shape)).reshape(shape)
    moved = np.moveaxis(grid, axis, -1).reshape(-1, shape[axis])
    return [[int(r) for r in line] for line in moved]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device=None) -> Mesh:
    """A mesh of ``shape`` over the initialised ``torch.distributed`` world
    (its size must be the product of ``shape``).  Axis names must come from
    {pod, data, model} so the sharding rules apply unchanged.  ``device``
    (None = ``cuda``) is where this rank's buffers live: ``cuda`` means the
    process's current CUDA device, which ``bench.distributed.initialize``
    sets."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.device import resolve_device
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not set(axes) <= set(AXES):
        raise ValueError(f"mesh axes {axes}: each must be one of {AXES}")
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair one "
                         f"to one, without repeats")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world (bench.distributed.initialize, or a "
                           "launch that sets REPRO_COORDINATOR)")
    world, me = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{math.prod(shape)} processes; the world has "
                         f"{world}")
    groups, ranks = {}, {}
    for i, name in enumerate(axes):
        for line in _lines(shape, i):
            g = dist.new_group(line)
            if me in line:
                groups[name], ranks[name] = g, line
    coords = {name: ranks[name].index(me) for name in axes}
    return Mesh(shape=dict(zip(axes, shape)), groups=groups, coords=coords,
                ranks=ranks, device=dev)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh, (16, 16) over (data, model) or (2,
    16, 16) over (pod, data, model).  A world of another size raises, naming
    the size the mesh needs; the shape is never shrunk."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)
