"""Logical-axis sharding: rules, divisibility-checked resolution, ShardCtx
(counterpart of ``repro.distributed.sharding``).

Models annotate every tensor dim with a *logical* axis name; this module
maps logical names to mesh axes.  A mapping is applied only when the dim
size is divisible by the mesh-axes product; otherwise the dim falls back
along the candidate chain (usually to replication), and the fallback is
recorded in ``ShardCtx.fallbacks``.  ``DEFAULT_RULES``, ``_expand``,
``resolve_dim`` and ``spec`` are the reference's to the letter; a spec is
a plain tuple (``None``, an axis name or a tuple of names per dim, trailing
``None`` trimmed), so that ``tuple(reference_spec)`` equals it.

The mesh is any object with ``shape`` (axis name -> size, in order) and
``axis_names``: ``AbstractMesh`` (no process behind it: resolution only,
as ``jax.sharding.AbstractMesh`` serves the reference's rules) or
``repro_torch.launch.mesh.Mesh`` (one ``torch.distributed`` group an axis
line).  Where the reference leaves placement to ``NamedSharding`` /
``device_put``, the port holds blocks: ``shard`` takes this rank's block of
a full tensor from its mesh coordinates, ``gather`` all-gathers it back,
``all_reduce`` / ``all_gather`` run one collective an axis.  Every
collective on a CUDA tensor goes through NCCL (anything else raises), and
a mesh axis of more than one position without a process group raises: the
sharded path never runs on fewer ranks than the mesh names.

Autograd goes through the collectives: the backward of an all-gather is a
reduce-scatter (sum) over the same group, and the backward of a sum
all-reduce is a sum all-reduce, so that a parameter gathered at use
(``gather_tree``, ZeRO-3) receives the sum of every rank's gradient for
its block.  A tree of parameters is held leaf by leaf either as the blocks
``spec`` gives or whole (``held_spec`` tells which from the leaf's
shape), and ``gather_tree`` makes either whole.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

# logical axis -> ordered candidate mesh-axis tuples ("fsdp" expands to the
# data axes present in the mesh).  First candidate whose size divides the
# dim wins.
DEFAULT_RULES: dict[str, list[Optional[tuple[str, ...]]]] = {
    # weights
    "vocab": [("model",), None],
    "embed": [("fsdp",), None],
    "heads": [("model",), None],
    "kv_heads": [("model",), None],
    "head_dim": [None],
    "ffn": [("model",), None],
    "experts": [("model",), None],
    "kv_lora": [None],
    "inner": [("model",), None],
    "state": [None],
    "conv": [None],
    "layers": [None],
    "sites": [None],
    # activations
    "batch": [("dp",), None],          # dp expands to pod+data axes
    "seq": [None],
    "act_seq": [("model",), None],     # sequence parallelism: residual-stream
                                       # seq dim shards over model
    "act_heads": [("model",), None],
    # decode KV caches: batch takes the data axes first (if divisible), then
    # the sequence dim takes whatever is left — a 500k x 1 cache shards seq
    # over data.
    "kv_seq": [("data",), ("model",), None],
}

FSDP_AXES = ("pod", "data")
DP_AXES = ("pod", "data")

#: a spec: one entry a dim (None, an axis name, or a tuple of names)
Spec = tuple


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes with no process behind it: enough to
    resolve specs (any size), and to run on one rank where every axis has
    one position (``make_smoke_ctx``)."""
    sizes: tuple[int, ...]
    names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.names, self.sizes))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.names


def _expand(candidate: Optional[tuple[str, ...]], mesh
            ) -> Optional[tuple[str, ...]]:
    if candidate is None:
        return None
    out: list[str] = []
    for ax in candidate:
        if ax == "fsdp":
            out.extend(a for a in FSDP_AXES if a in mesh.axis_names)
        elif ax == "dp":
            out.extend(a for a in DP_AXES if a in mesh.axis_names)
        elif ax in mesh.axis_names:
            out.append(ax)
    return tuple(out) if out else None


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _tree_map(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a nested dict and its axes tree (a tuple at
    each leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, axes_tree[k]) for k, v in tree.items()}
    return fn(tree, axes_tree)


@dataclass
class ShardCtx:
    """Carries the mesh + rules through model code; resolves logical ->
    physical, and holds a rank's blocks."""
    mesh: Any
    rules: dict[str, list[Optional[tuple[str, ...]]]] = field(
        default_factory=lambda: dict(DEFAULT_RULES))
    fallbacks: list[str] = field(default_factory=list)  # dropped axes
    _block_specs: dict = field(default_factory=dict, repr=False,
                               compare=False)

    # -- mesh helpers -------------------------------------------------------
    def axis_size(self, *names: str) -> int:
        return int(math.prod([self.mesh.shape[n] for n in names
                              if n in self.mesh.axis_names] or [1]))

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in DP_AXES if a in self.mesh.axis_names)

    @property
    def fsdp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in FSDP_AXES if a in self.mesh.axis_names)

    @property
    def tp_axis(self) -> Optional[str]:
        return "model" if "model" in self.mesh.axis_names else None

    # -- resolution ---------------------------------------------------------
    def resolve_dim(self, logical: Optional[str], size: int,
                    used: Optional[set] = None) -> Optional[tuple[str, ...]]:
        """First candidate that is present, unused, and divides the dim."""
        if logical is None:
            return None
        used = used or set()
        for cand in self.rules.get(logical, [None]):
            axes = _expand(cand, self.mesh)
            if axes is None:
                return None
            if any(a in used for a in axes):
                continue  # axis already shards another dim: next candidate
            total = int(math.prod([self.mesh.shape[a] for a in axes]))
            if total <= 1:
                continue
            if size % total == 0:
                return axes
            self.fallbacks.append(f"{logical}({size}) !% {axes}({total})")
        return None

    def spec(self, shape: Sequence[int], axes: Sequence[Optional[str]]
             ) -> Spec:
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                             f"differ in length")
        used: set[str] = set()
        parts: list[Any] = []
        for size, logical in zip(shape, axes):
            r = self.resolve_dim(logical, size, used)
            if r is None:
                parts.append(None)
            else:
                used.update(r)
                parts.append(r if len(r) > 1 else r[0])
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def constrain(self, x, *axes: Optional[str]):
        """The reference's ``with_sharding_constraint`` by logical axes:
        the identity.  The port places activations where they are made: a
        batch arrives as this rank's block under the ``batch`` rule
        (``data.pipeline.make_pipeline``, or the caller), and every layer
        computes on it with its parameters gathered whole
        (``gather_tree``), so compute over ``model`` is replicated (the
        reference's tensor-parallel and sequence-parallel constraints are
        ROADMAP Queue A)."""
        if len(axes) != x.ndim:
            raise ValueError(f"{len(axes)} axes for a {x.ndim}-d tensor")
        return x

    def layout(self, tree, axes_tree) -> dict[str, dict]:
        """Every leaf's resolved spec and the bytes one rank would hold
        under it beside the bytes of the whole leaf.  Leaves: anything with
        ``shape`` and ``dtype`` (meta tensors, real ones), keyed "a/b/c"."""
        out: dict[str, dict] = {}

        def walk(t, ax, prefix):
            if isinstance(t, dict):
                for k in sorted(t):
                    walk(t[k], ax[k], f"{prefix}{k}/")
                return
            spec = self.spec(t.shape, ax)
            whole = math.prod(t.shape) * t.dtype.itemsize
            ways = math.prod(self.mesh.shape[a] for e in spec
                             for a in entry_axes(e))
            out[prefix[:-1]] = {"spec": spec, "bytes": whole,
                                "bytes_a_rank": whole // ways}
        walk(tree, axes_tree, "")
        return out

    def block_spec(self, shape: Sequence[int], axes: Sequence[Optional[str]]
                   ) -> Spec:
        """``spec(shape, axes)``, resolved once a (shape, axes) pair (so a
        fallback is recorded once, not at every use)."""
        key = (tuple(shape), tuple(axes))
        if key not in self._block_specs:
            self._block_specs[key] = self.spec(shape, axes)
        return self._block_specs[key]

    def held_spec(self, t, shape: Sequence[int],
                  axes: Sequence[Optional[str]]) -> Spec:
        """The spec this rank holds ``t`` by, for a leaf of whole ``shape``
        and logical ``axes``: () where ``t`` is whole, else ``spec(shape,
        axes)``, whose block ``t`` must be (anything else raises)."""
        if tuple(t.shape) == tuple(shape):
            return ()
        spec = self.block_spec(shape, axes)
        block = tuple(n // self.axis_size(*entry_axes(e)) for n, e in
                      zip(shape, spec + (None,) * (len(shape) - len(spec))))
        if tuple(t.shape) != block:
            raise ValueError(f"a leaf of {tuple(shape)} by {tuple(axes)} is "
                             f"held whole or as a {block} block on this "
                             f"mesh, not as {tuple(t.shape)}")
        return spec

    def split_axes(self, spec: Spec) -> tuple[str, ...]:
        """The mesh axes of more than one position that ``spec`` splits a
        leaf over."""
        return tuple(a for e in spec for a in entry_axes(e)
                     if self.mesh.shape[a] > 1)

    def other_axes(self, spec: Spec) -> tuple[str, ...]:
        """The mesh axes of more than one position that ``spec`` does not
        split a leaf over: those its gradient is summed over."""
        split = self.split_axes(spec)
        return tuple(a for a in self.mesh.axis_names
                     if self.mesh.shape[a] > 1 and a not in split)

    @property
    def n_ranks(self) -> int:
        """Positions in the mesh."""
        return self.axis_size(*self.mesh.axis_names)

    def check_ranks(self) -> None:
        """Raise unless every axis of more than one position has its
        process group (the mesh runs on as many ranks as it names)."""
        for a in self.mesh.axis_names:
            if self.mesh.shape[a] > 1:
                self._group(a)

    # -- blocks and collectives ----------------------------------------------
    def _group(self, axis: str):
        groups = getattr(self.mesh, "groups", None) or {}
        if axis not in groups:
            raise RuntimeError(
                f"mesh axis {axis!r} has {self.mesh.shape[axis]} positions "
                f"but no process group: the sharded path needs "
                f"{math.prod(self.mesh.shape.values())} ranks "
                f"(launch.mesh.make_mesh over that world), not one")
        return groups[axis]

    def coord(self, axes: Sequence[str]) -> int:
        """This rank's row-major position over ``axes`` (0 over axes of one
        position, or none)."""
        idx = 0
        for a in axes:
            n = self.mesh.shape[a]
            if n > 1:
                self._group(a)
                idx = idx * n + self.mesh.coords[a]
        return idx

    def shard(self, t, spec: Spec):
        """This rank's block of the full tensor ``t`` under ``spec``: a new
        tensor (``t`` itself where the spec shards nothing)."""
        out = t
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            n = self.axis_size(*axes)
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} is not "
                                 f"divisible by {axes} ({n} ways)")
            block = t.shape[dim] // n
            out = out.narrow(dim, self.coord(axes) * block, block)
        return t if out is t else out.clone()

    def tree_shard(self, tree, axes_tree):
        """``shard`` over a nested dict, each leaf by its logical axes."""
        return _tree_map(lambda t, ax: self.shard(t, self.spec(t.shape, ax)),
                         tree, axes_tree)

    def gather(self, t, spec: Spec):
        """The full tensor back from every rank's block under ``spec``: an
        all-gather over each dim's axes, minor axis first."""
        for dim, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                t = self.all_gather(t, a, dim)
        return t

    def all_gather(self, t, axis: str, dim: int):
        """Concatenate every position's ``t`` along ``dim``, in the order of
        the ``axis`` coordinate.  Under autograd its backward reduce-scatters
        (sums) the gradient over the same group."""
        if self.mesh.shape[axis] == 1:
            return t
        group = self._group(axis)
        _check_transport(t, group)
        return _AllGather.apply(t, group, self.mesh.shape[axis], dim)

    def all_reduce(self, t, axes: Sequence[str], op: str = "sum"):
        """``t`` reduced (``sum`` or ``max``) over ``axes``, one collective an
        axis of more than one position.  In place, and returned; a sum on a
        tensor that autograd records is out of place, and its backward is
        the sum all-reduce of the gradient."""
        groups = []
        for a in axes:
            if self.mesh.shape[a] > 1:
                groups.append(self._group(a))
                _check_transport(t, groups[-1])
        if op == "sum" and torch.is_grad_enabled() and t.requires_grad:
            return _AllReduceSum.apply(t, tuple(groups)) if groups else t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        for group in groups:
            dist.all_reduce(t, op=red, group=group)
        return t

    def all_reduce_each(self, values: list, axes: list, op: str = "sum"
                        ) -> list:
        """Each 0-d ``values[i]`` reduced over ``axes[i]``: one collective a
        distinct set of axes, the values that share it stacked."""
        out = list(values)
        for key in dict.fromkeys(tuple(a) for a in axes):
            idx = [i for i, a in enumerate(axes) if tuple(a) == key]
            if not any(self.mesh.shape[a] > 1 for a in key):
                continue
            red = self.all_reduce(torch.stack([values[i] for i in idx]),
                                  key, op)
            for j, i in enumerate(idx):
                out[i] = red[j]
        return out

    def all_mean(self, t):
        """The reference's ``pmean`` over every mesh axis."""
        return self.all_reduce(t, self.mesh.axis_names) / self.n_ranks


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter (sum)."""

    @staticmethod
    def forward(fc, t, group, n: int, dim: int):
        fc.group, fc.n, fc.dim = group, n, dim
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(fc, g):
        _check_transport(g, fc.group)
        whole = g.movedim(fc.dim, 0).contiguous()       # the n blocks in turn
        out = torch.empty((whole.shape[0] // fc.n,) + whole.shape[1:],
                          dtype=g.dtype, device=g.device)
        from repro_torch.core.collective_bench import _library
        _library("reduce_scatter_single", "reduce_scatter_tensor")(
            out, whole, group=fc.group)
        return out.movedim(0, fc.dim), None, None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum all-reduce over each group in turn; backward: the same."""

    @staticmethod
    def forward(fc, t, groups):
        fc.groups = groups
        out = t.clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(fc, g):
        out = g.clone()
        for group in fc.groups:
            _check_transport(out, group)
            dist.all_reduce(out, group=group)
        return out, None


def gather_tree(ctx, tree, specs):
    """Every leaf of ``tree`` (a rank's parameters, each held whole or as
    its ``ShardCtx.spec`` block) whole: all-gathered over the axes it is
    split on (ZeRO-3, at use; under autograd the gradient of each block is
    the sum of every rank's).  ``specs``: the matching tree of
    ``ParamSpec`` (the whole shape and logical axes of each leaf); a leaf
    whose spec is None, or absent, stays as it is.  ``ctx`` None, or a mesh
    of one position, returns ``tree`` itself."""
    if ctx is None or ctx.n_ranks == 1:
        return tree

    def walk(t, s):
        if isinstance(t, dict):
            s = s or {}
            return {k: walk(v, s.get(k)) for k, v in t.items()}
        if s is None:
            return t
        return ctx.gather(t, ctx.held_spec(t, s.shape, s.axes))
    return walk(tree, specs)


def _check_transport(t, group) -> None:
    """A CUDA tensor goes through NCCL and nothing else."""
    backend = dist.get_backend(group)
    if t.device.type == "cuda" and backend != "nccl":
        raise RuntimeError(f"a CUDA tensor reached a {backend} collective: "
                           f"the mesh's CUDA collectives are NCCL only")


def make_smoke_ctx() -> ShardCtx:
    """One-rank mesh with the production axis names: every axis of one
    position, no collective."""
    return ShardCtx(AbstractMesh((1, 1, 1), ("pod", "data", "model")))
