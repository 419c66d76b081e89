"""Logical-axis sharding: rules, divisibility-checked resolution, ShardCtx,
and the tensor- and sequence-parallel plan of a forward pass (counterpart
of ``repro.distributed.sharding``).

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
``all_reduce`` / ``all_gather`` / ``reduce_scatter`` run one collective an
axis.  Every collective on a CUDA tensor goes through NCCL (anything else
raises), and a mesh axis of more than one position without a process
group raises: the sharded path never runs on fewer ranks than the mesh
names.

Tensor and sequence parallelism over ``model`` (``TP``, ``tp_plan``).  A
layer's leaves are gathered over the fsdp axes only (``gather_tree(...,
keep=("model",))``), so that a rank computes on its ``model`` block:
the query / KV heads (``rank_heads``), the ffn, the SSD heads and inner
dims, the vocabulary.  A column split (``wq``, ``w_gate``, ``w_x``, the
head's vocabulary columns) needs the layer's whole input; a row split
(``wo``, ``w_down``, ``w_out``) leaves a partial sum that ``TP.row`` sums
over ``model`` (``TP.reduce`` for the embedding's rows, whose partial
sums are exact).  ``TP.row`` keeps each rank's partial product in
float32 (bf16 operands, products summed in float32, not rounded) and
rounds the sum over ``model`` once, the one rounding one device's bf16
product makes: rounding each rank's partial to bf16 first moves reduced
zamba2's gradients 3.4e-2 from one device's, against 1.2e-2 this way.
With sequence parallelism (the ``act_seq`` rule resolves for the
sequence) the residual stream between layers is this rank's block of the
sequence: ``TP.gather_seq`` (an all-gather) comes before each column
split and the row split's sum is a reduce-scatter; without it the stream
is whole on every rank, ``gather_seq`` is the identity and the sum an
all-reduce.  A dim the rules cannot divide is computed whole on every
rank, its output not reduced; but where the query heads do not divide
(phi3's 40 heads over 16) and the sequence does, the attention splits its
queries' sequence instead, as the reference's ``act_seq`` fallback does
(``Heads.seq``): each rank computes every head for its block of the
sequence, against the keys and values all-gathered up to its block's end.

``ShardCtx.recording()`` logs every collective the ctx issues, backward
passes included, as a plain tuple (kind, the bytes of its result, group
size, mesh axis): the port's counterpart of the collectives the
reference's roofline parses out of compiled HLO (``launch.dryrun`` turns
them into ``roofline.analyze.CollectiveOp`` records).

Autograd goes through the collectives, and every one of them has the
sum-conjugate backward: an all-gather's is a reduce-scatter (sum) over
the same group, a reduce-scatter's an all-gather, a sum all-reduce's a
sum all-reduce.  Then autograd on each rank gives the gradient of the sum
over ranks of every rank's loss with respect to this rank's copy of each
leaf, and ``train.step``'s rule stays exact unchanged (each rank
backpropagates ``loss / N``; each leaf's gradient is summed over the
axes it is not split on):

- a leaf split over ``model`` (``wq``'s heads, ``w_down``'s ffn rows) is
  read by its own rank only, so its gradient is that rank's, and there is
  no ``model`` axis left to sum over;
- a leaf replicated over ``model`` (norms, ``w_B`` / ``w_C``, the router,
  ``w_dkv``) is read on every rank of the line, each rank's gradient is
  the part of the loss that flows through its own compute (its heads, its
  ffn block, its sequence block), and the rule's sum over ``model`` adds
  the parts;
- every rank's loss is the same number after the head's reductions, so
  the sum of the N losses over N is the loss.

Without sequence parallelism the residual stream is whole on every rank
of the line, and a column split reads it through ``mean_equal``: the
mean all-reduce of values that are equal, so its forward is the value
itself, and its backward (its own conjugate) averages the ranks' parts
of the stream's gradient.  The rule stays exact (what flows above the
stream is the same function of the leaves on every rank), and each rank
then carries the whole gradient over M as the sequence-parallel layout
carries the whole, so that the two layouts round alike: read as it is,
each rank's copy carries only its own part of the gradient, which rounds
elsewhere (reduced granite's gradients with and without sequence
parallelism then lie 1.0e-2 apart, ``wk``; 1.9e-7 through it).

Megatron's identity-backward ``f`` / ``g`` operators would count the loss
once a rank instead; the port does not use them.  A tree of parameters is
held leaf by leaf either as the blocks ``spec`` gives or whole
(``held_spec`` tells which from the leaf's shape), and ``gather_tree``
makes either whole, or whole but for its ``model`` block.
"""
from __future__ import annotations

import contextlib
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
    #: (kind, bytes, group size, mesh axis) of every collective issued
    #: while ``recording``; None: not recording
    log: Optional[list] = field(default=None, repr=False, compare=False)

    @contextlib.contextmanager
    def recording(self):
        """Log every collective this ctx issues inside the block, its
        backward passes' included, into the list it yields: (kind, bytes
        of the result, group size, mesh axis), counted as the reference's
        HLO parser counts them (an all-gather the gathered
        tensor, a reduce-scatter the rank's block, an all-reduce its
        operand).  An axis of one position issues, and logs, nothing."""
        prev, self.log = self.log, []
        try:
            yield self.log
        finally:
            self.log = prev

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
        the identity.  The port places activations where they are made,
        and each reference constraint lives where the layout is made:

        - ``("batch", ...)``: the batch arrives as this rank's block over
          the data axes (``data.pipeline.make_pipeline``, or the caller);
        - ``("batch", "act_seq", None)`` between blocks (``transformer``,
          ``hybrid``, ``ssm_lm``, ``encdec``): ``tp_plan`` resolves
          ``act_seq`` for the sequence, and the models keep the residual
          stream as this rank's sequence block (``TP.reduce`` ends a layer
          with a reduce-scatter, ``TP.gather_seq`` starts one);
        - ``_constrain_qkv`` / ``_constrain_attn_out``'s heads over
          ``act_heads`` / ``kv_heads``: ``rank_heads``, and the layer's
          ``wq`` / ``wk`` / ``wv`` / ``wo`` blocks
          (``gather_tree(..., keep=("model",))``); where ``act_heads``
          does not resolve and ``act_seq`` does, the query rows of the
          rank's sequence block against the keys and values all-gathered
          (``Heads.seq``), else every head whole on every rank;
        - ``ssm_block``'s ``xh`` over ``heads``: the rank's ``w_x`` /
          ``w_dt`` / ``conv_x`` / ``A_log`` / ``D`` / ``dt_bias`` blocks
          (``models.ssm``)."""
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
        n = self.mesh.shape[axis]
        _record(self.log, "all-gather", t, axis, n, n)
        return _AllGather.apply(t, group, n, dim, self.log, axis)

    def reduce_scatter(self, t, axis: str, dim: int):
        """The sum over the ``axis`` group of every position's ``t``, of
        which this rank keeps its block along ``dim`` (block ``coord``, in
        the order of ``all_gather``).  Under autograd its backward
        all-gathers the gradient over the same group."""
        if self.mesh.shape[axis] == 1:
            return t
        group = self._group(axis)
        _check_transport(t, group)
        n = self.mesh.shape[axis]
        _record(self.log, "reduce-scatter", t, axis, n, 1 / n)
        return _ReduceScatter.apply(t, group, n, dim, self.log, axis)

    def mean_equal(self, t, axis: str):
        """The mean over the ``axis`` group of a tensor every position
        holds equal: ``t`` itself in the forward pass (the mean of equal
        values), and under autograd the mean all-reduce of the gradient
        (float32), the mean all-reduce's own backward."""
        if self.mesh.shape[axis] == 1:
            return t
        group = self._group(axis)
        _check_transport(t, group)
        return _MeanEqual.apply(t, group, self.mesh.shape[axis], self.log,
                                axis)

    def all_reduce(self, t, axes: Sequence[str], op: str = "sum"):
        """``t`` reduced (``sum`` or ``max``) over ``axes``, one collective an
        axis of more than one position.  In place, and returned; a sum on a
        tensor that autograd records is out of place, and its backward is
        the sum all-reduce of the gradient."""
        groups, names = [], []
        for a in axes:
            if self.mesh.shape[a] > 1:
                groups.append(self._group(a))
                names.append(a)
                _check_transport(t, groups[-1])
        for a in names:
            _record(self.log, "all-reduce", t, a, self.mesh.shape[a])
        if op == "sum" and torch.is_grad_enabled() and t.requires_grad:
            return _AllReduceSum.apply(
                t, tuple(groups), self.log,
                tuple((a, self.mesh.shape[a]) for a in names)) \
                if groups else t
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


def _record(log, kind: str, t, axis: str, n: int,
            result_scale: float = 1.0) -> None:
    """Append one collective over ``axis`` (``n`` positions) of operand
    ``t`` to ``log`` (None: not recording): the bytes of its result,
    ``result_scale`` times the operand's."""
    if log is not None:
        nbytes = int(t.numel() * t.element_size() * result_scale)
        log.append((kind, nbytes, n, axis))


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter (sum)."""

    @staticmethod
    def forward(fc, t, group, n: int, dim: int, log=None, axis=None):
        fc.group, fc.n, fc.dim, fc.log, fc.axis = group, n, dim, log, axis
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(fc, g):
        _check_transport(g, fc.group)
        _record(fc.log, "reduce-scatter", g, fc.axis, fc.n, 1 / fc.n)
        return (_reduce_scatter(g, fc.group, fc.n, fc.dim), None, None, None,
                None, None)


def _reduce_scatter(t, group, n: int, dim: int):
    """Sum over ``group`` and keep this rank's block along ``dim``."""
    whole = t.movedim(dim, 0).contiguous()             # the n blocks in turn
    out = torch.empty((whole.shape[0] // n,) + whole.shape[1:],
                      dtype=t.dtype, device=t.device)
    from repro_torch.core.collective_bench import _library
    _library("reduce_scatter_single", "reduce_scatter_tensor")(
        out, whole, group=group)
    return out.movedim(0, dim)


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(fc, t, group, n: int, dim: int, log=None, axis=None):
        fc.group, fc.n, fc.dim, fc.log, fc.axis = group, n, dim, log, axis
        return _reduce_scatter(t, group, n, dim)

    @staticmethod
    def backward(fc, g):
        _check_transport(g, fc.group)
        _record(fc.log, "all-gather", g, fc.axis, fc.n, fc.n)
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(fc.n)]
        dist.all_gather(parts, g, group=fc.group)
        return torch.cat(parts, dim=fc.dim), None, None, None, None, None


class _MeanEqual(torch.autograd.Function):
    """The mean all-reduce of equal values: forward the value; backward
    the mean all-reduce (float32) of the gradient."""

    @staticmethod
    def forward(fc, t, group, n: int, log=None, axis=None):
        fc.group, fc.n, fc.log, fc.axis = group, n, log, axis
        return t.view_as(t)

    @staticmethod
    def backward(fc, g):
        _check_transport(g, fc.group)
        out = g.to(torch.float32)           # a new tensor: g is bfloat16
        out = out.clone() if out is g else out
        _record(fc.log, "all-reduce", out, fc.axis, fc.n)
        dist.all_reduce(out, group=fc.group)
        return (out / fc.n).to(g.dtype), None, None, None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum all-reduce over each group in turn; backward: the same."""

    @staticmethod
    def forward(fc, t, groups, log=None, axes=()):
        fc.groups, fc.log, fc.axes = groups, log, axes
        out = t.clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(fc, g):
        out = g.clone()
        for group, (axis, n) in zip(fc.groups, fc.axes):
            _check_transport(out, group)
            _record(fc.log, "all-reduce", out, axis, n)
            dist.all_reduce(out, group=group)
        return out, None, None, None


class _PartialProduct(torch.autograd.Function):
    """``a @ w`` of bf16 operands with its products summed in float32 and
    left unrounded (cuBLAS's bf16 product with a float32 output on the
    card, and on the dry run's meta tensors; the CPU widens the operands);
    backward: the bf16 products of a bf16 matmul's backward."""

    @staticmethod
    def forward(fc, a, w):
        fc.save_for_backward(a, w)
        a2 = a.reshape(-1, a.shape[-1])
        if a2.device.type != "cpu":
            out = torch.mm(a2, w, out_dtype=torch.float32)
        else:
            out = a2.to(torch.float32) @ w.to(torch.float32)
        return out.reshape(*a.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(fc, g):
        a, w = fc.saved_tensors
        g = g.to(a.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        return g @ w.T, a.reshape(-1, a.shape[-1]).T @ g2


def gather_tree(ctx, tree, specs, keep: Sequence[str] = ()):
    """Every leaf of ``tree`` (a rank's parameters, each held whole or as
    its ``ShardCtx.spec`` block) whole, but for the mesh axes in ``keep``:
    all-gathered over the other axes it is split on (ZeRO-3, at use; under
    autograd the gradient of each block is the sum of every rank's).
    ``keep=("model",)`` leaves each leaf its ``model`` block, the layer's
    tensor-parallel share (``TP``).  Outside autograd a leaf of two dims or
    more is cast to bfloat16 before it is gathered (every model reads such
    a leaf through ``cast_compute``: the same values, half the bytes).
    ``specs``: the matching tree of ``ParamSpec`` (the whole shape and
    logical axes of each leaf); a leaf whose spec is None, or absent, stays
    as it is.  ``ctx`` None, or a mesh of one position, returns ``tree``
    itself."""
    if ctx is None or ctx.n_ranks == 1:
        return tree

    def one(t, spec):
        moved = [(dim, a) for dim, e in enumerate(spec)
                 for a in reversed(entry_axes(e))
                 if a not in keep and ctx.mesh.shape[a] > 1]
        if moved and t.ndim >= 2 and not (torch.is_grad_enabled()
                                          and t.requires_grad):
            t = t.to(torch.bfloat16)
        for dim, a in moved:
            t = ctx.all_gather(t, a, dim)
        return t

    def walk(t, s):
        if isinstance(t, dict):
            s = s or {}
            return {k: walk(v, s.get(k)) for k, v in t.items()}
        if s is None:
            return t
        return one(t, ctx.held_spec(t, s.shape, s.axes))
    return walk(tree, specs)


# ---------------------------------------------------------------------------
# Tensor and sequence parallelism over ``model``
# ---------------------------------------------------------------------------

TP_AXIS = "model"


def rank_block(ctx, logical: str, size: int, rank: Optional[int] = None
               ) -> tuple[int, int]:
    """(start, length) of the ``model`` block of a dim of ``size`` under
    ``logical`` that rank ``rank`` of the ``model`` line holds (this
    rank's where None): the whole dim where the rules do not put it on
    ``model`` (the fallback recorded once in ``ctx.fallbacks``)."""
    if ctx is None or TP_AXIS not in ctx.mesh.axis_names \
            or ctx.block_spec((size,), (logical,)) != (TP_AXIS,):
        return 0, size
    n = ctx.mesh.shape[TP_AXIS]
    if rank is None:
        rank = ctx.coord((TP_AXIS,))
    return rank * (size // n), size // n


@dataclass(frozen=True)
class Heads:
    """A rank's share of one attention, as the reference's
    ``_constrain_qkv`` resolves it: query heads ``[q0, q0 + nq)``
    (``act_heads``); the KV heads it projects and caches, ``[kv0, kv0 +
    nkv)`` (``kv_heads``: its ``wk`` / ``wv`` block, or every KV head where
    ``kv_heads`` falls back to whole); ``kv_of_q``, where the projected KV
    heads are not the local query heads' own groups (a fallback of
    ``kv_heads`` only: phi3's 10 KV heads over 4 give a rank query heads
    10-19, of KV heads 2-4), the projected KV head each local query head
    reads, else None.  ``nq_seq`` (the sequence mode, where ``act_heads``
    does not resolve and the sequence is split over ``act_seq``): the rank
    computes every head for the query rows ``[q0_seq, q0_seq + nq_seq)``
    of the sequence, against the keys up to the block's end; None: the
    whole sequence."""
    n_heads: int
    n_kv: int
    q0: int
    nq: int
    kv0: int
    nkv: int
    kv_of_q: Optional[tuple[int, ...]]
    q0_seq: int = 0
    nq_seq: Optional[int] = None

    @property
    def split(self) -> bool:
        """The heads are split over ``model``: the out projection's output
        is a partial sum."""
        return self.nq < self.n_heads

    @property
    def seq(self) -> bool:
        """The queries' sequence is split over ``model`` (every head on
        every rank, no reduction of the output)."""
        return self.nq_seq is not None

    def for_attention(self, k, v):
        """The (k, v) the local query heads attend to, from the projected
        KV heads (B, S, nkv, D): themselves, or one KV head a query head
        (``kv_of_q``: G = 1, a copy)."""
        if self.kv_of_q is None:
            return k, v
        idx = torch.tensor(self.kv_of_q, device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx)


def rank_heads(ctx, n_heads: int, n_kv: int, rank: Optional[int] = None,
               seq_len: int = 0) -> Heads:
    """The query and KV heads rank ``rank`` of the ``model`` line computes
    (this rank's where None), by the reference's resolution: where
    ``act_heads`` resolves the query heads are split, and the KV heads
    too where ``kv_heads`` resolves; else the rank projects every KV head
    and its query heads read theirs (``Heads.kv_of_q``).  Where
    ``act_heads`` does not resolve (phi3's 40 heads over 16) the reference
    splits the attention's sequence over ``act_seq`` instead: given the
    ``seq_len`` of a sequence that ``act_seq`` splits (0: none), the rank
    takes every head for its block of the queries (``Heads.nq_seq``);
    without it every head on the whole sequence.  Each fallback is
    recorded once in ``ctx.fallbacks``."""
    q0, nq = rank_block(ctx, "act_heads", n_heads, rank)
    kv0, nkv = ((0, n_kv) if nq == n_heads
                else rank_block(ctx, "kv_heads", n_kv, rank))
    g = n_heads // n_kv
    kv_of_q = (None if nkv * g == nq
               else tuple((q0 + i) // g for i in range(nq)))
    q0_seq, nq_seq = 0, None
    if nq == n_heads and seq_len:
        q0_seq, nq_seq = rank_block(ctx, "act_seq", seq_len, rank)
        if nq_seq == seq_len:
            q0_seq, nq_seq = 0, None
    return Heads(n_heads, n_kv, q0, nq, kv0, nkv, kv_of_q, q0_seq, nq_seq)


@dataclass(frozen=True)
class TP:
    """One forward pass's tensor- and sequence-parallel plan over
    ``model``: ``n`` positions (1: nothing splits, every method the
    identity), this rank's ``rank`` among them, and ``seq``: the residual
    stream is this rank's block of the sequence (``act_seq`` resolved)
    of ``seq_len`` positions."""
    ctx: Any = None
    n: int = 1
    rank: int = 0
    seq: bool = False
    seq_len: int = 0

    def heads(self, n_heads: int, n_kv: int, split_seq: bool = False
              ) -> Heads:
        """The rank's ``Heads``; ``split_seq``: the caller computes the
        sequence mode where the heads fall back (a causal self-attention
        on the residual stream's block), else every head on the whole
        sequence."""
        return rank_heads(self.ctx if self.n > 1 else None, n_heads, n_kv,
                          seq_len=self.seq_len if self.seq and split_seq
                          else 0)

    def block(self, logical: str, size: int) -> tuple[int, int]:
        """(start, length) of this rank's block of a ``logical`` dim."""
        return rank_block(self.ctx if self.n > 1 else None, logical, size)

    def splits(self, logical: str, size: int) -> bool:
        return self.block(logical, size)[1] < size

    def gather_seq(self, x, dim: int = 1):
        """The whole sequence of a residual-stream block (an all-gather
        over ``model``), before a column split.  Without sequence
        parallelism the stream is whole on every rank: under autograd it
        passes ``ShardCtx.mean_equal``, so that each rank's gradient of it
        is the sum over ``model`` (over M), as the gather's
        reduce-scatter gives it, and not the rank's own part."""
        if self.seq:
            return self.ctx.all_gather(x, TP_AXIS, dim)
        if self.n > 1 and torch.is_grad_enabled() and x.requires_grad:
            return self.ctx.mean_equal(x, TP_AXIS)
        return x

    def scatter_seq(self, x, dim: int = 1):
        """This rank's block of a whole sequence (no collective)."""
        if not self.seq:
            return x
        b = x.shape[dim] // self.n
        return x.narrow(dim, self.rank * b, b)

    def reduce(self, y, split: bool = True, dtype=None):
        """Partial sums back on the residual stream: summed over
        ``model`` in float32, all-reduced or reduce-scattered to this
        rank's sequence block, in ``dtype`` (``y``'s where None); an
        output that is not ``split`` (the layer computed whole) only takes
        the sequence block."""
        dtype = dtype or y.dtype
        if self.n == 1 or not split:
            return self.scatter_seq(y.to(dtype))
        out = y.to(torch.float32)
        if self.seq:
            out = self.ctx.reduce_scatter(out, TP_AXIS, 1)
        else:
            out = self.ctx.all_reduce(out, (TP_AXIS,))
        return out.to(dtype)

    def row(self, a, w, split: bool, dtype=torch.bfloat16):
        """A row split on the residual stream, ``a`` (..., K) @ ``w`` (K,
        N), bf16 operands, in ``dtype``: where ``split`` (``a`` and ``w``
        this rank's blocks of K) the rank's partial product in float32,
        summed by ``reduce`` and rounded once; else the bf16 product, as
        one device computes it, of which the rank keeps its sequence
        block (``a`` the whole sequence: a ``Heads.seq`` layer's output
        is already the block and goes through ``NO_TP.row``)."""
        if self.n == 1 or not split:
            return self.scatter_seq((a @ w).to(dtype))
        return self.reduce(_PartialProduct.apply(a, w), True, dtype)

    def sum(self, t):
        """``t`` summed over ``model`` (a statistic of split features)."""
        return self.ctx.all_reduce(t, (TP_AXIS,)) if self.n > 1 else t


NO_TP = TP()


def tp_plan(ctx, seq_len: int) -> TP:
    """The plan of a forward pass over ``seq_len`` positions on ``ctx``'s
    mesh (``NO_TP`` for None or a ``model`` axis of one position); a
    ``model`` axis without its process group raises."""
    if ctx is None or TP_AXIS not in ctx.mesh.axis_names \
            or ctx.mesh.shape[TP_AXIS] == 1:
        return NO_TP
    seq = ctx.block_spec((seq_len,), ("act_seq",)) == (TP_AXIS,)
    return TP(ctx, ctx.mesh.shape[TP_AXIS], ctx.coord((TP_AXIS,)), seq,
              seq_len)


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
