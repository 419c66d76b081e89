"""Multi-pod dry run: one rank's step of every (arch x shape) cell on the
production meshes, traced on meta tensors in a fake 256- or 512-rank world,
with its roofline terms and memory fit (counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k --mesh single

The reference lowers and compiles each cell for 512 placeholder host
devices and reads XLA's cost and memory analyses.  The port runs the same
step (``train.step.make_train_step`` / ``make_prefill_step`` /
``make_decode_step``) once, eagerly, as one rank of the production mesh
(``launch.mesh.make_production_mesh``): the world is
``torch.distributed``'s ``fake`` backend (a ``FakeStore``, every collective
a no-op that moves no data), and every parameter, moment, batch and cache
is a tensor of the rank's held block (``ShardCtx.spec``) on the ``meta``
device: shapes and dtypes, no data, nothing allocated, and the step takes
the card's code paths, not the CPU's.  (``FakeTensorMode`` over the same
tensors gives the same counts 3.5x slower, 83 s against 24 s for
granite-3-2b x train_4k on an 8-core x86 CPU; fake ``cuda`` tensors
cannot train on a CPU-only PyTorch, which has no CUDA device guard for
autograd.)  Serving holds bfloat16
weights, as the reference's dry run does; the moments are in
``variant.adam_dtype``, the decode cache's bfloat16 entries in
``variant.kv_cache_dtype``.  The rank traced is the one whose ``model``
coordinate is the last (pod 0, data 0): where the attention splits its
queries' sequence (``sharding.Heads.seq``) it attends the most keys.

What is counted, for that rank:

- FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  of which XLA's count differs by the elementwise work it adds);
- the memory term by ``roofline.model_bytes.analytic_bytes``, as the
  reference's probe and table use it (``launch.probe`` adds the no-fusion
  upper bound);
- the collectives from ``ShardCtx.recording``'s log, each by the bytes of
  its result, over the axis it runs on;
- ``peak_device_bytes`` by ``torch.distributed._tools.mem_tracker.
  MemTracker`` (the held state, the activations and the temporaries at
  their peak), and ``fits_hbm`` against the H100's 80 GB
  (``roofline.analyze.HBM_BYTES``, the spec's DRAM level);
- ``attention_flops``: one layer's attention forward (``gqa_attention`` /
  ``gqa_prefill``) of the rank, times the layers, beside the same function
  on the whole ``model`` line's work as one device computes it.

Each record goes to ``artifacts/torch/dryrun/<arch>__<shape>__<pod1|pod2>
__<variant>.json``; a failing cell is recorded as ``status: error`` with
its traceback.  The fake world is process-wide: run this as a program (or
in a subprocess), never beside another ``torch.distributed`` world.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, get_arch, list_archs, param_count
from repro_torch.roofline.analyze import HBM_BYTES, CollectiveOp, analyze

ART = Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "dryrun"
#: the card's memory: the H100 spec's DRAM level (80 GB)
HBM_PER_DEVICE = HBM_BYTES
#: where the step's tensors live: not the CPU (its code paths differ from
#: the card's), nothing allocated
DEVICE = "meta"


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

def fake_world(world_size: int, rank: int) -> None:
    """A ``torch.distributed`` world of ``world_size`` ranks on the
    ``fake`` backend, this process rank ``rank`` (a world set up before is
    taken down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def fake_ctx(shape: tuple[int, ...], axes: tuple[str, ...], variant,
             mesh_fn=None):
    """A mesh of ``shape`` over ``axes`` on a fake world of its size, as
    the rank whose ``model`` coordinate is the last (the others 0):
    (ShardCtx with the variant's rules, rank).  ``mesh_fn`` makes the
    mesh over the world (``launch.mesh.make_mesh`` by default)."""
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.variant import apply_rules
    rank = shape[axes.index("model")] - 1 if "model" in axes else 0
    fake_world(math.prod(shape), rank)
    mesh = (mesh_fn() if mesh_fn is not None
            else make_mesh(shape, axes, device="cpu"))
    return apply_rules(ShardCtx(mesh), variant), rank


def production_ctx(multi_pod: bool, variant):
    """The reference's production mesh (``launch.mesh.
    make_production_mesh``: (16, 16) over (data, model), or (2, 16, 16)
    over (pod, data, model)) on a fake world of 256 or 512 ranks."""
    from repro_torch.launch.mesh import make_production_mesh
    shape, axes = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                   else ((16, 16), ("data", "model")))
    return fake_ctx(shape, axes, variant, lambda: make_production_mesh(
        multi_pod=multi_pod, device="cpu"))


# ---------------------------------------------------------------------------
# the rank's inputs, as meta tensors
# ---------------------------------------------------------------------------

def _block(ctx, shape, axes, keep=None) -> tuple[int, ...]:
    """The rank's block of a whole ``shape`` under the rules (split only
    over the mesh axes in ``keep``, where given: a leaf as the models
    gather it)."""
    from repro_torch.distributed.sharding import entry_axes
    spec = ctx.spec(shape, axes)
    spec = spec + (None,) * (len(shape) - len(spec))
    return tuple(n // ctx.axis_size(*(a for a in entry_axes(e)
                                      if keep is None or a in keep))
                 for n, e in zip(shape, spec))


def held_params(cfg, ctx, dtype=None) -> dict:
    """Every parameter as the rank's held block (``registry.held_axes``),
    in its spec's dtype or ``dtype``."""
    from repro_torch.models.common import spec_map
    from repro_torch.models.registry import build
    return spec_map(lambda s: torch.empty(
        _block(ctx, s.shape, s.axes), dtype=dtype or s.dtype,
        device=DEVICE), build(cfg).param_specs())


def _batch_rows(ctx, B: int) -> int:
    """The rows of a global batch of ``B`` this rank holds: its block over
    the data axes, or every row where they do not divide it."""
    dp = ctx.axis_size(*ctx.dp_axes)
    return B // dp if B % dp == 0 else B


def batch_block(cfg, shape, ctx) -> dict:
    """The step's batch as the rank's block over the data axes."""
    from repro_torch.models.registry import input_abstract
    batch, _ = input_abstract(cfg, shape)
    rows = _batch_rows(ctx, shape.global_batch)
    return {k: torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                           device=DEVICE) for k, t in batch.items()}


def seq_shard_decode(cfg, shape, ctx) -> bool:
    """The hybrid decodes over a sequence-sharded cache where the batch
    does not divide over the data axes (the reference's rule)."""
    return cfg.family == "hybrid" and \
        shape.global_batch % ctx.axis_size(*ctx.dp_axes) != 0


def held_cache(cfg, shape, ctx, kv_dtype) -> dict:
    """The decode cache as the rank holds it, the layout the port's
    prefill hands the decode: the batch block; attention caches of the KV
    heads the rank projects (``Heads``; for the hybrid's sequence-sharded
    decode ``flash_decode.cache_spec``'s block); an SSM layer's state and
    ``conv_x`` at the rank's SSD heads / inner dims; mla's latent cache
    whole.  bfloat16 entries in ``kv_dtype``."""
    from repro_torch.distributed.sharding import tp_plan
    from repro_torch.models.registry import cache_abstract
    from repro_torch.models.ssm import keep_model, ssm_dims
    from repro_torch.serve import flash_decode
    B, S = shape.global_batch, shape.seq_len
    rows = _batch_rows(ctx, B)
    tp = tp_plan(ctx, 1)
    heads = (tp.heads(cfg.n_heads, cfg.n_kv_heads) if cfg.n_kv_heads
             else None)                   # an SSM has no attention cache
    seq = seq_shard_decode(cfg, shape, ctx)
    n_seq, tp_n = flash_decode._split(ctx, cfg)
    whole, axes = cache_abstract(cfg, B, S)

    def leaf(name, t, ax):
        shp = list(t.shape)
        for i, a in enumerate(ax):
            if a == "batch":
                shp[i] = rows
            elif a == "kv_heads":
                shp[i] = cfg.n_kv_heads // tp_n if seq else heads.nkv
            elif a == "kv_seq" and seq:
                shp[i] //= n_seq
        if cfg.ssm is not None and keep_model(cfg, tp):
            d_in, H = ssm_dims(cfg)
            if name == "state":
                shp[ax.index("heads")] = tp.block("heads", H)[1]
            elif name == "conv_x":
                shp[ax.index("inner")] = tp.block("inner", d_in)[1]
        dtype = kv_dtype if t.dtype == torch.bfloat16 else t.dtype
        return torch.zeros(shp, dtype=dtype, device=DEVICE)

    def walk(t, ax, name=""):
        if isinstance(t, dict):
            return {k: walk(v, ax[k], k) for k, v in t.items()}
        return leaf(name, t, ax)
    return walk(whole, axes)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

class _BytesUpper(torch.utils._python_dispatch.TorchDispatchMode):
    """Every op's operand and result bytes, summed (no fusion)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.total += t.numel() * t.element_size()
        return out


def step_fn(cfg, shape, ctx, variant, forward_only: bool = False):
    """(the cell's step on the rank's inputs, meta tensors, as a thunk;
    those inputs: {"params", "batch"[, "opt" | "cache"]}).
    ``forward_only`` (training): the loss alone, recorded by autograd as
    the step records it, no backward, no update."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                        make_train_step)
    batch = batch_block(cfg, shape, ctx)
    if shape.kind == "train" and forward_only:
        from repro_torch.models.registry import build
        params = held_params(cfg, ctx)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        model = build(cfg)
        state = {"params": params, "batch": batch}
        run = lambda: model.loss(params, batch, ctx, variant)  # noqa: E731
    elif shape.kind == "train":
        params = held_params(cfg, ctx)
        opt = adamw.init_state(params, variant.adam_dtype)
        fn = make_train_step(cfg, ctx, variant=variant)
        state = {"params": params, "opt": opt, "batch": batch}
        run = lambda: fn(params, opt, batch)  # noqa: E731
    else:
        params = held_params(cfg, ctx, torch.bfloat16)
        if shape.kind == "prefill":
            fn = make_prefill_step(cfg, ctx, variant=variant)
            state = {"params": params, "batch": batch}
            run = lambda: fn(params, batch)  # noqa: E731
        else:
            cache = held_cache(cfg, shape, ctx,
                               getattr(torch, variant.kv_cache_dtype))
            fn = make_decode_step(cfg, ctx, variant=variant,
                                  seq_shard_decode=seq_shard_decode(
                                      cfg, shape, ctx))
            state = {"params": params, "cache": cache, "batch": batch}
            run = lambda: fn(params, cache, batch, shape.seq_len - 1)  # noqa: E731
    return run, state


def _nbytes(tree) -> int:
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def trace(cfg, shape, ctx, variant, memory: bool = True,
          bytes_upper: bool = False, forward_only: bool = False) -> dict:
    """One run of the cell's step as this rank, on meta tensors
    (``step_fn``): its FLOPs, the collectives it issued, the bytes of its
    inputs and parameters, (``memory``) the peak of the bytes it holds and
    (``bytes_upper``) every op's operand and result bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.common import tree_leaves
    run, state = step_fn(cfg, shape, ctx, variant, forward_only)
    counter = FlopCounterMode(display=False)
    modes = [counter]
    if bytes_upper:
        upper = _BytesUpper()
        modes.append(upper)
    if memory:
        from torch.distributed._tools.mem_tracker import MemTracker
        tracker = MemTracker()
        tracker.track_external(*tree_leaves(state))
        modes.append(tracker)
    with ctx.recording() as log, contextlib.ExitStack() as stack:
        for m in modes:
            stack.enter_context(m)
        run()
    out = {"flops": float(counter.get_total_flops()),
           "collectives": [CollectiveOp(kind, nbytes, n)
                           for kind, nbytes, n, _ in log],
           "held_bytes": _nbytes(state),
           "param_bytes": _nbytes(state["params"])}
    if bytes_upper:
        out["hbm_bytes_upper"] = float(upper.total)
    if memory:
        peak = tracker.get_tracker_snapshot("peak")
        out["peak_device_bytes"] = int(max(
            (d.get("Total", 0) for d in peak.values()), default=0))
    return out


def attention_flops(cfg, shape, ctx, variant) -> dict | None:
    """The forward FLOPs of one layer's causal attention as this rank
    computes it (``gqa_attention`` in training, ``gqa_prefill`` in the
    prefill), and as one device computes the same data block's whole
    attention, each times the attention layers; None where the cell has
    no such attention (decode, mla, ssm, encdec)."""
    if shape.kind == "decode" or not cfg.n_heads or cfg.mla is not None \
            or cfg.family in ("ssm", "encdec"):
        return None
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed.sharding import NO_TP, TP_AXIS, tp_plan
    from repro_torch.models import attention as attn
    from repro_torch.models.attention import gqa_specs, rope_freqs
    S, D = shape.seq_len, cfg.d_model
    rows = _batch_rows(ctx, shape.global_batch)
    layers = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
              else cfg.n_layers)
    out = {}
    with torch.no_grad():
        for side, tp in (("rank", tp_plan(ctx, S)), ("one_device", NO_TP)):
            p = {k: torch.empty(s.shape if tp is NO_TP else
                                _block(ctx, s.shape, s.axes, (TP_AXIS,)),
                                dtype=torch.bfloat16, device=DEVICE)
                 for k, s in gqa_specs(cfg, D).items()}
            n = S // tp.n if tp.seq else S
            x = torch.empty((rows, n, D), dtype=torch.bfloat16,
                            device=DEVICE)
            pos = torch.arange(S, device=DEVICE)
            with ctx.recording(), FlopCounterMode(display=False) as fc:
                if shape.kind == "train":
                    attn.gqa_attention(cfg, p, x, positions=pos,
                                       kv_block=variant.kv_block, tp=tp)
                else:
                    attn.gqa_prefill(
                        cfg, p, x, pos, rope_freqs(
                            cfg.resolved_head_dim, cfg.rope_pct,
                            cfg.rope_theta, device=DEVICE),
                        tp=tp, kv_block=variant.kv_block)
            out[side] = float(fc.get_total_flops()) * layers
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def model_flops(cfg, shape, n_devices: int) -> float:
    """The useful FLOPs a device: 6 (train) or 2 (serving) x active
    parameters x tokens, over the devices."""
    _, active = param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return (6 if shape.kind == "train" else 2) * active * tokens / n_devices


def hbm_model_bytes(cfg, shape, ctx, variant) -> float:
    from repro_torch.roofline.model_bytes import analytic_bytes
    return analytic_bytes(
        cfg, shape, ctx.n_ranks, tp=ctx.axis_size("model"),
        dp=ctx.axis_size(*ctx.dp_axes),
        cache_bytes_per_elem=getattr(torch, variant.kv_cache_dtype).itemsize,
        train_passes=3 if variant.remat == "full" else 2)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant_name: str) -> dict:
    from repro_torch.models.variant import VARIANTS
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, reason = cfg.supports_shape(shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "variant": variant_name, "status": "skipped",
                "reason": reason}
    variant = VARIANTS[variant_name]
    ctx, rank = production_ctx(multi_pod, variant)
    t0 = time.time()
    counts = trace(cfg, shape, ctx, variant)
    t_trace = time.time() - t0
    attn = attention_flops(cfg, shape, ctx, variant)
    n_dev = ctx.n_ranks
    total, active = param_count(cfg)
    record = {"flops": counts["flops"],
              "hbm_bytes": hbm_model_bytes(cfg, shape, ctx, variant),
              "collectives": counts["collectives"],
              "peak_device_bytes": counts["peak_device_bytes"],
              "arg_bytes": counts["held_bytes"],
              "param_bytes": counts["param_bytes"]}
    rec = analyze(record, model_flops=model_flops(cfg, shape, n_dev))
    rec.update({
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "variant": variant_name, "status": "ok", "rank": rank,
        "mesh": dict(ctx.mesh.shape), "n_devices": int(n_dev),
        "params_total": total, "params_active": active,
        "tokens_per_step": shape.global_batch * (
            shape.seq_len if shape.kind != "decode" else 1),
        "fits_hbm": counts["peak_device_bytes"] <= HBM_PER_DEVICE,
        "trace_s": round(t_trace, 1),
        "sharding_fallbacks": sorted(set(ctx.fallbacks)),
        "attention_flops": attn,
    })
    return rec


def cell_path(arch, shape_name, multi_pod, variant, art: Path = ART) -> Path:
    mesh_tag = "pod2" if multi_pod else "pod1"
    return art / f"{arch}__{shape_name}__{mesh_tag}__{variant}.json"


def run_cell(arch, shape_name, multi_pod, variant, force=False,
             art: Path = ART) -> dict:
    out = cell_path(arch, shape_name, multi_pod, variant, art)
    if out.exists() and not force:
        return json.loads(out.read_text())
    try:
        rec = lower_cell(arch, shape_name, multi_pod, variant)
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "variant": variant, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=2, default=float))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default without "
                         "--arch / --shape)")
    ap.add_argument("--force", action="store_true",
                    help="trace again over a record already written")
    ap.add_argument("--out-dir", default=str(ART))
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    errors = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape, mp, args.variant,
                               force=args.force, art=Path(args.out_dir))
                status = rec.get("status")
                tag = (f"{arch} x {shape} x {'pod2' if mp else 'pod1'} x "
                       f"{args.variant}")
                if status == "ok":
                    print(f"[ok]   {tag}: dominant={rec['dominant']} "
                          f"t=({rec['t_compute_s']:.4f},"
                          f"{rec['t_memory_s']:.4f},"
                          f"{rec['t_collective_s']:.4f})s "
                          f"peak={rec['peak_device_bytes'] / 2**30:.2f}GiB "
                          f"fits={rec['fits_hbm']} "
                          f"({time.time() - t0:.0f}s)", flush=True)
                elif status == "skipped":
                    print(f"[skip] {tag}: {rec['reason']}", flush=True)
                else:
                    errors += 1
                    print(f"[ERR]  {tag}: {rec['error']}", flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
