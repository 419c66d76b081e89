"""Shared harness of ``tests/test_torch_train_mesh*.py``: the port's train
step on a mesh of gloo ranks against the reference's SPMD step on forced
host devices, on the CPU.

``run_cases(out, cases)`` draws every case's inputs here (the reference's
``init_params`` with key 0, a batch from a seeded numpy generator, whisper's
frames bfloat16 values held in float32), then runs the reference in one
subprocess on 8 forced host devices (``jax.value_and_grad(model.loss)``
under the case's mesh, compiled with ``xla_allow_excess_precision`` off,
as ``tests/test_system.py`` places parameters and the reference's pipeline
places the batch; ``adamw.global_norm`` and ``compress_grads`` of its
gradients) and then the port in one ``launch_local`` gloo world as large
as the largest mesh, one thread a rank.  Each port rank holds the
parameters as ``registry.shard_params`` blocks and its block of the batch
(``ShardCtx.spec`` of ("batch", ...)), runs ``make_train_step``, and
records the gradients the step hands AdamW (gathered whole), the global
metrics and the bytes it holds.  moe cases: the reference's routing is
recorded outside its ``shard_map`` (the router replicated, so each row's
logits are the body's), one entry a layer by the router's sum, and the
port routes each rank's tokens with the reference's choices for its rows
(a differing choice must be a near-tie: within NEAR_TIE of the larger
logit, 16 bf16 unit roundoffs, twice ``tests/test_torch_moe.py``'s 8: the
reference's SPMD step rounds its partitioned products elsewhere, and the
second layer's input parts further from the port's; measured, reduced
deepseek on (1, 2, 2), 3 tokens of 1024 differ, the widest 9.2).

An arch of a case may carry an override, "<arch>+<tag>": the reduced
config with ``OVERRIDES[tag]``'s fields replaced, on both sides (e.g.
``granite-3-2b+h6kv2``: 6 query and 2 KV heads, which do not divide a
``model`` axis of 4).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

import repro.models.common as j_common
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.models.registry import build as j_build
from repro_torch.bench import distributed as dist
from repro_torch.core.device import CPU_DEVICES_ENV

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
#: the limits of tests/test_torch_train.py
LOSS_RTOL = 2e-3
GRAD_RMS_TOL = 2e-2
#: tokens a rank's batch holds: (global batch, sequence)
B, S = 8, 64
ENV_ALL = (dist.ENV_COORDINATOR + dist.ENV_NUM_PROCESSES
           + dist.ENV_PROCESS_ID)
#: "<arch>+<tag>" -> the reduced config's fields replaced
OVERRIDES = {"h6kv2": {"n_heads": 6, "n_kv_heads": 2}}
#: config(arch) in the templates (``reduced`` and ``get_arch`` are the
#: side's own)
CONFIG = '''
from dataclasses import replace as _replace
OVERRIDES = %r


def config(arch):
    base, _, tag = arch.partition("+")
    cfg = reduced(get_arch(base))
    return _replace(cfg, **OVERRIDES[tag]) if tag else cfg
''' % (OVERRIDES,)

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.models.moe as j_moe
from repro.configs import get_arch, reduced
from repro.distributed.sharding import ShardCtx, make_smoke_ctx
from repro.launch.mesh import make_mesh
from repro.models.common import abstract_params, logical_axes
from repro.models.registry import build
from repro.models.variant import BASELINE
from repro.optim import adamw
from repro.optim.compression import compress_grads, init_error

out, cases = sys.argv[1], %r
%s
inp = np.load(f"{out}/inputs.npz")
J_MOE = j_moe.moe_layer
log = []


def recording(ctx, cfg, p, x, **kw):
    r = jax.lax.with_sharding_constraint(p["router"],
                                         NamedSharding(ctx.mesh, P()))
    xf = x.reshape(-1, x.shape[-1]).astype(jnp.bfloat16)
    logits = (xf @ r.astype(jnp.bfloat16)).astype(jnp.float32)
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.top_k)
    jax.debug.callback(lambda lg, ti, fp: log.append(
        (np.asarray(lg), np.asarray(ti), float(fp))), logits, topi,
        jnp.sum(p["router"]))
    return J_MOE(ctx, cfg, p, x, **kw)


j_moe.moe_layer = recording


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [i for k in sorted(tree)
                for i in paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def unflat(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: unflat(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    return jnp.asarray(flat[prefix[:-1]])


res = {}
for arch, shape in cases:
    tag = f"{arch}/{'x'.join(map(str, shape))}"
    cfg = config(arch)
    model = build(cfg)
    specs = model.param_specs()
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"))
    ctx = ShardCtx(mesh)
    flat = {k[len(arch) + 1:]: inp[k] for k in inp.files
            if k.startswith(arch + "/p/")}
    params = unflat(specs, {k[2:]: v for k, v in flat.items()})
    params = jax.device_put(params, ctx.tree_shardings(
        abstract_params(specs), logical_axes(specs)))
    batch = {k: jnp.asarray(inp[f"{arch}/b/{k}"]) for k in
             ("tokens", "labels", "frames") if f"{arch}/b/{k}" in inp.files}
    if "frames" in batch:
        batch["frames"] = batch["frames"].astype(jnp.bfloat16)
    ax = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
          "frames": ("batch", None, None)}
    batch = {k: jax.device_put(v, ctx.sharding(v.shape, ax[k]))
             for k, v in batch.items()}
    vg = jax.value_and_grad(lambda p, b: model.loss(p, b, ctx, BASELINE),
                            has_aux=True)
    if cfg.moe is None:
        # the same step on one device: how far the mesh's own roundings
        # move the reference
        one = make_smoke_ctx()
        p1 = unflat(specs, {k[2:]: v for k, v in flat.items()})
        b1 = {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}
        vg1 = jax.value_and_grad(
            lambda p, b: model.loss(p, b, one, BASELINE), has_aux=True)
        with jax.set_mesh(one.mesh):
            _, g1 = jax.jit(vg1).lower(p1, b1).compile(compiler_options={
                "xla_allow_excess_precision": False})(p1, b1)
        for path, g in paths(g1):
            res[f"{tag}/g1/{path}"] = np.asarray(g, np.float32)
    log.clear()
    with jax.set_mesh(mesh):
        (loss, metrics), grads = jax.jit(vg).lower(params, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})(
                params, batch)
        gn = adamw.global_norm(grads)
        comp, _ = jax.jit(compress_grads)(grads, init_error(grads))
    res[f"{tag}/loss"] = np.float32(loss)
    res[f"{tag}/grad_norm"] = np.float32(gn)
    for k, v in metrics.items():
        res[f"{tag}/m/{k}"] = np.float32(v)
    for path, g in paths(grads):
        res[f"{tag}/g/{path}"] = np.asarray(g, np.float32)
    for path, g in paths(comp):
        res[f"{tag}/c/{path}"] = np.asarray(g, np.float32)
    if cfg.moe is not None:
        routers = np.asarray(params["blocks"]["moe"]["router"], np.float32)
        sums = routers.reshape(routers.shape[0], -1).sum(axis=1)
        for lg, ti, fp in log:
            layer = int(np.argmin(np.abs(sums - fp)))
            res[f"{tag}/route/{layer}/logits"] = lg
            res[f"{tag}/route/{layer}/topi"] = ti
np.savez(f"{out}/ref.npz", **res)
print("REF_OK")
"""

PORT = r"""
import json, os, signal, sys
import numpy as np
import torch
from repro_torch.bench import distributed as dist
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_reference
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, registry
from repro_torch.models.common import (spec_map, tree_leaves,
                                       tree_leaves_with_paths)
from repro_torch.optim import adamw, compression
from repro_torch.train import step as step_mod

out, cases, compress = sys.argv[1], %r, %r
%s
NEAR_TIE = 16 * 2.0 ** -8
dist.ensure_initialized("cpu")
rank = dist.process_index()
inp = np.load(f"{out}/inputs.npz")
ref = np.load(f"{out}/ref.npz") if any(
    config(a).moe is not None for a, _ in cases) else None
meshes, res, report = {}, {}, {}


def unflat(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: unflat(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    return flat[prefix[:-1]]


class Forced:
    # moe.route with the reference's choices for this rank's rows
    def __init__(self, tag, L, rows):
        self.tag, self.L, self.rows, self.calls = tag, L, rows, 0
        self.orig, self.forced = moe.route, 0

    def __call__(self, cfg, p, xf):
        probs, topv, topi = self.orig(cfg, p, xf)
        k = self.calls
        self.calls += 1
        layer = k if k < self.L else 2 * self.L - 1 - k
        lg = ref[f"{self.tag}/route/{layer}/logits"][self.rows]
        ti = ref[f"{self.tag}/route/{layer}/topi"][self.rows]
        K = cfg.moe.top_k
        diff = np.any(np.sort(ti, -1) != np.sort(topi.numpy(), -1), -1)
        srt = -np.sort(-lg, axis=-1)
        a, b = srt[:, K - 1], srt[:, K]
        ties = a - b <= NEAR_TIE * np.maximum(np.abs(a), np.abs(b))
        assert not np.any(diff & ~ties), (self.tag, layer)
        self.forced += int(diff.sum())
        topi = torch.from_numpy(ti).long()
        topv = torch.gather(probs, 1, topi)
        return probs, topv / torch.sum(topv, -1, keepdim=True), topi


def whole(ctx, tree, specs):
    flat = dict(tree_leaves_with_paths(specs))
    return {path: ctx.gather(t, ctx.held_spec(t, flat[path].shape,
                                              flat[path].axes))
            .float().numpy()
            for path, t in tree_leaves_with_paths(tree)}


for arch, shape in cases:
    shape = tuple(shape)
    tag = f"{arch}/{'x'.join(map(str, shape))}"
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("pod", "data", "model"),
                                  device="cpu")
    ctx = ShardCtx(meshes[shape])
    cfg = config(arch)
    model = registry.build(cfg)
    specs = model.param_specs()
    flat = {k[len(arch) + 3:]: inp[k] for k in inp.files
            if k.startswith(arch + "/p/")}
    batch = {k: torch.from_numpy(inp[f"{arch}/b/{k}"]) for k in
             ("tokens", "labels", "frames") if f"{arch}/b/{k}" in inp.files}
    batch = {k: (v.long() if k != "frames" else v.to(torch.bfloat16))
             for k, v in batch.items()}
    bspec = ctx.spec(batch["tokens"].shape, ("batch", "seq"))
    d = ctx.coord(ctx.split_axes(bspec))
    Bl = batch["tokens"].shape[0] // ctx.axis_size(*ctx.split_axes(bspec))
    block = {k: ctx.shard(v, ctx.spec(v.shape, ("batch",) + (None,) *
                                      (v.ndim - 1))) for k, v in batch.items()}
    seen = {}
    orig_apply, orig_comp = adamw.apply, compression.compress_grads

    def apply(cfg_, params, state, grads, *a):
        seen["grads"] = grads
        return orig_apply(cfg_, params, state, grads, *a)

    def comp(grads, error, *a):
        seen["before"] = grads
        return orig_comp(grads, error, *a)
    step_mod.adamw.apply, step_mod.compress_grads = apply, comp
    forced = None
    if cfg.moe is not None:
        T = Bl * batch["tokens"].shape[1]
        forced = Forced(tag, cfg.n_layers, slice(d * T, (d + 1) * T))
        moe.route = forced
    for with_comp in ((False, True) if compress else (False,)):
        params = registry.shard_params(cfg, params_from_reference(
            unflat(specs, flat)), ctx)
        opt = adamw.init_state(params)
        if with_comp:
            opt["ef_error"] = compression.init_error(params)
        if forced is not None:
            forced.calls = 0
        _, opt, m = step_mod.make_train_step(
            cfg, ctx, adamw.AdamWConfig(lr=1e-3),
            grad_compression=with_comp)(params, opt, block)
        key = f"{tag}/{'c' if with_comp else 'g'}"
        for path, g in whole(ctx, seen["grads"], specs).items():
            res[f"{key}/{path}"] = g
        if with_comp:
            for path, g in whole(ctx, seen["before"], specs).items():
                res[f"{tag}/before/{path}"] = g
        else:
            for k, v in m.items():
                res[f"{tag}/m/{k}"] = np.float32(v)
            rules = ctx.layout(spec_map(lambda s: torch.empty(
                s.shape, dtype=s.dtype, device="meta"), specs),
                registry.held_axes(cfg))
            report[tag] = {
                "held": sum(t.numel() * t.element_size() for tree in
                            (params, opt["mu"], opt["nu"])
                            for t in tree_leaves(tree)),
                "rules": 3 * sum(r["bytes_a_rank"] for r in rules.values()),
                "blocks": {p: list(t.shape)
                           for p, t in tree_leaves_with_paths(params)},
                "forced": forced.forced if forced is not None else 0,
                "routed": forced.calls if forced is not None else 0}
    if cfg.moe is None and rank == 0:
        # the port's own one-device step on the whole batch
        params = params_from_reference(unflat(specs, flat))
        step_mod.make_train_step(cfg, None, adamw.AdamWConfig(lr=1e-3))(
            params, adamw.init_state(params), batch)
        for path, g in tree_leaves_with_paths(seen["grads"]):
            res[f"{tag}/g1/{path}"] = g.float().numpy()
    step_mod.adamw.apply, step_mod.compress_grads = orig_apply, orig_comp
    if forced is not None:
        moe.route = forced.orig
if rank == 0:
    np.savez(f"{out}/port.npz", **res)
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(report, f)
"""


def env() -> dict:
    e = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
             OMP_NUM_THREADS="1")
    for k in ("XLA_FLAGS", CPU_DEVICES_ENV) + ENV_ALL:
        e.pop(k, None)
    return e


def inputs(path: Path, archs) -> None:
    """Every arch's reference parameters (key 0) and batch (numpy seed 1)
    as float32 / int32 arrays, keyed "<arch>/p/<leaf path>" and
    "<arch>/b/<name>"."""
    arrays = {}
    for arch in archs:
        base, _, t = arch.partition("+")
        jcfg = j_reduced(j_get_arch(base))
        if t:
            jcfg = dataclasses.replace(jcfg, **OVERRIDES[t])
        p = j_common.init_params(j_build(jcfg).param_specs(),
                                 jax.random.key(0))
        for keys, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            name = "/".join(k.key for k in keys)
            arrays[f"{arch}/p/{name}"] = np.asarray(leaf, np.float32)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        arrays[f"{arch}/b/tokens"] = tokens
        arrays[f"{arch}/b/labels"] = np.roll(tokens, -1, axis=1)
        if jcfg.family == "encdec":
            f = rng.standard_normal((B, jcfg.n_audio_ctx, jcfg.d_model)) * 0.02
            arrays[f"{arch}/b/frames"] = np.asarray(
                jax.numpy.asarray(f, jax.numpy.bfloat16), np.float32)
    np.savez(path, **arrays)


class _Sink:
    """A launch's output, line by line (an object that is always true:
    ``launch_local`` takes a false ``stream_to`` for none)."""

    def __init__(self):
        self.lines = []

    def write(self, s):
        self.lines.append(s)

    def flush(self):
        pass

    def text(self) -> str:
        return "".join(self.lines)


def run_cases(out: Path, cases, compress: bool = False) -> dict:
    """The reference, then the port (which reads the reference's routing),
    on ``cases`` [(arch, mesh shape)]: {"ref", "port" (rank 0's arrays),
    "rep" (every rank's report)}."""
    archs = sorted({a for a, _ in cases})
    inputs(out / "inputs.npz", archs)
    r = subprocess.run([sys.executable, "-c", REF % (cases, CONFIG),
                        str(out)],
                       capture_output=True, text=True, env=env(),
                       timeout=600)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-3000:]
    n = max(int(np.prod(s)) for _, s in cases)
    sink = _Sink()
    rc = dist.launch_local([sys.executable, "-c",
                            PORT % (cases, compress, CONFIG),
                            str(out)], processes=n, env=env(), timeout=600,
                           stream_to=sink, device="cpu")
    assert rc == 0, sink.text()[-4000:]
    return {"ref": dict(np.load(out / "ref.npz")),
            "port": dict(np.load(out / "port.npz")),
            "rep": [json.loads((out / f"rank{i}.json").read_text())
                    for i in range(n)]}


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def tag(arch, shape) -> str:
    return f"{arch}/{'x'.join(map(str, shape))}"


def grads(arrays, t, kind) -> dict:
    """{leaf path: gradient} of case ``t``: kind "g" the mesh step's, "g1"
    the one-device step's."""
    pre = f"{t}/{kind}/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


def hold_case(runs, arch, shape) -> None:
    """The loss and every metric within LOSS_RTOL of the reference's mesh
    step; every rank holds the rules' bytes of parameters and moments.
    Every gradient leaf: without moe, within GRAD_RMS_TOL of the port's
    own one-device step on the whole batch (the mesh adds only roundings),
    and within GRAD_RMS_TOL plus the reference's own distance between its
    mesh and one-device steps of the reference's mesh step (measured:
    the reference's SPMD step lies up to 4.5e-2 from its one-device step,
    zamba2's conv_B, where the port's mesh lies 2.7e-3 from its one
    device); with moe, whose mesh semantics differ from one device's
    (capacity per data shard), within GRAD_RMS_TOL of the reference's mesh
    step."""
    t = tag(arch, shape)
    ref, port = runs["ref"], runs["port"]
    rl, pl = float(ref[f"{t}/loss"]), float(port[f"{t}/m/loss"])
    assert abs(pl - rl) <= LOSS_RTOL * abs(rl), (t, pl, rl)
    for k in [k for k in ref if k.startswith(f"{t}/m/")]:
        want, got = float(ref[k]), float(port[k])
        assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1e-6), \
            (k, got, want)
    rg, pg = grads(ref, t, "g"), grads(port, t, "g")
    rg1, pg1 = grads(ref, t, "g1"), grads(port, t, "g1")
    assert rg.keys() == pg.keys() and rg
    if rg1:
        assert rg1.keys() == pg1.keys() == rg.keys()
        own = {p: rel_rms(pg[p], pg1[p]) for p in rg}
        worst = max(own, key=own.get)
        assert own[worst] <= GRAD_RMS_TOL, (t, "one device", worst,
                                            own[worst])
    slack = {p: rel_rms(rg[p], rg1[p]) if rg1 else 0.0 for p in rg}
    errs = {p: rel_rms(pg[p], rg[p]) - slack[p] for p in rg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RMS_TOL, (t, worst, errs[worst], slack[worst])
    for rep in runs["rep"][:int(np.prod(shape))]:
        assert rep[t]["held"] == rep[t]["rules"], (t, rep[t])
