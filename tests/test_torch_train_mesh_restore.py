"""Training on a mesh end to end, on the CPU: the ``Trainer`` over a
(1, 2, 2) gloo world interrupted by a SIGTERM on one rank and resumed on
one device, a checkpoint written on the (1, 2, 2) mesh restored onto one
device and onto (1, 4, 1) leaf for leaf (the reference's elastic restore,
``tests/test_system.py``), and ``launch.train --mesh 1,2,2 --device cpu``.

Limit: the resumed run's step-8 loss within 2e-3 relative of the
uninterrupted one-device run's (``tests/test_torch_train.py``'s loss
limit); the mesh's batches are one device's and its step computes what
one device's does, up to roundings.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _train_mesh import LOSS_RTOL, env
from repro_torch.bench import distributed as dist
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.models.common import tree_leaves_with_paths
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer

ARCH = "granite-3-2b"
SHAPE, STEPS, STOP = (4, 32), 8, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)

WORKER = r"""
import json, os, signal, sys
import numpy as np
import torch
from repro_torch.bench import distributed as dist
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import init_params, tree_leaves_with_paths
from repro_torch.models.registry import build, shard_params
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer

out, arch, shape, steps, stop, opt = sys.argv[1], %r, %r, %d, %d, %r
dist.ensure_initialized("cpu")
rank = dist.process_index()
mesh = make_mesh((1, 2, 2), ("pod", "data", "model"), device="cpu")
cfg = reduced(get_arch(arch))
tcfg = TrainConfig(steps=steps, ckpt_every=2, ckpt_dir=f"{out}/run",
                   log_every=1, opt=adamw.AdamWConfig(**opt))
tr = Trainer(cfg, shape, mesh, tcfg)
inner = tr.step_fn
calls = []


def step_fn(p, o, b):
    res = inner(p, o, b)
    calls.append(1)
    if len(calls) == stop and rank == 1:     # one rank takes the signal
        os.kill(os.getpid(), signal.SIGTERM)
    return res


tr.step_fn = step_fn
params, opt_state, hist = tr.train(resume=False)
report = {"steps_run": len(calls), "hist": hist,
          "latest": ckpt.latest_step(f"{out}/run")}
# the trained state, whole, and a checkpoint of it written on this mesh
ctx = tr.ctx
state = {"params": params, "opt": opt_state}
flat_specs = dict(tree_leaves_with_paths(tr.state_specs))
whole = {}
with torch.no_grad():
    for n, t in tree_leaves_with_paths(state):
        s = flat_specs.get(n)
        whole[n] = (t if s is None else
                    ctx.gather(t, ctx.held_spec(t, s.shape, s.axes))).numpy()
ckpt.save(f"{out}/elastic", 3, state, ctx=ctx, specs=tr.state_specs)
if rank == 0:
    np.savez(f"{out}/whole.npz", **{n.replace("/", "|"): v
                                    for n, v in whole.items()})
# restore onto (1, 4, 1) over the same world
mesh41 = make_mesh((1, 4, 1), ("pod", "data", "model"), device="cpu")
ctx41 = ShardCtx(mesh41)
like = shard_params(cfg, init_params(build(cfg).param_specs(),
                                     torch.Generator().manual_seed(9)), ctx41)
like = {"params": like, "opt": adamw.init_state(like)}
got, man = ckpt.restore(f"{out}/elastic", like, ctx=ctx41,
                        specs=tr.state_specs)
equal = []
for (n, t), (_, l) in zip(tree_leaves_with_paths(got),
                          tree_leaves_with_paths(like)):
    s = flat_specs.get(n)
    want = torch.from_numpy(whole[n])
    if s is not None:
        want = ctx41.shard(want, ctx41.held_spec(l, s.shape, s.axes))
    equal.append(bool(t.shape == l.shape and torch.equal(t, want)))
report["restored_41"] = {"step": man["step"], "all_equal": all(equal),
                         "leaves": len(equal),
                         "w_up": list(got["params"]["blocks"]["mlp"]
                                      ["w_up"].shape)}
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(report, f)
""" % (ARCH, SHAPE, STEPS, STOP, OPT)


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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh_restore")
    sink = _Sink()
    rc = dist.launch_local([sys.executable, "-c", WORKER, str(out)],
                           processes=4, env=env(), timeout=300,
                           stream_to=sink, device="cpu")
    assert rc == 0, sink.text()[-4000:]
    return out, [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(4)], sink.text()


def _one_device(ckpt_dir, resume: bool):
    cfg = reduced(get_arch(ARCH))
    tcfg = TrainConfig(steps=STEPS, ckpt_every=STEPS + 1,
                       ckpt_dir=str(ckpt_dir), log_every=1,
                       opt=adamw.AdamWConfig(**OPT))
    return Trainer(cfg, SHAPE, None, tcfg, device="cpu").train(
        resume=resume)


def test_a_sigterm_on_one_rank_stops_every_rank_and_saves(world):
    """Rank 1 takes the SIGTERM after step STOP - 1: every rank stops after
    the same step, every rank takes part in the emergency save, and rank 0
    alone keeps the history (global metrics, finite)."""
    _, reps, text = world
    assert {r["steps_run"] for r in reps} == {STOP}
    assert {r["latest"] for r in reps} == {STOP}
    assert "SIGTERM: emergency checkpoint" in text
    hist = reps[0]["hist"]
    assert [h["step"] for h in hist] == list(range(STOP))
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all(not r["hist"] for r in reps[1:])


def test_resume_on_one_device_reaches_the_uninterrupted_loss(world,
                                                             tmp_path):
    """The (1, 2, 2) run's emergency checkpoint resumed by a one-device
    Trainer reaches the uninterrupted one-device run's step-8 loss."""
    out, reps, _ = world
    _, _, resumed = _one_device(out / "run", resume=True)
    _, _, whole = _one_device(tmp_path / "fresh", resume=False)
    assert resumed[0]["step"] == STOP
    a, b = resumed[-1]["loss"], whole[-1]["loss"]
    assert resumed[-1]["step"] == whole[-1]["step"] == STEPS - 1
    assert abs(a - b) <= LOSS_RTOL * abs(b), (a, b)
    # the mesh's own first steps are one device's, within the same limit
    for h_mesh, h_one in zip(reps[0]["hist"], whole):
        assert abs(h_mesh["loss"] - h_one["loss"]) <= \
            LOSS_RTOL * abs(h_one["loss"])


def test_a_mesh_checkpoint_restores_onto_one_device(world):
    """The checkpoint written on (1, 2, 2) holds whole leaves: restored
    onto one device, every leaf equals the gathered state bit for bit."""
    out, _, _ = world
    want = {k.replace("|", "/"): v for k, v in
            np.load(out / "whole.npz").items()}
    like = {"params": {}, "opt": {}}
    manifest = json.loads((out / "elastic" / "step_00000003" /
                           "manifest.json").read_text())
    for e in manifest["leaves"]:
        top, rest = e["name"].split("/", 1)
        node = like[top]
        parts = rest.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.zeros(e["shape"])
    got, man = ckpt.restore(out / "elastic", like, device="cpu")
    assert man["step"] == 3
    flat = dict(tree_leaves_with_paths(got))
    assert flat.keys() == want.keys()
    for n, v in want.items():
        assert np.array_equal(flat[n].numpy(), v), n


def test_a_mesh_checkpoint_restores_onto_another_mesh(world):
    """Restored onto (1, 4, 1) over the same world, every rank's every
    leaf is its (1, 4, 1) block of the whole, bit for bit."""
    _, reps, _ = world
    cfg = reduced(get_arch(ARCH))
    for r in reps:
        assert r["restored_41"]["step"] == 3
        assert r["restored_41"]["all_equal"]
        assert r["restored_41"]["w_up"] == [cfg.n_layers, cfg.d_model // 4,
                                            cfg.d_ff]


def test_launch_train_on_a_cpu_mesh(tmp_path):
    """``launch.train --mesh 1,2,2 --device cpu`` starts 4 gloo processes;
    rank 0 prints a final loss below the first; exit 0."""
    e = dict(env())
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--mesh", "1,2,2", "--batch", "4",
         "--seq", "32", "--steps", "4", "--lr", "1e-3", "--ckpt-dir",
         str(tmp_path), "--ckpt-every", "4", "--no-resume"],
        capture_output=True, text=True, env=e, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if "final loss:" in x)
    assert line.startswith("[p0] ")
    final, first = (float(t) for t in
                    line.split("final loss: ")[1].replace("(from ", "")
                    .split(" @")[0].split())
    assert final < first
    assert ckpt.latest_step(tmp_path) == 4
