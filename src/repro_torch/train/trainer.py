"""Resilient training loop: checkpoint/resume, SIGTERM emergency save,
straggler monitoring (counterpart of ``repro.train.trainer``).

The loop is plain Python around one step function, as the reference's is.
On a mesh (a ``launch.mesh.Mesh`` over an initialised world, one rank a
position) each rank holds its blocks of the parameters, the moments and
the compression residual (``registry.held_axes``), draws its block of
each batch (``make_pipeline``) and runs the sharded step; the metrics are
global, and rank 0 prints them and keeps the history.  Checkpoints hold
whole leaves (rank 0 writes), so a run resumes onto any mesh, one device
included.  A SIGTERM on any rank stops every rank after the same step,
each taking part in the emergency save.  The device defaults to ``cuda``
and raises without one; ``device="cpu"`` runs on the CPU (a mesh's device
is its own).
"""
from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.ft.stragglers import StepTimer
from repro_torch.models.common import init_params
from repro_torch.models.registry import build, shard_params
from repro_torch.models.variant import BASELINE, Variant, apply_rules
from repro_torch.optim import adamw
from repro_torch.optim.compression import init_error
from repro_torch.train.step import make_train_step


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    seed: int = 0
    async_ckpt: bool = True
    grad_compression: bool = False   # int8 error-feedback gradient reduce
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)


def mesh_size(mesh) -> int:
    """Devices in ``mesh``: None is one; a ``launch.mesh.Mesh`` (or any
    object with a ``shape`` mapping axes to sizes) or a tuple of axis
    sizes is their product."""
    if mesh is None:
        return 1
    shape = getattr(mesh, "shape", mesh)
    sizes = shape.values() if isinstance(shape, dict) else shape
    return math.prod(int(s) for s in sizes)


class Trainer:
    def __init__(self, arch_cfg, shape, mesh=None,
                 tcfg: TrainConfig | None = None,
                 variant: Variant = BASELINE, device=None):
        n = mesh_size(mesh)
        if n > 1 and getattr(mesh, "groups", None) is None:
            raise ValueError(
                f"a mesh of {n} positions needs {n} ranks: a "
                f"launch.mesh.Mesh over an initialised world of {n} "
                f"processes (launch.mesh.make_mesh), one a position")
        self.cfg = arch_cfg
        self.shape = shape
        self.mesh = mesh
        self.tcfg = tcfg = tcfg or TrainConfig()
        self.variant = variant
        # the variant's rules (``seq_parallel``) on the mesh
        self.ctx = apply_rules(ShardCtx(mesh), variant) if n > 1 else None
        self.device = mesh.device if n > 1 else resolve_device(device)
        self.primary = n == 1 or torch.distributed.get_rank() == 0
        self.model = build(arch_cfg)
        specs = self.model.param_specs()
        self.pipeline = make_pipeline(arch_cfg, shape, self.ctx,
                                      seed=tcfg.seed, device=self.device)
        self.step_timer = StepTimer()
        self._interrupted = False
        self.step_fn = make_train_step(arch_cfg, self.ctx, opt_cfg=tcfg.opt,
                                       variant=variant,
                                       grad_compression=tcfg.grad_compression)
        # the checkpoint's leaves held as blocks (the step counter whole)
        opt = {"mu": specs, "nu": specs, "step": None}
        if tcfg.grad_compression:
            opt["ef_error"] = specs
        self.state_specs = {"params": specs, "opt": opt}

    # -- state --------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None):
        """(params drawn from ``generator`` (default: the seed, on the
        device), a fresh optimiser state with the moments in the variant's
        ``adam_dtype``, step 0)."""
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.model.param_specs(), gen)
        if self.ctx is not None:        # the same values as one device's
            params = shard_params(self.cfg, params, self.ctx)
        opt_state = adamw.init_state(params, self.variant.adam_dtype)
        if self.tcfg.grad_compression:
            opt_state["ef_error"] = init_error(params)
        return params, opt_state, 0

    def restore_or_init(self):
        """The newest checkpoint under ``ckpt_dir`` onto this device (this
        rank's blocks of it on a mesh, whatever mesh wrote it), or a fresh
        state: (params, opt_state, step)."""
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        params, opt_state, _ = self.init_state()
        if step is None:
            return params, opt_state, 0
        restored, manifest = ckpt.restore(
            self.tcfg.ckpt_dir, {"params": params, "opt": opt_state},
            device=self.device, ctx=self.ctx, specs=self.state_specs)
        return restored["params"], restored["opt"], manifest["step"]

    def _save(self, step: int, params, opt_state, **kw):
        ckpt.save(self.tcfg.ckpt_dir, step, {"params": params,
                                             "opt": opt_state},
                  ctx=self.ctx, specs=self.state_specs, **kw)

    def _stop(self) -> bool:
        """Whether any rank took a SIGTERM (every rank agrees)."""
        if self.ctx is None:
            return self._interrupted
        flag = torch.tensor([float(self._interrupted)], device=self.device)
        return bool(self.ctx.all_reduce(flag, self.ctx.mesh.axis_names,
                                        "max")[0])

    # -- loop ---------------------------------------------------------------
    def _handle_sigterm(self, *_):
        self._interrupted = True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, resume: bool = True):
        """Run to ``tcfg.steps``: (params, opt_state, history), history one
        dict a logged step ({"step", "dt" (s), and every metric})."""
        tcfg = self.tcfg
        if resume:
            params, opt_state, start = self.restore_or_init()
        else:
            params, opt_state, start = self.init_state()
        old = signal.signal(signal.SIGTERM, self._handle_sigterm)
        history = []
        try:
            for step in range(start, tcfg.steps):
                batch = self.pipeline.batch(step)
                self._sync()
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                self._sync()
                dt = time.perf_counter() - t0
                slow = self.step_timer.update(step, dt)
                if self.primary and (step % tcfg.log_every == 0
                                     or step == tcfg.steps - 1):
                    m = {k: float(v) for k, v in metrics.items()}
                    history.append({"step": step, "dt": dt, **m})
                    print(f"step {step:5d} loss={m['loss']:.4f} "
                          f"gnorm={m.get('grad_norm', 0):.3f} "
                          f"dt={dt*1e3:.0f}ms{' SLOW' if slow else ''}")
                if self._stop():
                    if self.primary:
                        print("SIGTERM: emergency checkpoint")
                    self._save(step + 1, params, opt_state, blocking=True)
                    break
                if (step + 1) % tcfg.ckpt_every == 0:
                    self._save(step + 1, params, opt_state,
                               extra={"arch": self.cfg.name},
                               blocking=not tcfg.async_ckpt)
            ckpt.wait_async()
        finally:
            signal.signal(signal.SIGTERM, old)
        return params, opt_state, history
