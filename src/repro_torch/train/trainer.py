"""Resilient training loop: checkpoint/resume, SIGTERM emergency save,
straggler monitoring (counterpart of ``repro.train.trainer``).

The loop is plain Python around one step function, as the reference's is.
One device: a mesh of more than one device raises (the multi-device model
side, sharding and elastic restore, is ROADMAP Queue A 8).  The device
defaults to ``cuda`` and raises without one; ``device="cpu"`` runs on the
CPU.
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
from repro_torch.ft.stragglers import StepTimer
from repro_torch.models.common import init_params
from repro_torch.models.registry import build
from repro_torch.models.variant import BASELINE, Variant
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
        if mesh_size(mesh) != 1:
            raise ValueError(
                f"a mesh of {mesh_size(mesh)} devices: the port trains on one "
                f"device; sharded training is ROADMAP Queue A 8")
        self.cfg = arch_cfg
        self.shape = shape
        self.mesh = mesh
        self.tcfg = tcfg = tcfg or TrainConfig()
        self.variant = variant
        self.device = resolve_device(device)
        self.model = build(arch_cfg)
        self.pipeline = make_pipeline(arch_cfg, shape, seed=tcfg.seed,
                                      device=self.device)
        self.step_timer = StepTimer()
        self._interrupted = False
        self.step_fn = make_train_step(arch_cfg, None, opt_cfg=tcfg.opt,
                                       variant=variant,
                                       grad_compression=tcfg.grad_compression)

    # -- state --------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None):
        """(params drawn from ``generator`` (default: the seed, on the
        device), a fresh optimiser state with the moments in the variant's
        ``adam_dtype``, step 0)."""
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.model.param_specs(), gen)
        opt_state = adamw.init_state(params, self.variant.adam_dtype)
        if self.tcfg.grad_compression:
            opt_state["ef_error"] = init_error(params)
        return params, opt_state, 0

    def restore_or_init(self):
        """The newest checkpoint under ``ckpt_dir`` onto this device, or a
        fresh state: (params, opt_state, step)."""
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        params, opt_state, _ = self.init_state()
        if step is None:
            return params, opt_state, 0
        restored, manifest = ckpt.restore(
            self.tcfg.ckpt_dir, {"params": params, "opt": opt_state},
            device=self.device)
        return restored["params"], restored["opt"], manifest["step"]

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
                if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    history.append({"step": step, "dt": dt, **m})
                    print(f"step {step:5d} loss={m['loss']:.4f} "
                          f"gnorm={m.get('grad_norm', 0):.3f} "
                          f"dt={dt*1e3:.0f}ms{' SLOW' if slow else ''}")
                if self._interrupted:
                    print("SIGTERM: emergency checkpoint")
                    ckpt.save(tcfg.ckpt_dir, step + 1,
                              {"params": params, "opt": opt_state},
                              blocking=True)
                    break
                if (step + 1) % tcfg.ckpt_every == 0:
                    ckpt.save(tcfg.ckpt_dir, step + 1,
                              {"params": params, "opt": opt_state},
                              extra={"arch": self.cfg.name},
                              blocking=not tcfg.async_ckpt)
            ckpt.wait_async()
        finally:
            signal.signal(signal.SIGTERM, old)
        return params, opt_state, history
