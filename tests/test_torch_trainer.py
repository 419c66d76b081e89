"""The port's training loop (``repro_torch.train.trainer``) and its launcher
(``repro_torch.launch.train``) on the CPU: the reference's system tests
(``tests/test_system.py`` trainer half, ``tests/test_grad_compression_e2e.py``)
at the same sizes — reduced granite-3-2b, batch 4 x 64 tokens — plus the
SIGTERM emergency save, the one-device rule and the step factories."""
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import build
from repro_torch.models.variant import BASELINE, VARIANTS
from repro_torch.optim import adamw
from repro_torch.train.step import make_decode_step, make_prefill_step
from repro_torch.train.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
CFG = reduced(get_arch("granite-3-2b"))
SHAPE = (4, 64)


def trainer(tmp_path, steps, ckpt_every=100, **kw):
    opt = kw.pop("opt", adamw.AdamWConfig(lr=2e-3, warmup_steps=2,
                                          total_steps=steps))
    variant = kw.pop("variant", BASELINE)
    tcfg = TrainConfig(steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(tmp_path), opt=opt, **kw)
    return Trainer(CFG, SHAPE, None, tcfg, variant=variant, device="cpu")


def test_trainer_loss_decreases(tmp_path):
    _, _, hist = trainer(tmp_path, 12, ckpt_every=6,
                         log_every=2).train(resume=False)
    assert [h["step"] for h in hist] == [0, 2, 4, 6, 8, 10, 11]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert ckpt.latest_step(tmp_path) == 12
    assert set(hist[0]) == {"step", "dt", "loss", "xent", "aux",
                            "grad_norm", "lr"}


def test_trainer_resume_from_checkpoint(tmp_path):
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=16)
    p1, o1, _ = trainer(tmp_path, 8, ckpt_every=4, log_every=4,
                        opt=opt).train(resume=False)
    t2 = trainer(tmp_path, 12, ckpt_every=4, log_every=4, opt=opt)
    params, opt_state, step = t2.restore_or_init()
    assert step == 8 and int(opt_state["step"]) == 8
    assert all(torch.equal(a.detach(), b) for a, b in
               zip(tree_leaves(p1), tree_leaves(params)))
    _, _, hist = t2.train(resume=True)
    assert hist[0]["step"] >= 8


def test_sigterm_saves_an_emergency_checkpoint(tmp_path):
    """SIGTERM during step 3: the step finishes, the state is saved as
    step 4 (blocking), and the loop stops."""
    tr = trainer(tmp_path, 10, log_every=1)
    step_fn = tr.step_fn
    calls = []

    def step_then_signal(params, opt_state, batch):
        calls.append(1)
        if len(calls) == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(params, opt_state, batch)
    tr.step_fn = step_then_signal
    old = signal.getsignal(signal.SIGTERM)
    _, opt_state, hist = tr.train(resume=False)
    assert signal.getsignal(signal.SIGTERM) is old
    assert len(calls) == 4 and hist[-1]["step"] == 3
    assert ckpt.latest_step(tmp_path) == 4
    assert int(opt_state["step"]) == 4


def _losses(tmp_path, compression: bool, tag: str):
    _, _, hist = trainer(tmp_path / tag, 15, log_every=5,
                         grad_compression=compression).train(resume=False)
    return [h["loss"] for h in hist]


def test_compressed_training_learns(tmp_path):
    plain = _losses(tmp_path, False, "plain")
    comp = _losses(tmp_path, True, "comp")
    assert comp[-1] < comp[0], "compressed run did not learn"
    # error feedback keeps the compressed trajectory close to the plain one
    assert abs(comp[-1] - plain[-1]) < 0.15, (plain, comp)


def test_bf16_moments_and_accumulation(tmp_path):
    """``fit_single_pod``: the moments stored in bfloat16 and four
    microbatches of one sequence each; the step runs and learns."""
    tr = trainer(tmp_path, 6, log_every=1, variant=VARIANTS["fit_single_pod"])
    params, opt_state, _ = tr.init_state()
    assert all(t.dtype == torch.bfloat16
               for t in tree_leaves(opt_state["mu"]))
    _, opt_state, hist = tr.train(resume=False)
    assert all(t.dtype == torch.bfloat16
               for t in tree_leaves(opt_state["nu"]))
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_one_device_only(tmp_path):
    """Without a world behind it, a mesh of more than one position raises,
    naming the ranks it needs; a mesh of one position is one device."""
    for mesh, n in (((1, 2, 1), 2), ({"data": 2, "model": 2}, 4)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            Trainer(CFG, SHAPE, mesh, TrainConfig(ckpt_dir=str(tmp_path)),
                    device="cpu")
    Trainer(CFG, SHAPE, (1, 1, 1), TrainConfig(ckpt_dir=str(tmp_path)),
            device="cpu")


def test_prefill_and_decode_steps():
    """The thin step factories: the model's prefill and one decode step,
    without autograd."""
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import init_cache, make_batch
    model = build(CFG)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(0))
    batch = make_batch(CFG, (2, 16), torch.Generator().manual_seed(1))
    logits, cache = make_prefill_step(CFG)(params, batch)
    want, _ = model.prefill(params, batch["tokens"])
    assert torch.equal(logits, want) and not logits.requires_grad
    cache = init_cache(CFG, 2, 17, "cpu")
    lg, _ = make_decode_step(CFG)(params, cache,
                                  {"tokens": batch["tokens"][:, :1]}, 0)
    assert lg.shape == (2, 1, logits.shape[-1])


def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)


def test_cli_trains_on_the_cpu(tmp_path):
    r = _cli("--arch", "granite-3-2b", "--reduced", "--device", "cpu",
             "--batch", "2", "--seq", "32", "--steps", "3",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "final loss:" in r.stdout
    assert ckpt.latest_step(tmp_path) == 2


def test_cli_refuses_what_it_cannot_do(tmp_path):
    """Without ``--device cpu`` on a box with no GPU it raises naming the
    flag, and a mesh of 2 exits 2, naming the GPUs it needs and the GPUs
    visible; ``--force-devices`` is refused."""
    base = ("--arch", "granite-3-2b", "--reduced", "--steps", "1",
            "--ckpt-dir", str(tmp_path))
    no_gpu = {"CUDA_VISIBLE_DEVICES": ""}
    r = _cli(*base, env_extra=no_gpu)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    r = _cli(*base, "--mesh", "1,2,1", env_extra=no_gpu)
    assert r.returncode == 2 and "needs 2 GPUs; 0 visible" in r.stderr
    r = _cli(*base, "--device", "cpu", "--force-devices", "8")
    assert r.returncode == 2 and "--force-devices" in r.stderr
