"""End-to-end example on the port: train a ~100M-class LM for a few hundred
steps with checkpointing and resume — counterpart of
``examples/train_lm.py`` (the same presets).

    PYTHONPATH=src python examples_torch/train_lm.py                 # ~20M, 200 steps
    PYTHONPATH=src python examples_torch/train_lm.py --preset 100m   # ~100M params
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 20

The device defaults to ``cuda`` and raises without one; ``--device cpu``
trains on the CPU.
"""
import argparse
from dataclasses import replace

from repro_torch.configs import get_arch
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer

PRESETS = {
    # ~20M params: a few hundred steps in minutes on a CPU
    "20m": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
                d_ff=1024, vocab_size=8192, batch=8, seq=256),
    # ~100M params
    "100m": dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
                 d_ff=2048, vocab_size=32768, batch=16, seq=512),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="20m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    p = dict(PRESETS[args.preset])
    batch, seq = p.pop("batch"), p.pop("seq")
    cfg = replace(get_arch("granite-3-2b"), name=f"lm-{args.preset}", **p)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=max(50, args.steps // 4),
        ckpt_dir=args.ckpt_dir, log_every=10,
        opt=adamw.AdamWConfig(lr=args.lr, warmup_steps=args.steps // 20 + 1,
                              total_steps=args.steps))
    trainer = Trainer(cfg, (batch, seq), None, tcfg, device=args.device)
    _, _, hist = trainer.train()
    print(f"\n{cfg.name}: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    if trainer.step_timer.slow_steps:
        print(f"straggler steps flagged: {trainer.step_timer.slow_steps}")


if __name__ == "__main__":
    main()
