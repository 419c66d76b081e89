"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --reduced --device cpu --batch 4 --seq 64 --steps 12

The reference's flags, plus ``--device`` (default ``cuda``; it raises
without one, and ``--device cpu`` trains on the CPU).  One device: a
``--mesh`` of more than one device is refused (sharded training is ROADMAP
Queue A 8), and so is ``--force-devices`` above 0 (it forces XLA host
devices, which this package does not have).  Weights and batches are
random, drawn from the seed.
"""
import argparse
import math
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-scale reduced config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1,1,1",
                    help="pod,data,model axis sizes (one device only)")
    ap.add_argument("--force-devices", type=int, default=0,
                    help="XLA's forced host devices: 0 only")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    if args.force_devices:
        ap.error(f"--force-devices {args.force_devices}: it forces XLA host "
                 f"devices, which this package has none of; pass 0")
    mesh = tuple(int(x) for x in args.mesh.split(","))
    if math.prod(mesh) != 1:
        ap.error(f"--mesh {args.mesh}: one device only; sharded training is "
                 f"ROADMAP Queue A 8")

    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.device import resolve_device
    from repro_torch.models.variant import VARIANTS
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        opt=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps))
    trainer = Trainer(cfg, (args.batch, args.seq), None, tcfg,
                      variant=VARIANTS[args.variant], device=device)
    _, _, hist = trainer.train(resume=not args.no_resume)
    if hist:
        print(f"final loss: {hist[-1]['loss']:.4f} "
              f"(from {hist[0]['loss']:.4f} @ step {hist[0]['step']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
