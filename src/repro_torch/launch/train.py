"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --reduced --device cpu --batch 4 --seq 64 --steps 12
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --reduced --device cpu --mesh 1,2,2 --batch 4 --seq 64 --steps 12

The reference's flags, plus ``--device`` (default ``cuda``; it raises
without one, and ``--device cpu`` trains on the CPU).  ``--mesh P,D,M``
(pod, data, model) of more than one position starts that many processes
(``bench.distributed.launch_local``), one a mesh position: one GPU each
and NCCL on CUDA, where fewer visible GPUs than the mesh needs exit 2
("needs N GPUs; K visible"); gloo and one thread each with ``--device
cpu``.  Each process trains its blocks of the sharded state
(``train.trainer``); rank 0 prints.  ``--force-devices`` above 0 is
refused (it forces XLA host devices, which this package does not have).
Weights and batches are random, drawn from the seed.
"""
import argparse
import math
import os
import sys

#: the mesh's axis names, in ``--mesh`` order
AXES = ("pod", "data", "model")


def _launch(argv: list[str], n: int, device: str) -> int:
    """This command again on ``n`` coordinated processes: their exit code,
    or 2 where the machine has fewer GPUs than the mesh needs."""
    from repro_torch.bench.distributed import launch_local
    from repro_torch.bench.spec import BenchSpecError
    env = dict(os.environ)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    try:
        return launch_local([sys.executable, "-m", "repro_torch.launch.train",
                             *argv], processes=n, env=env, device=device,
                            stream_to=sys.stdout)
    except BenchSpecError as e:
        print(f"launch.train: --mesh of {n} positions: {e}", file=sys.stderr)
        return 2


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-scale reduced config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1,1,1",
                    help="pod,data,model axis sizes (one process a position)")
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
    if len(mesh) != len(AXES) or min(mesh) < 1:
        ap.error(f"--mesh {args.mesh}: three positive sizes, {','.join(AXES)}")
    n = math.prod(mesh)

    from repro_torch.bench import distributed as dist
    if n > 1 and not dist.env_active():
        return _launch(argv, n, args.device or "cuda")

    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.device import resolve_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.variant import VARIANTS
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)
    grid = None
    if n > 1:
        dist.ensure_initialized(device.type)
        grid = make_mesh(mesh, AXES, device=device.type)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        opt=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps))
    trainer = Trainer(cfg, (args.batch, args.seq), grid, tcfg,
                      variant=VARIANTS[args.variant], device=device)
    _, _, hist = trainer.train(resume=not args.no_resume)
    if hist:
        print(f"final loss: {hist[-1]['loss']:.4f} "
              f"(from {hist[0]['loss']:.4f} @ step {hist[0]['step']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
