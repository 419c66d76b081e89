"""Quickstart on the port: characterize the device's memory, then train a
small LM for 30 steps — counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

The measurement is one declarative BenchSpec executed by the
``repro_torch.bench`` Runner, the API behind ``python -m repro_torch.bench
run``: on the card the hand-written kernels (the ``cuda`` backend), on the
CPU their plain versions (no device number).  The device defaults to
``cuda`` and raises without one.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    ap.add_argument("--ckpt-dir", default="checkpoints/quickstart")
    args = ap.parse_args(argv)

    from repro_torch.bench import BenchSpec, Runner
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import analysis
    from repro_torch.core.device import resolve_device
    from repro_torch.core.machine_model import detect_device, detect_host
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)
    # 1. membench: measure this device's memory hierarchy (the paper's tool)
    print("== membench: hierarchy sweep (quick) ==")
    spec = BenchSpec(mixes=("load_sum", "fma_8"),
                     sizes=(32 * 2**10, 1 * 2**20, 16 * 2**20),
                     reps=4, warmup=2, target_bytes=3e7, backend="cuda")
    res = Runner(device=device).run(spec)
    hw = detect_device(device) if device.type == "cuda" else detect_host()
    model = analysis.build_machine_model(res, hw)
    print(analysis.format_table(model.level_bw, model.mix_penalty))

    # 2. train a reduced granite for 30 steps on one device
    print("\n== train: granite-3-2b (reduced) 30 steps ==")
    cfg = reduced(get_arch("granite-3-2b"))
    tcfg = TrainConfig(steps=30, ckpt_every=15, ckpt_dir=args.ckpt_dir,
                       log_every=5,
                       opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=5,
                                             total_steps=30))
    trainer = Trainer(cfg, (8, 128), None, tcfg, device=device)
    _, _, hist = trainer.train(resume=False)
    print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"over {tcfg.steps} steps")


if __name__ == "__main__":
    main()
