"""Serve a small model with batched requests: prefill + greedy decode, on
the port — counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples_torch/serve_lm.py --arch zamba2-2.7b
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu
    PYTHONPATH=src python examples_torch/serve_lm.py --arch whisper-medium \
        --device cpu

The model is the config ``--reduced`` (2 layers, d_model 128), weights
random from a seed.
"""
import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    help="any registered config: zamba2-2.7b, mamba2-2.7b, "
                         "granite-3-2b, stablelm-3b, internlm2-20b, "
                         "phi3-medium-14b, chameleon-34b, arctic-480b, "
                         "deepseek-v2-236b, whisper-medium")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu "
                         "(the kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.launch import serve
    return serve.main(["--arch", args.arch, "--reduced",
                       "--batch", str(args.batch),
                       "--prompt-len", str(args.prompt_len),
                       "--gen", str(args.gen)]
                      + (["--device", args.device] if args.device else []))


if __name__ == "__main__":
    raise SystemExit(main())
