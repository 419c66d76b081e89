"""Shared benchmark helpers: CSV emission in the required format (a copy of
``benchmarks/common.py``; the port imports nothing of the reference) and the
device flags every figure script takes."""
from __future__ import annotations

import argparse
import sys


def emit(name: str, us_per_call: float, derived: str):
    """Required format: name,us_per_call,derived"""
    print(f"{name},{us_per_call:.2f},{derived}")
    sys.stdout.flush()


def add_device_flags(ap: argparse.ArgumentParser,
                     backend: str | None = "cuda") -> None:
    """``--device`` and, where the script has the choice, ``--backend``
    (default ``backend``): on the card the reference's compiled on-device
    code has its counterpart in the hand-written kernels (``cuda``), not in
    the eager oracles (``torch``)."""
    if backend is not None:
        ap.add_argument("--backend", default=backend,
                        help="cuda (the hand-written kernels) | torch (the "
                             "plain PyTorch oracles)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) | "
                         "cpu (the plain versions; no device number)")
