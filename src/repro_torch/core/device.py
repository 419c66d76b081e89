"""Explicit device resolution — the measurement never changes device by
itself.

Every entry point of this package takes a ``device`` (a ``torch.device`` or a
string).  ``None`` means the default, ``cuda``; where the default is taken and
no CUDA device is present the call raises instead of carrying on on the CPU:
a number measured on a CPU must never be mistaken for the card's.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (None = ``cuda``) as a ``torch.device``; raises when a CUDA
    device is asked for (explicitly or by default) and none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested"
            f"{' (the default)' if device is None else ''} but "
            "torch.cuda.is_available() is False; this package never falls "
            "back to the CPU by itself — pass --device cpu (or device='cpu') "
            "to run the plain PyTorch versions on the CPU")
    return dev
