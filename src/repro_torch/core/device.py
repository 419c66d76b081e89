"""Explicit device resolution — the measurement never changes device by
itself.

Every entry point of this package takes a ``device`` (a ``torch.device`` or a
string).  ``None`` means the default, ``cuda``; where the default is taken and
no CUDA device is present the call raises instead of carrying on on the CPU:
a number measured on a CPU must never be mistaken for the card's.
"""
from __future__ import annotations

import os

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


#: how many logical devices the pool of a CPU run holds — the counterpart of
#: the reference's ``--xla_force_host_platform_device_count``.  Unset means
#: one; ``bench.distributed.launch_local`` sets it for each CPU worker.
CPU_DEVICES_ENV = "REPRO_TORCH_CPU_DEVICES"


def cpu_device_count() -> int:
    """The number of logical CPU devices (``REPRO_TORCH_CPU_DEVICES``,
    default 1)."""
    raw = os.environ.get(CPU_DEVICES_ENV, "").strip()
    if not raw:
        return 1
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n < 1:
        raise ValueError(f"{CPU_DEVICES_ENV}={raw!r}: need a positive "
                         f"integer (logical CPU devices)")
    return n


def device_pool(device=None) -> list[torch.device]:
    """The devices a multi-device run on ``device`` (None = ``cuda``) may
    spread over, in mesh order: every visible GPU, ``cuda:0`` ..
    ``cuda:n-1``, for a CUDA device; ``cpu_device_count()`` logical devices,
    all the host's CPU, for the CPU (asked for explicitly, as everywhere)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if dev.type == "cpu":
        return [dev] * cpu_device_count()
    raise ValueError(f"no device pool for {str(dev)!r} (cuda or cpu)")
