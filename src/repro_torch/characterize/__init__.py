"""repro_torch.characterize — measurement-driven machine characterization.

Counterpart of ``repro.characterize``; so far only ``loaded`` (the
loaded-latency sweep over the ``latency_chase`` mix's ``load`` axis and its
per-level knee fits), which ``python -m repro_torch.bench latency`` drives.
"""
from repro_torch.characterize.loaded import (fit_knee, fit_loaded,  # noqa: F401
                                             loaded_latency_sweep)

__all__ = ["fit_knee", "fit_loaded", "loaded_latency_sweep"]
