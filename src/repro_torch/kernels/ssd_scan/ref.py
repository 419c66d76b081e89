"""Oracle for the SSD kernel: the token-level state-space recurrence in f32
(counterpart of ``repro.kernels.ssd_scan.ref``; the same function as
``ssd_scan.plain_ssd``)."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.ssd_scan import plain_ssd


def reference(xdt, dA, Bm, Cm):
    return plain_ssd(xdt, dA, Bm, Cm)
