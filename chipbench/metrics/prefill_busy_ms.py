"""Device time a prefill: the union of the device's operation intervals
inside the traced prefills' service spans, over their number, ms
(profiler trace)."""
from chipbench.metrics_lib import traced
from chipbench.trace import total


def read(run):
    tr = traced(run)
    if tr is None:
        return None
    return total(tr.busy(tr.serve)) / len(tr.serve) * 1e3
