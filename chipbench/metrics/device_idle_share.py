"""The share of a prefill's service time with nothing running on the
device: 1 - the device time a traced prefill (``prefill_busy_ms``) over
the mean service time of the batches served without the profiler (whose
host-side cost would otherwise read as idle), %."""
from chipbench.metrics_lib import service_s, traced
from chipbench.trace import total


def read(run):
    tr = traced(run)
    took = service_s(run)
    if tr is None or took is None:
        return None
    busy = total(tr.busy(tr.serve)) / len(tr.serve)
    return 100.0 * (1.0 - busy / took)
