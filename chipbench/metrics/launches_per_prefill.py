"""Device kernels a prefill: the kernels inside the traced prefills'
service spans over their number (profiler trace)."""
from chipbench.metrics_lib import traced


def read(run):
    tr = traced(run)
    if tr is None:
        return None
    return len(tr.device_in(tr.serve, ("kernel",))) / len(tr.serve)
