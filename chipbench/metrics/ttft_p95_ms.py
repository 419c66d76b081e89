"""The 95th percentile of time to first token over every request done by
the window's close (each request of a batch counted), from its tokens'
copy to the device to its first token on the host, ms (host clock)."""
from chipbench.metrics_lib import ttft_quantile


def read(run):
    return ttft_quantile(run, 95)
