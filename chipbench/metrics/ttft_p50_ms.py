"""The median time to first token, beside the tail (host clock), ms."""
from chipbench.metrics_lib import ttft_quantile


def read(run):
    return ttft_quantile(run, 50)
