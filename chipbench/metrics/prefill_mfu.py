"""Model FLOPs of a prefill (``counts/model_<family>.py``: the work the
function needs) over its mean service time (host clock, the batches
served without the profiler, from the tokens' copy to the first tokens on
the host) at the H100's 989 TFLOP/s of bfloat16, %."""
from chipbench.counts import peaks
from chipbench.metrics_lib import service_s


def read(run):
    took = service_s(run)
    if took is None:
        return None
    t = run.traffic
    flops = run.counts.model_flops(run.arch, t["batch"], t["prompt_len"])
    return 100.0 * flops / (took * peaks.BF16_FLOPS)
