"""Device time of a prefill's attention sublayers: the operations launched
inside the program's ``prefill.attn`` spans (each layer's norm, attention
and residual add) in the traced prefills, over their number, ms."""
from chipbench.spans import device_ms


def read(run):
    return device_ms(run, "prefill.attn")
