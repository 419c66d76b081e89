"""Device time of a prefill's casts from float32: the operations launched
inside the program's ``cast`` spans (``cast_compute`` where the dtype
changes: the weights, the looked-up embedding rows, the tied head) in the
traced prefills, over their number, ms."""
from chipbench.spans import device_ms


def read(run):
    return device_ms(run, "cast")
