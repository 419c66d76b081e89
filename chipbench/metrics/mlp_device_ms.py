"""Device time of a prefill's MLP sublayers: the operations launched
inside the program's ``prefill.mlp`` spans (each layer's norm, MLP and
residual add) in the traced prefills, over their number, ms."""
from chipbench.spans import device_ms


def read(run):
    return device_ms(run, "prefill.mlp")
