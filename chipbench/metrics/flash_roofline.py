"""The flash-attention kernel's share of its roofline: the bound of the
work its launches need (``counts/flash.py``) over their device time in the
traced prefills, %."""
from chipbench.metrics_lib import roofline


def read(run):
    return roofline(run, "flash")
