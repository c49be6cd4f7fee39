"""Share of the card's roofline: the least time of the window's alignment
work at the densest integer rate (``portbench/roofline.py``) over the
time some operation ran on the device."""

from portbench.metrics._common import kernels_roofline


def read(rec):
    return kernels_roofline(rec)
