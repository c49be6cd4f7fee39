"""MSA rate: the DP cells of the window's calls over the window's host-clock time, in billions a second."""

from portbench.metrics._common import rate


def read(rec):
    return rate(rec)
