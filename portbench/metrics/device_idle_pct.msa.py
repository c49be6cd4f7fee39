"""Share of the traced window in which no operation ran on the device."""

from portbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec)
