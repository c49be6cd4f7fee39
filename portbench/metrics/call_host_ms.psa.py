"""Mean host time of a PSA call: its wall minus the device's busy time
inside it (packing, routing, transfers, string emission)."""

from portbench.metrics._common import call_host_ms


def read(rec):
    return call_host_ms(rec)
