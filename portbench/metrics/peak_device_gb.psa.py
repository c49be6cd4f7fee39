"""Most device memory the allocator held during the window, in GB."""

from portbench.metrics._common import peak_gb


def read(rec):
    return peak_gb(rec)
