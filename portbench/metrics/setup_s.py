"""Seconds from process start to the start of the window: imports, the
kernels' build or load, inputs, warm-up."""


def read(rec):
    return rec["setup_s"]
