"""Device records (kernels, memcpy, memset) per optimizer step of the traced window."""

from portbench.trace import records_per_unit


def read(t):
    return records_per_unit(t)
