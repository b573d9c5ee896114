"""The device's idle share of an evaluation window: 1 - busy / window, busy the union of the device records."""

from portbench.trace import idle_pct


def read(t):
    return idle_pct(t)
