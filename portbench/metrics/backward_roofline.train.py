"""The backward kernel's share of its roofline over a training window (B2's replay or B12's split sweep, by the configuration's backward names)."""

from portbench.trace import roofline_pct


def read(t):
    return roofline_pct(t, "backward")
