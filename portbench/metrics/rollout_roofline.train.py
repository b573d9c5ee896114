"""The rollout kernel's share of its roofline over a training window (B1's tile or wide form, by the configuration's rollout names)."""

from portbench.trace import roofline_pct


def read(t):
    return roofline_pct(t, "rollout")
