"""The whole training step's share of the FP32 peak: every counted operation of the window's steps over peak times window."""

from portbench.trace import mfu_pct


def read(t):
    return mfu_pct(t)
