"""Share of its roofline of the window's `suffix` launches (devtrace.roofline)."""

from portbench.devtrace import roofline


def read(run):
    return roofline(run, "suffix", "edit")
