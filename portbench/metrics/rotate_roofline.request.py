"""Share of its roofline of the window's `rotate` launches (devtrace.roofline)."""

from portbench.devtrace import roofline


def read(run):
    return roofline(run, "rotate", "edit")
