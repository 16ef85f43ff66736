"""Share of its roofline of the window's `develop_scaled` launches (devtrace.roofline)."""

from portbench.devtrace import roofline


def read(run):
    return roofline(run, "develop_scaled", "ingest")
