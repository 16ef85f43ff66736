"""Share of its roofline of the window's `develop` launches (devtrace.roofline)."""

from portbench.devtrace import roofline


def read(run):
    return roofline(run, "develop", "ingest")
