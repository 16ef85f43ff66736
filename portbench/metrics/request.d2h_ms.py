"""Device ms of device-to-host copies per request (devtrace.d2h_ms)."""

from portbench.devtrace import d2h_ms


def read(run):
    return d2h_ms(run, "edit")
