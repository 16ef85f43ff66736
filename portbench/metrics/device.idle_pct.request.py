"""Share of the traced window with no kernel, copy or fill on the card
(devtrace.idle_pct)."""

from portbench.devtrace import idle_pct


def read(run):
    return idle_pct(run, "edit")
