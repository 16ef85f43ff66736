"""Mean host ms of the window's re-renders outside their output copy:
each `pipeline.output_8bit` (or `_16bit`) request span less its
`output.d2h` span."""

from portbench.recorder import host_ms


def read(run):
    return host_ms(run, "rerender", ("pipeline.output_8bit", "pipeline.output_16bit"))
