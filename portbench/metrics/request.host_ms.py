"""Mean host ms of the window's edits outside their output copy: each
`service.edit` request span less its `output.d2h` span."""

from portbench.recorder import host_ms


def read(run):
    return host_ms(run, "edit", ("service.edit",))
