"""Mean device ms of the window's demosaic stages (the program's span
`stage.demosaic`): the stream from the stage's first enqueue to its last,
any wait for the host between them included."""

from portbench.recorder import device_ms


def read(run):
    return device_ms(run, "edit", "stage.demosaic")
