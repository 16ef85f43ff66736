"""Host ms per file developed of staging the chunks' sensor planes into
pinned buffers (`BatchEngine.timings["stage"]`, the span `batch.stage`)
over the window."""

from portbench.recorder import timing_ms_per_file


def read(run):
    return timing_ms_per_file(run, "stage")
