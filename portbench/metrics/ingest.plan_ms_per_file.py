"""Host ms per file developed of the engine's plan build on the calling
thread (`BatchEngine.timings["plan"]`, the span `batch.plan`) over the
window."""

from portbench.recorder import timing_ms_per_file


def read(run):
    return timing_ms_per_file(run, "plan")
