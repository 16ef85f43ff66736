"""Host ms per file developed that the engine's calling thread spends
blocked on the decode pool's next file (`BatchEngine.timings
["decode_wait"]`, the span `batch.decode_wait`) over the window."""

from portbench.recorder import timing_ms_per_file


def read(run):
    return timing_ms_per_file(run, "decode_wait")
