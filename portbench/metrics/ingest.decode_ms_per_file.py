"""Host ms of decode per file developed: `BatchEngine.timings["decode"]`
(seconds summed over the decode threads, so thread time, not wall) over
the window, divided by the files developed."""


def read(run):
    r = run["readings"]
    if run["kind"] != "ingest" or not r.get("files"):
        return None
    return r["timings"].get("decode", 0.0) * 1e3 / r["files"]
