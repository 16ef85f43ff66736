"""Host ms per file of `BatchEngine._collect`'s scatter (each image copied
out of pinned memory into its result): `BatchEngine.timings["scatter"]`
over the window, divided by the files developed."""


def read(run):
    r = run["readings"]
    if run["kind"] != "ingest" or not r.get("files"):
        return None
    return r["timings"].get("scatter", 0.0) * 1e3 / r["files"]
