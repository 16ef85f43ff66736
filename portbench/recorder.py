"""What the per-layer metrics that read the program's own spans and
counters share (metrics/<name>.py).

The program (`imagepipe_tpu_torch.profiling`) records spans and counters
only while a profiler records: in a traced run, the harness's profiler
over the window. So the recorder holds the window's spans, and nothing of
the set-up before it or of what a traffic kind replays after it. A program
without the recorder, or a run in which a span or counter was not
recorded, reads None.
"""

from __future__ import annotations

import importlib


def program_recorder():
    """The program's profiling module where it has the recorder, else None."""
    try:
        module = importlib.import_module("imagepipe_tpu_torch.profiling")
    except ImportError:
        return None
    if not all(callable(getattr(module, f, None)) for f in ("spans", "counters")):
        return None
    return module


def timing_ms_per_file(run, key: str):
    """Host ms per file developed of `BatchEngine.timings[key]` over the
    window, in an ingest run; None where the engine has no such key."""
    r = run["readings"]
    timings = r.get("timings") or {}
    if run["kind"] != "ingest" or not r.get("files") or key not in timings:
        return None
    return timings[key] * 1e3 / r["files"]


def device_ms(run, kind: str, name: str):
    """Mean device ms of the window's spans `name` (each from its first
    enqueue to its last on the stream), in a run of traffic `kind`."""
    rec = program_recorder()
    if run["kind"] != kind or rec is None:
        return None
    ms = [s["device_ms"] for s in rec.spans()
          if s["name"] == name and s.get("device_ms") is not None]
    return sum(ms) / len(ms) if ms else None


def counter_pct(run, kind: str, part: str, whole: str):
    """100 x counter `part` / counter `whole` over the window, in a run of
    traffic `kind`."""
    rec = program_recorder()
    if run["kind"] != kind or rec is None:
        return None
    counts = rec.counters()
    if part not in counts or not counts.get(whole):
        return None
    return 100.0 * counts[part] / counts[whole]


def host_ms(run, kind: str, names: tuple, copy: str = "output.d2h"):
    """Mean host ms of the window's requests (top-level spans named one of
    `names`), each less the spans `copy` inside it, in a run of traffic
    `kind`."""
    rec = program_recorder()
    if run["kind"] != kind or rec is None:
        return None
    spans = [s for s in rec.spans() if s["end_ns"] is not None]
    by_id = {s["id"]: s for s in spans}
    wall = {s["id"]: s["end_ns"] - s["start_ns"] for s in spans
            if s["parent"] is None and s["name"] in names}
    for s in spans:
        if s["name"] != copy:
            continue
        root = s
        while root["parent"] is not None and root["parent"] in by_id:
            root = by_id[root["parent"]]
        if root["id"] in wall and root is not s:
            wall[root["id"]] -= s["end_ns"] - s["start_ns"]
    return sum(wall.values()) / len(wall) / 1e6 if wall else None
