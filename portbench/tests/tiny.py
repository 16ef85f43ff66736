"""Tiny forms of the cells for the CPU tests: the configurations' frames
cut to a few CFA periods, the ingest traffic to 4 files, thumbnails to 40
wide."""

import copy
import tempfile
import time

from portbench import harness
from portbench.drivers import load_kind

CELLS = ("bayer24.ingest_full", "bayer24.edit_loop", "xtrans26.ingest_thumb",
         "xtrans26.rerender_full")
BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")


def config(c):
    c = copy.deepcopy(c)
    rows, cols = c["sensor"]["cfa_dims"]
    c["sensor"]["width"], c["sensor"]["height"] = 16 * cols, 12 * rows
    return c


def traffic(t):
    t = copy.deepcopy(t)
    if t.get("maxwidth"):
        t["maxwidth"] = 40
    if t["kind"] == "ingest":
        t["files"], t["base_frames"], t["decode_workers"] = 4, 2, 2
    return t


def cell_files(name):
    _, c, t, _ = harness.cell_files(BENCH, name)
    return config(c), traffic(t)


def driver(name, seed, scratch=None, trace=False, config_edit=None, traffic_edit=None):
    c, t = cell_files(name)
    c = config_edit(c) if config_edit else c
    t = traffic_edit(t) if traffic_edit else t
    return load_kind(t["kind"])(c, t, seed, "cpu", scratch or tempfile.mkdtemp(), trace)


def run(name, seed=2**31 + 5, seconds=0.3, trace=False, limits_=None, **edits):
    """One run of the tiny cell through the harness's `measure`."""
    d = driver(name, seed, trace=trace, **edits)
    return harness.measure(d, name, BENCH, limits_ or limits(name), seconds, time.perf_counter())


def limits(name):
    return harness.cell_files(BENCH, name)[3]
