"""The per-layer metrics that read the program's spans, counters and engine
timings: each on a planted run (and a planted recorder) reads the right
number; off its kind, and where the program lacks the recorder or the key,
it reads None."""

import pytest

from imagepipe_tpu_torch import profiling
from portbench import harness
from portbench.tests import tiny

FILES = 8
TIMINGS = {"decode": 3.2, "decode_wait": 0.4, "plan": 0.8, "stage": 0.16, "dispatch": 0.04,
           "wait": 0.02, "scatter": 0.24}
INGEST = {"ingest.decode_wait_ms_per_file": ("decode_wait", 50.0),
          "ingest.plan_ms_per_file": ("plan", 100.0),
          "ingest.stage_ms_per_file": ("stage", 20.0)}
RECORDER = ("edit.demosaic_device_ms", "edit.stage_reuse_pct", "request.host_ms",
            "rerender.host_ms")
KIND = {"edit.demosaic_device_ms": "edit", "edit.stage_reuse_pct": "edit",
        "request.host_ms": "edit", "rerender.host_ms": "rerender"}


def _run(kind, **readings):
    return {"kind": kind, "readings": readings, "trace": None, "launches": {}}


def _span(i, name, start_ms, end_ms, parent=None, device_ms=None):
    return {"id": i, "name": name, "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "thread": 1, "parent": parent, "request": None, "device_ms": device_ms}


# Two edits: 40 ms with a 34 ms copy two levels down, 50 ms with 44 ms; an
# unfinished span and spans outside any request, which no reader counts.
EDIT_SPANS = [
    _span(0, "service.edit", 0, 40), _span(1, "pipeline.output_8bit", 1, 40, 0),
    _span(2, "stage.demosaic", 2, 3, 1, device_ms=16.0), _span(3, "output.d2h", 5, 39, 1),
    _span(4, "service.edit", 100, 150), _span(5, "pipeline.output_8bit", 100, 150, 4),
    _span(6, "stage.demosaic", 101, 102, 5, device_ms=20.0),
    _span(7, "stage.demosaic", 103, 104, 5),
    _span(8, "output.d2h", 105, 149, 5), _span(9, "output.d2h", 200, 230),
    dict(_span(10, "service.edit", 300, 300), end_ns=None),
]
# Re-renders: 37 ms with a 34 ms copy, 39 with 35; a 16-bit one, 30 with 28.
RERENDER_SPANS = [
    _span(0, "pipeline.output_8bit", 0, 37), _span(1, "fused.plan", 0, 2, 0),
    _span(2, "output.d2h", 3, 37, 0), _span(3, "pipeline.output_8bit", 50, 89),
    _span(4, "output.d2h", 53, 88, 3), _span(5, "pipeline.output_16bit", 100, 130),
    _span(6, "output.d2h", 101, 129, 5),
]
COUNTERS = {"stage_cache.stages": 80, "stage_cache.reused": 30}
WANT = {"edit.demosaic_device_ms": 18.0, "edit.stage_reuse_pct": 37.5,
        "request.host_ms": (6 + 6) / 2, "rerender.host_ms": (3 + 4 + 2) / 3}


@pytest.fixture
def planted(monkeypatch):
    def plant(spans, counters=None):
        monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in spans])
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters or {}))
    return plant


@pytest.mark.parametrize("name", INGEST)
def test_an_ingest_timing_reads_ms_per_file(name):
    read = harness.metric_reader(name)
    assert read(_run("ingest", files=FILES, timings=TIMINGS)) == pytest.approx(INGEST[name][1])


@pytest.mark.parametrize("name", INGEST)
def test_an_ingest_timing_reads_none_off_its_kind_or_key(name):
    read = harness.metric_reader(name)
    assert read(_run("edit", files=FILES, timings=TIMINGS)) is None
    assert read(_run("ingest", files=0, timings=TIMINGS)) is None
    missing = {k: v for k, v in TIMINGS.items() if k != INGEST[name][0]}
    assert read(_run("ingest", files=FILES, timings=missing)) is None
    assert read(_run("ingest", files=FILES)) is None


@pytest.mark.parametrize("name", RECORDER)
def test_a_recorder_metric_reads_the_planted_recorder(name, planted):
    planted(RERENDER_SPANS if KIND[name] == "rerender" else EDIT_SPANS, COUNTERS)
    assert harness.metric_reader(name)(_run(KIND[name])) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", RECORDER)
def test_a_recorder_metric_reads_none_off_its_kind(name, planted):
    planted(EDIT_SPANS + RERENDER_SPANS, COUNTERS)
    for kind in {"ingest", "edit", "rerender"} - {KIND[name]}:
        assert harness.metric_reader(name)(_run(kind)) is None


@pytest.mark.parametrize("name", RECORDER)
def test_a_recorder_metric_reads_none_without_the_recorder(name, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert harness.metric_reader(name)(_run(KIND[name])) is None


@pytest.mark.parametrize("name", RECORDER)
def test_a_recorder_metric_reads_none_without_its_spans(name, planted):
    planted([_span(0, "batch.develop_files", 0, 10)], {"other": 3})
    assert harness.metric_reader(name)(_run(KIND[name])) is None


def test_stage_reuse_reads_none_without_stages(planted):
    planted([], {"stage_cache.stages": 0, "stage_cache.reused": 0})
    assert harness.metric_reader("edit.stage_reuse_pct")(_run("edit")) is None


@pytest.mark.parametrize("cell,names", [
    ("bayer24.ingest_full", ("ingest.decode_wait_ms_per_file", "ingest.plan_ms_per_file",
                             "ingest.stage_ms_per_file")),
    ("bayer24.edit_loop", ("edit.stage_reuse_pct", "request.host_ms")),
    ("xtrans26.rerender_full", ("rerender.host_ms",)),
])
def test_a_traced_tiny_run_reads_the_new_metrics(cell, names):
    """On the CPU the spans are recorded under the harness's profiler (the
    demosaic's device ms needs CUDA events: not read here)."""
    profiling.reset()
    result, lines = tiny.run(cell, trace=True)
    assert result["correct"], lines
    for name in names:
        assert result["metrics"][name]["value"] >= 0, name
    assert "edit.demosaic_device_ms" not in result["metrics"]
    profiling.reset()
