"""PyTorch port: the spans and counters of `imagepipe_tpu_torch.profiling`,
and where the program opens them (the batch engine, the staged and fused
paths, the output copy), on the CPU.

With no profiler recording a span records nothing and opens no
`record_function`; under `torch.profiler.profile` spans nest, carry their
request's id (a decode worker's too), land in the recorder and in the
profiler's trace as `user_annotation`s. `BatchEngine.timings` and
`Pipeline.stage_ms` are the spans' sums.
"""

import collections
import json
import logging
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imagepipe_tpu_torch import pipeline as tpipe
from imagepipe_tpu_torch import profiling
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.decode import save_synraw
from imagepipe_tpu_torch.parallel import BatchEngine
from imagepipe_tpu_torch.pipeline import Pipeline
from imagepipe_tpu_torch.service import RenderService
from imagepipe_tpu_torch.sources import ImageSource

torch.set_num_threads(1)

SIX = {"decode", "plan", "stage", "dispatch", "wait", "scatter"}
EDITS = [{"basecurve": {"exposure": 0.4}}, {"rotatecrop": {"rotation": 0.05}},
         {"rotatecrop": {"crop_left": 0.1}}, {"basecurve": {"exposure": -0.3}}]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _source(seed=3):
    return ImageSource.from_raw(traw.synthetic_bayer(96, 64, seed=seed))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    paths = []
    for s in range(6):
        paths.append(str(d / f"r{s}.synraw.npz"))
        save_synraw(paths[-1], traw.synthetic_bayer(96, 64, seed=70 + s))
    return paths


def _names(spans):
    return collections.Counter(s["name"] for s in spans)


# -- tracing off -------------------------------------------------------------

def test_off_a_span_without_into_is_one_shared_no_op():
    assert profiling.span("a") is profiling.span("b") is profiling.request("c")


def test_off_spans_record_nothing():
    with profiling.request("off.request"):
        with profiling.span("off.span", device=True):
            profiling.count("off.count")
    assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.current_request() is None


def test_off_spans_emit_no_record_function():
    with profiling.request("off.request"), profiling.span("off.span"):
        torch.ones(4).sum()
    with _recording() as prof:
        torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "off.request" not in names and "off.span" not in names


@pytest.mark.parametrize("into", [dict, collections.Counter])
def test_off_a_span_adds_its_host_seconds(into):
    sums = into()
    for _ in range(2):
        t0 = time.perf_counter()
        with profiling.span("phase", into=sums, key="k"):
            time.sleep(0.01)
        wall = time.perf_counter() - t0
    assert set(sums) == {"k"} and 0.02 <= sums["k"] <= 2 * wall + 0.01


def test_a_span_without_key_adds_under_its_name():
    sums = {}
    with profiling.span("named.phase", into=sums):
        pass
    assert list(sums) == ["named.phase"] and sums["named.phase"] >= 0


def test_off_a_span_closes_on_an_exception():
    sums = {}
    with pytest.raises(ValueError):
        with profiling.span("failing", into=sums):
            raise ValueError("raised inside")
    assert "failing" in sums


# -- tracing on --------------------------------------------------------------

def test_spans_nest_and_record_their_parent():
    with _recording():
        with profiling.span("outer"):
            with profiling.span("middle"):
                with profiling.span("inner"):
                    pass
            with profiling.span("sibling"):
                pass
    s = {x["name"]: x for x in profiling.spans()}
    assert s["outer"]["parent"] is None
    assert s["middle"]["parent"] == s["sibling"]["parent"] == s["outer"]["id"]
    assert s["inner"]["parent"] == s["middle"]["id"]
    assert all(x["start_ns"] <= x["end_ns"] for x in s.values())
    assert s["outer"]["start_ns"] <= s["inner"]["start_ns"] <= s["inner"]["end_ns"] \
        <= s["outer"]["end_ns"]
    assert {x["request"] for x in s.values()} == {None}


def test_a_request_gives_its_children_a_fresh_id():
    with _recording():
        for _ in range(2):
            with profiling.request("req"):
                with profiling.span("child"):
                    assert profiling.current_request() is not None
        with profiling.span("outside"):
            pass
    spans = profiling.spans()
    reqs = [s for s in spans if s["name"] == "req"]
    children = [s for s in spans if s["name"] == "child"]
    assert len({r["request"] for r in reqs}) == 2 and None not in {r["request"] for r in reqs}
    for r, c in zip(reqs, children):
        assert c["request"] == r["request"] and c["parent"] == r["id"]
    assert [s["request"] for s in spans if s["name"] == "outside"] == [None]


def test_a_request_inside_a_request_is_a_child():
    with _recording():
        with profiling.request("outer.req"):
            with profiling.request("inner.req"):
                pass
    outer, inner = profiling.spans()
    assert inner["parent"] == outer["id"] and inner["request"] == outer["request"]


def test_a_span_still_adds_to_into_while_recording():
    sums = collections.Counter()
    with _recording():
        with profiling.span("phase", into=sums, key="k"):
            time.sleep(0.005)
    (s,) = profiling.spans()
    assert sums["k"] >= 0.005
    assert sums["k"] == pytest.approx((s["end_ns"] - s["start_ns"]) / 1e9, abs=1e-3)


def test_a_worker_span_carries_the_request_id_it_is_given():
    seen = {}

    def work(rid):
        seen["enabled"] = torch.autograd._profiler_enabled()
        with profiling.span("worker.phase", into=seen, key="s", request_id=rid):
            pass

    with _recording() as prof:
        with profiling.request("pass"):
            t = threading.Thread(target=work, args=(profiling.current_request(),))
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen["enabled"] is False and "s" in seen
    root, worker = profiling.spans()
    assert worker["name"] == "worker.phase" and worker["request"] == root["request"]
    assert worker["parent"] == root["id"] and worker["thread"] != root["thread"]
    assert "worker.phase" not in {e.name for e in prof.events()}


def test_counters_count_while_recording_and_reset_clears_them():
    with _recording():
        profiling.count("things")
        profiling.count("things", 4)
        with profiling.span("s"):
            pass
    profiling.count("things", 100)    # not recording
    assert profiling.counters() == {"things": 5}
    profiling.reset()
    assert profiling.counters() == {} and profiling.spans() == []


def test_trace_empties_the_recorder_on_entry(tmp_path):
    with _recording():
        profiling.count("stale")
        with profiling.span("stale.span"):
            pass
    with profiling.trace(str(tmp_path)):
        profiling.count("fresh")
    assert profiling.counters() == {"fresh": 1} and profiling.spans() == []


def test_span_names_are_user_annotations_in_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.request("annotated.request"):
            with profiling.span("annotated.span"):
                torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"annotated.request", "annotated.span"} <= names


def test_the_recorder_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    sums = {}
    with _recording():
        for _ in range(5):
            with profiling.span("many", into=sums):
                pass
    assert len(profiling.spans()) == 3
    assert profiling.counters() == {"profiling.dropped": 2} and "many" in sums


@pytest.mark.parametrize("device", [True, torch.device("cpu"), "cpu"])
def test_device_events_only_on_cuda(device):
    with _recording():
        with profiling.span("on.host", device=device):
            pass
    assert [s["device_ms"] for s in profiling.spans()] == [None]


def test_a_recorded_span_closes_on_an_exception():
    with _recording():
        with pytest.raises(KeyError):
            with profiling.request("req"):
                with profiling.span("failing"):
                    raise KeyError("x")
        with profiling.span("after"):
            pass
    spans = profiling.spans()
    assert all(s["end_ns"] is not None for s in spans)
    assert spans[-1]["parent"] is None and spans[-1]["request"] is None


# -- the batch engine ---------------------------------------------------------

def test_batch_timings_are_the_spans_sums(files):
    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=2)
    eng.develop_files(files)
    assert set(eng.timings) >= SIX | {"submit", "decode_wait"}
    assert all(v >= 0 for v in eng.timings.values())


def test_the_calling_threads_split_covers_the_pass(files):
    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=2)
    eng.develop_files(files)
    eng.timings.clear()
    t0 = time.perf_counter()
    eng.develop_files(files)
    wall = time.perf_counter() - t0
    split = sum(v for k, v in eng.timings.items() if k != "decode")
    assert 0.9 * wall <= split <= wall


def test_worker_decodes_carry_their_pass_id(files):
    eng = BatchEngine(devices=["cpu"], max_batch=4, decode_workers=3)
    with _recording():
        eng.develop_files(files)
        eng.develop_files(files[:2])
    spans = profiling.spans()
    roots = [s for s in spans if s["name"] == "batch.develop_files"]
    assert len(roots) == 2 and roots[0]["request"] != roots[1]["request"]
    for root, n in zip(roots, (len(files), 2)):
        mine = [s for s in spans if s["request"] == root["request"]]
        decodes = [s for s in mine if s["name"] == "batch.decode"]
        assert len(decodes) == n and all(s["parent"] == root["id"] for s in decodes)
        assert all(s["thread"] != root["thread"] for s in decodes)
        names = _names(mine)
        assert names["batch.plan"] == n and names["batch.decode_wait"] == n + 1
        assert names["batch.submit"] == 1
        assert names["batch.stage"] == names["batch.dispatch"] == names["batch.wait"] \
            == names["batch.scatter"] >= 1


def test_develop_sources_is_one_request():
    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=1)
    with _recording():
        outs = eng.develop_sources([_source(1), _source(2)])
    spans = profiling.spans()
    assert len(outs) == 2 and spans[0]["name"] == "batch.develop_sources"
    assert {s["request"] for s in spans} == {spans[0]["request"]}
    assert _names(spans)["batch.plan"] == 2


# -- the staged and fused paths -----------------------------------------------

@pytest.fixture(scope="module")
def service():
    svc = RenderService(device="cpu")
    svc.open_source("k", _source())
    svc.render("k")
    return svc


@pytest.mark.parametrize("patch", EDITS, ids=lambda p: json.dumps(p))
def test_staged_stage_spans_are_stage_ms(service, patch):
    with _recording():
        service.edit("k", patch)
    pipe = service.sessions["k"].pipeline
    spans = profiling.spans()
    stages = [s for s in spans if s["name"].startswith("stage.")]
    assert [s["name"].removeprefix("stage.") for s in stages] == list(pipe.stage_ms)
    for s in stages:
        host_ms = (s["end_ns"] - s["start_ns"]) / 1e6
        assert pipe.stage_ms[s["name"].removeprefix("stage.")] == pytest.approx(host_ms, abs=1)
    ran = sum(len(name.split("+")) for name in pipe.stage_ms)
    counts = profiling.counters()
    assert counts["stage_cache.stages"] == len(tpipe.PipelineOps.ORDER)
    assert counts["stage_cache.reused"] == counts["stage_cache.stages"] - ran
    names = _names(spans)
    assert names["service.edit"] == names["pipeline.output_8bit"] == names["pipeline.plan"] \
        == names["output.d2h"] == 1
    assert {s["request"] for s in spans} == {spans[0]["request"]}


def test_stage_cache_counters_sum_over_requests(service):
    """Settings never rendered before: every edit reuses a prefix (at least
    gofloat) and runs the rest; the first one again runs nothing."""
    edits = [{"basecurve": {"exposure": x}} for x in (0.9, -0.8, 0.7)]
    with _recording():
        for patch in edits + edits[:1]:
            service.edit("k", patch)
    counts = profiling.counters()
    assert counts["stage_cache.stages"] == 8 * 4
    assert counts["stage_cache.reused"] == 3 * 4 + 8


def test_quantize_span_where_no_segment_quantizes(monkeypatch):
    monkeypatch.setattr(tpipe, "FUSE_SUFFIX", False)
    pipe = Pipeline.new_from_source(_source(), device="cpu")
    pipe.globals.settings.use_fastpath = False
    with _recording():
        pipe.output_8bit(Pipeline.new_cache(1 << 30))
    names = _names(profiling.spans())
    assert names["pipeline.quantize"] == 1 and names["stage.gamma"] == 1


@pytest.mark.parametrize("bits", [8, 16])
def test_fused_path_spans(bits):
    pipe = Pipeline.new_from_source(_source(), device="cpu")
    render = pipe.output_8bit if bits == 8 else pipe.output_16bit
    render()
    with _recording():
        img = render()
    spans = profiling.spans()
    names = _names(spans)
    assert names == {f"pipeline.output_{bits}bit": 1, "fused.plan": 1, "fused.develop": 1,
                     "output.d2h": 1}
    root = spans[0]
    assert root["name"] == f"pipeline.output_{bits}bit" and root["parent"] is None
    assert all(s["parent"] == root["id"] and s["request"] == root["request"] for s in spans[1:])
    assert isinstance(img.data, np.ndarray)


def test_no_timing_lines_at_info(service, caplog):
    with caplog.at_level(logging.INFO, logger="imagepipe_tpu_torch"):
        service.edit("k", {"basecurve": {"exposure": 0.1}})
        Pipeline.new_from_source(_source(), device="cpu").output_8bit()
    assert not [r for r in caplog.records if "timing" in r.getMessage()]
