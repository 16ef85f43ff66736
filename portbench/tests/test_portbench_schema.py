"""BENCHMARK.json against the benchmark's contract: keys, names, units and
lengths, and every name found as a file under portbench/."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == KEYS["config"] and NAME.match(c["name"])
    assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert json.load(open(os.path.join(harness.ROOT, c["file"])))["name"] == c["name"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads(w):
    assert set(w) == KEYS["workload"] and NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _line(w["why"])
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    for part in (("traffic", f"{w['traffic']}.json"), ("checks", f"{w['name']}.json")):
        assert os.path.isfile(os.path.join(harness.HERE, *part))
    reported = [m["name"] for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in reported and len(reported) >= 2
    traffic = json.load(open(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json")))
    produced = {"ingest_mp_s"} if traffic["kind"] == "ingest" else set(traffic["percentiles"])
    assert set(reported) - {"setup_s"} == produced
    assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert set(m) - {"workloads"} == KEYS["end_to_end"] and NAME.match(m["name"])
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) == KEYS["per_layer"] | {"workloads"} and NAME.match(m["name"])
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for w in m["workloads"]:
        assert w in e2e[m["moves"]].get("workloads", [w])
    assert os.path.isfile(os.path.join(harness.HERE, "metrics", f"{m['name']}.py"))
    if "roofline" in m["name"]:
        assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
