"""What a later cell may change by data alone: the kinds and containers are
found by the names in the traffic and configuration files, the output's
bits and the program's numerics come from those files, and the comparison
reads the output's own type."""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import load_kind
from portbench.tests import tiny

TRAFFIC = sorted(glob.glob(os.path.join(harness.HERE, "traffic", "*.json")))
CONFIGS = sorted(glob.glob(os.path.join(harness.HERE, "configs", "*.json")))


@pytest.mark.parametrize("path", TRAFFIC, ids=os.path.basename)
def test_each_traffic_names_a_kind_file(path):
    with open(path) as f:
        kind = json.load(f)["kind"]
    driver = load_kind(kind)
    for method in ("setup", "step", "end_to_end", "readings", "release", "checks"):
        assert callable(getattr(driver, method))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_each_config_names_a_container_file(path):
    import importlib

    with open(path) as f:
        writer = json.load(f)["container"]["writer"]
    module = importlib.import_module(f"portbench.containers.{writer}")
    assert module.SUFFIX.startswith(".") and callable(module.encode)


@pytest.mark.parametrize("dtype,steps", [(torch.uint8, 256), (torch.uint16, 65536)])
def test_compare_reads_the_outputs_type(dtype, steps):
    want = torch.full((2, 3, 3), 200, dtype=dtype)
    got = want.numpy().copy()
    assert harness.compare(got, want) == (0, 0.0)
    got[0, 0, 0] += 7
    lsb, frac = harness.compare(got, want)
    assert lsb == 7 and frac == pytest.approx(1 / 18)
    assert harness.compare(got.astype(np.int32), want) == (steps, 1.0)
    assert harness.compare(got[:1], want) == (steps, 1.0)


def test_compare_reads_a_float_output_in_sixteen_bit_steps():
    want = torch.full((4,), 0.5)
    got = want.numpy().copy()
    got[0] += 3 / 65536
    lsb, frac = harness.compare(got, want)
    assert lsb == 3 and frac == 0.25


def _bits16(c):
    c["output"]["bits"] = 16
    return c


@pytest.mark.parametrize("name", tiny.CELLS)
def test_a_sixteen_bit_output_is_developed_and_checked(name):
    """The configuration's `output.bits` reaches the program and the
    reference: 16-bit linear outputs, compared in 16-bit LSB (a 16-bit
    cell sets limits of its own; at these sizes the port reads 1)."""
    result, lines = tiny.run(name, config_edit=_bits16,
                             limits_={"max_lsb": 3, "diff_frac": 1.0})
    assert result["correct"], lines
    d = tiny.driver(name, 2**31 + 7, config_edit=_bits16)
    d.setup()
    d.step(0)
    d.release()
    (_, got, want), *_ = d.checks(torch.float32)
    assert got.dtype == np.uint16 and want.dtype == torch.uint16


@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_traffics_numerics_hold_for_the_run(name, monkeypatch):
    from imagepipe_tpu_torch import color

    seen = []
    real = load_kind(tiny.cell_files(name)[1]["kind"])
    step = real.step
    monkeypatch.setattr(real, "step", lambda self, i: (seen.append(color.get_numerics_mode()),
                                                       step(self, i))[1])
    result, lines = tiny.run(name, traffic_edit=lambda t: dict(t, numerics="direct"))
    assert result["correct"], lines
    assert seen and set(seen) == {"direct"}
    assert color._NUMERICS_MODE is None


def test_a_metric_that_reads_nothing_is_named(capsys):
    result, _ = tiny.run("bayer24.ingest_full", trace=True)
    out = capsys.readouterr().out
    assert "develop_roofline.ingest" not in result["metrics"]
    assert "per-layer metric develop_roofline.ingest read nothing" in out


def test_the_edit_windows_level_is_the_programs_own():
    """The traced edit run keeps the window at the program's logging level
    and reads the stages' times from a block replayed after it."""
    log = logging.getLogger("imagepipe_tpu_torch")
    levels = []
    real = load_kind("edit")
    d = tiny.driver("bayer24.edit_loop", 2**31 + 9, trace=True)
    step, stage_times, replayed = d.step, d.stage_times, []
    d.step = lambda i: (levels.append(log.getEffectiveLevel()), step(i))[1]
    d.stage_times = lambda: replayed.extend(stage_times()) or replayed
    result, lines = harness.measure(d, "bayer24.edit_loop", tiny.BENCH,
                                    tiny.limits("bayer24.edit_loop"), 0.3, 0.0)
    assert result["correct"], lines
    assert isinstance(d, real) and levels and logging.DEBUG not in levels
    assert len(replayed) == d.traffic["stage_block"]
    assert all("demosaic" in stages for stages in replayed)
    assert result["metrics"]["edit.demosaic_stage_ms"]["value"] > 0
    assert log.level == logging.NOTSET
