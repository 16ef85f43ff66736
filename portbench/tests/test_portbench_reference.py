"""The plain reference against a CPU run of the port at tiny sizes, through
the harness's own run; the same runs with the timed path broken underneath
come out not correct; the bfloat16 control fails every cell's limits."""

import numpy as np
import pytest
import torch

from portbench import control
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_port_matches_the_reference(name):
    result, lines = tiny.run(name)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"]["outputs_compared"]["value"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", tiny.CELLS)
def test_traced_run_reads_the_cells_metrics(name):
    result, _ = tiny.run(name, trace=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def _altered(out):
    out = np.array(out)
    out[0, 0, 0] = (int(out[0, 0, 0]) + 9) % 256
    return out


def _break(monkeypatch, name, fault):
    """Plant `fault` in the program under the cell's timed path."""
    from imagepipe_tpu_torch.parallel import batch
    from imagepipe_tpu_torch import pipeline, service

    if name.endswith(("ingest_full", "ingest_thumb")):
        real = batch.BatchEngine.develop_files

        def develop_files(self, paths, errors="raise"):
            outs = real(self, paths, errors=errors)
            if fault == "altered":
                return [_altered(o) for o in outs]
            return [o if i % 2 else None for i, o in enumerate(outs)]    # half left out

        monkeypatch.setattr(batch.BatchEngine, "develop_files", develop_files)
    elif name.endswith("edit_loop"):
        if fault == "altered":
            real = service.RenderService.edit

            def edit(self, key, patch, **kw):
                img = real(self, key, patch, **kw)
                return pipeline.SRGBImage(img.width, img.height, _altered(img.data))

            monkeypatch.setattr(service.RenderService, "edit", edit)
        else:                                                        # state left unchanged
            monkeypatch.setattr(service.EditSession, "apply", lambda self, patch: None)
    else:
        real = pipeline.Pipeline.output_8bit

        def output_8bit(self, cache=None):
            if fault == "unchanged":
                self.ops.basecurve.exposure = 0.0
            img = real(self, cache)
            if fault == "altered":
                return pipeline.SRGBImage(img.width, img.height, _altered(img.data))
            return img

        monkeypatch.setattr(pipeline.Pipeline, "output_8bit", output_8bit)


FAULTS = [(name, fault) for name in tiny.CELLS
          for fault in (("altered", "half") if "ingest" in name else ("altered", "unchanged"))]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _break(monkeypatch, name, fault)
    result, lines = tiny.run(name)
    assert not result["correct"], lines


@pytest.mark.parametrize("name", tiny.CELLS)
def test_bfloat16_control_fails_the_limits(name):
    d = tiny.driver(name, 2**31 + 21)
    d.setup()
    for i in range(2 if "ingest" in name else 30):
        d.step(i)
    d.release()
    lim = tiny.limits(name)
    program = control.readings(d, None)
    low = control.readings(d, torch.bfloat16)
    assert program[0] <= lim["max_lsb"] and program[1] <= lim["diff_frac"]
    assert low[0] > lim["max_lsb"] or low[1] > lim["diff_frac"]
