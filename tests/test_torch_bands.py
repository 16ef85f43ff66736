"""PyTorch port: the banded eager develop, `engine.develop_fused(plan, plane,
bands)`.

A full-size cfa plan develops in row bands with 1-row halos clamped at the
image edges, each band's CFA pattern re-anchored to its first row, the
halo rows dropped, the bands concatenated and then flipped: bit-equal to
bands=1 for every band count (the stencil is 3x3-local, every other stage
pointwise), and within the cross-path contract (max |diff| <= 1 LSB on
under 2% of values) of the JAX package's `develop_fused(bands=k)` on the
same plan. `bands=None` is the JAX package's rule (one band per ~24 MP
above 30 MP), and other plans develop whole. The `cuda`-marked test holds
the bands bit-equal on the card.
"""

import types

import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource as JSource
from imagepipe_tpu import Pipeline as JPipeline
from imagepipe_tpu import engine as jengine
from imagepipe_tpu import raw as jraw
from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch import pipeline as tpipeline
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.sources import ImageSource as TSource

torch.set_num_threads(1)


def _plan(make, width, height, bits=8, orientation=None, crops=None, numerics="lut",
          maxwidth=0, seed=21):
    """(JAX plan, the port's plan from it on the CPU, the sensor data)."""
    raw = getattr(jraw, make)(width, height, seed=seed)
    if orientation is not None:
        raw.orientation = jraw.Orientation(orientation)
    if crops is not None:
        raw.crops = crops
    pipe = JPipeline.new_from_source(JSource.from_raw(raw))
    pipe.globals.settings.linear = bits == 16
    pipe.globals.settings.maxwidth = maxwidth
    jplan = jengine.make_develop_plan(pipe, out_bits=bits, numerics=numerics)
    return jplan, tengine.plan_from_jax(jplan, "cpu"), raw.data


# (generator, width, height, bits, orientation, crops, numerics)
CASES = {
    "bayer": ("synthetic_bayer", 96, 61, 8, None, None, "lut"),
    "bayer-16-rot90-crop": ("synthetic_bayer", 98, 67, 16, "Rotate90", (3, 2, 4, 5), "lut"),
    "xtrans-transverse": ("synthetic_xtrans", 90, 73, 8, "Transverse", None, "direct"),
    "xtrans-odd-crop": ("synthetic_xtrans", 84, 59, 8, None, (1, 3, 5, 7), "lut"),
}


@pytest.mark.parametrize("bands", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_bands_bit_equal_and_match_jax(case, bands):
    make, width, height, bits, orientation, crops, numerics = CASES[case]
    jplan, plan, data = _plan(make, width, height, bits, orientation, crops, numerics)
    plane = torch.from_numpy(data)
    got = tengine.develop_fused(plan, plane, bands=bands)
    assert torch.equal(got, tengine.develop_fused(plan, plane, bands=1))
    want = np.asarray(jengine.develop_fused(jplan, data, bands=bands))
    assert tuple(got.shape) == want.shape
    maxd, frac = kdev.compare(got, want)
    assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)


def test_auto_bands_is_the_jax_rule():
    """One band up to 30 MP, then one per ~24 MP (the 61 MP frame of the
    card's check takes 3)."""
    def plan(w, h):
        return types.SimpleNamespace(width=w, height=h)

    for (w, h), want in (((6000, 4000), 1), ((6000, 5000), 1), ((6000, 5001), 2),
                         ((9504, 6336), 3), ((12000, 8000), 4), ((1, 1), 1)):
        pixels = w * h
        jax_rule = max(1, pixels // (24_000_000 + 1) + 1) if pixels > 30_000_000 else 1
        assert tengine.auto_bands(plan(w, h)) == jax_rule == want


@pytest.mark.parametrize("make,maxwidth", [("synthetic_mono", 0), ("synthetic_linear", 0),
                                           ("synthetic_bayer", 40)])
def test_other_plans_develop_whole(make, maxwidth):
    """mono, rgb and resize plans are not banded: any band count gives the
    unbanded develop."""
    _, plan, data = _plan(make, 96, 64, maxwidth=maxwidth)
    assert plan.mode != "cfa" or plan.dem_path != "full"
    plane = torch.from_numpy(data)
    assert torch.equal(tengine.develop_fused(plan, plane, bands=3),
                       tengine.develop_fused(plan, plane, bands=1))


def test_pipeline_develops_with_auto_bands(monkeypatch):
    """The eager route of `Pipeline._run_fused` lets `develop_fused` choose
    its bands (`bands=None`), as the JAX package's pipeline does."""
    seen = []
    real = tengine.develop_fused

    def spy(plan, plane, bands=None):
        seen.append(bands)
        return real(plan, plane, bands)

    monkeypatch.setattr(tpipeline, "develop_fused", spy)
    pipe = tpipeline.Pipeline.new_from_source(
        TSource.from_raw(traw.synthetic_bayer(64, 48, seed=1)), device="cpu")
    pipe.output_8bit()
    assert seen == [None]


@pytest.mark.cuda
def test_bands_on_card_bit_equal():
    """On the card, in 'lut' and 'direct' numerics, 3 bands equal 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the banded develop on the card")
    for numerics in ("lut", "direct"):
        _, plan, data = _plan("synthetic_xtrans", 600, 400, 16, "Rotate90", numerics=numerics)
        plan = plan.to("cuda")
        plane = torch.from_numpy(data).to("cuda")
        assert torch.equal(tengine.develop_fused(plan, plane, bands=3),
                           tengine.develop_fused(plan, plane, bands=1))
