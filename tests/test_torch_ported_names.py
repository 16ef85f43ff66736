"""PyTorch port: the last public names of the JAX package, against it.

* `engine.develop_batch_fn(plan)`: one plan's calibration over a batch,
  against the JAX `develop_batch_fn` on the same plan (`plan_from_jax`):
  max |diff| <= 1 LSB on under 2% of values (kernels/develop.py MAX_LSB,
  MAX_FLIP_FRACTION), and bit-equal to the port's own single-image
  `develop_fused`, as the JAX function is to the JAX one
  (tests/test_engine.py).
* `engine.stack_params`: stacks key by key and unstacks to its inputs.
* `kernels/demosaic_full.stencil_demosaic` (stacked and planar) and
  `demosaic_full`: allclose rtol 1e-5, atol 2e-6 to the JAX functions, the
  tolerance tests/test_torch_staged.py holds the staged demosaic op to.
* `kernels/develop_scaled.scaled_plan_for`: None exactly where the JAX
  function is None over rgb, mono, full-size, 'fulldown' and 1-px plans;
  otherwise the port's geometry and launch plan.
* `PipelineSettings.hash(hasher=...)`: the JAX keyword, equal hashes.
"""

import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource, Pipeline
from imagepipe_tpu import engine as jengine
from imagepipe_tpu.buffer import OpBuffer as JBuffer
from imagepipe_tpu.hasher import BufHasher as JHasher
from imagepipe_tpu.kernels import demosaic_full as jdf
from imagepipe_tpu.kernels import develop_scaled as jds
from imagepipe_tpu.pipeline import PipelineSettings as JSettings
from imagepipe_tpu.raw import (CFA, synthetic_bayer, synthetic_linear, synthetic_mono,
                               synthetic_xtrans)
from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch.buffer import OpBuffer as TBuffer
from imagepipe_tpu_torch.hasher import BufHasher as THasher
from imagepipe_tpu_torch.kernels import demosaic_full as tdf
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds
from imagepipe_tpu_torch.pipeline import PipelineSettings as TSettings
from imagepipe_tpu_torch.raw import CFA as TCFA

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 2e-6


def _assert_contract(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    maxd, frac = kdev.compare(got, want)
    assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)


def _jax_plan(raw, maxwidth=0, bits=8):
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.maxwidth = maxwidth
    p.globals.settings.linear = bits == 16
    return jengine.make_develop_plan(p, out_bits=bits)


BATCHES = {
    # (raws, maxwidth): tests/test_engine.py's batches.
    "bayer full size": (lambda: [synthetic_bayer(96, 64, seed=s) for s in range(5)], 0),
    "bayer thumbnails": (lambda: [synthetic_bayer(192, 128, seed=s) for s in range(3)], 64),
    "xtrans": (lambda: [synthetic_xtrans(96, 66, seed=s) for s in range(3)], 0),
    "rgb": (lambda: [synthetic_linear(48, 40, seed=s) for s in range(3)], 0),
}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("case", list(BATCHES))
def test_develop_batch_fn_matches_jax(case, bits):
    make, maxwidth = BATCHES[case]
    raws = make()
    plan = _jax_plan(raws[0], maxwidth, bits)
    batch = np.stack([r.data for r in raws])
    want = np.asarray(jengine.develop_batch_fn(plan)(batch))
    tplan = tengine.plan_from_jax(plan, "cpu")
    got = tengine.develop_batch_fn(tplan)(torch.from_numpy(batch))
    assert got.dtype == (torch.uint8 if bits == 8 else torch.uint16)
    _assert_contract(got.numpy(), want)
    for i, raw in enumerate(raws):
        single = tengine.develop_fused(tplan, torch.from_numpy(np.ascontiguousarray(raw.data)))
        assert torch.equal(got[i], single)


def test_develop_batch_fn_takes_host_arrays_and_flat_rgb():
    raws = [synthetic_linear(48, 40, seed=s) for s in range(2)]
    tplan = tengine.plan_from_jax(_jax_plan(raws[0]), "cpu")
    fn = tengine.develop_batch_fn(tplan)
    hwc = np.stack([r.data.reshape(r.data.shape[0], -1, 3) for r in raws])
    flat = hwc.reshape(hwc.shape[0], hwc.shape[1], -1)
    assert torch.equal(fn(flat), fn(torch.from_numpy(hwc)))


def test_stack_params_round_trips():
    raws = [synthetic_bayer(96, 64, seed=s) for s in range(3)]
    plans = []
    for i, raw in enumerate(raws):
        p = Pipeline.new_from_source(ImageSource.from_raw(raw))
        p.ops.basecurve.exposure = 0.1 * i
        plans.append(tengine.plan_from_jax(jengine.make_develop_plan(p), "cpu"))
    stacked = tengine.stack_params([p.params for p in plans])
    assert set(stacked) == set(plans[0].params)
    for k, v in stacked.items():
        assert torch.is_tensor(v) and v.shape == (3, *plans[0].params[k].shape)
        for i, p in enumerate(plans):
            assert torch.equal(v[i], p.params[k])
    host = tengine.stack_params([{k: v.numpy() for k, v in p.params.items()} for p in plans])
    for k, v in host.items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, stacked[k].numpy())
    # The JAX function stacks the same values.
    jstacked = jengine.stack_params([{k: v.numpy() for k, v in p.params.items()}
                                     for p in plans])
    for k, v in jstacked.items():
        np.testing.assert_array_equal(np.asarray(v), stacked[k].numpy())


DEMOSAICS = {
    "bayer": lambda: synthetic_bayer(64, 48, seed=2),
    "xtrans": lambda: synthetic_xtrans(66, 48, seed=2),
    "bayer odd": lambda: synthetic_bayer(61, 47, seed=2),
    "xtrans odd": lambda: synthetic_xtrans(37, 29, seed=2),
}


def _levels(raw):
    rng = np.random.default_rng(5)
    return rng.uniform(-0.1, 1.0, (raw.height, raw.width)).astype(np.float32)


@pytest.mark.parametrize("case", list(DEMOSAICS))
def test_stencil_demosaic_matches_jax(case):
    raw = DEMOSAICS[case]()
    name = raw.cropped_cfa().name
    plane = _levels(raw)
    h, w = plane.shape
    want = np.asarray(jdf.stencil_demosaic(plane, name, h, w))
    got = tdf.stencil_demosaic(torch.from_numpy(plane), name, h, w)
    assert got.shape == (h, w, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    planes = tdf.stencil_demosaic(torch.from_numpy(plane), name, h, w, stacked=False)
    jplanes = jdf.stencil_demosaic(plane, name, h, w, stacked=False)
    assert len(planes) == len(jplanes) == 4
    for p, jp in zip(planes, jplanes):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(torch.stack(planes, dim=-1).numpy(), got.numpy())


@pytest.mark.parametrize("case", list(DEMOSAICS))
def test_demosaic_full_matches_jax(case):
    raw = DEMOSAICS[case]()
    name = raw.cropped_cfa().name
    plane = _levels(raw)
    h, w = plane.shape
    want = jdf.demosaic_full(CFA(name), JBuffer(w, h, 1, False, plane[None]))
    got = tdf.demosaic_full(TCFA(name), TBuffer(w, h, 1, False, torch.from_numpy(plane[None])))
    assert ((got.width, got.height, got.colors, got.monochrome)
            == (want.width, want.height, want.colors, want.monochrome) == (w, h, 4, False))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        got.data.numpy(),
        torch.stack(tdf.stencil_demosaic_planes(torch.from_numpy(plane), name, h, w)).numpy())


SCALED_PLANS = {
    # (raw, maxwidth, maxheight, dem_path)
    "rgb": (lambda: synthetic_linear(480, 320), 96, 0, "plaindown"),
    "mono": (lambda: synthetic_mono(480, 320), 96, 0, "plaindown"),
    "full": (lambda: synthetic_bayer(480, 320), 0, 0, "full"),
    "fulldown": (lambda: synthetic_bayer(480, 320), 300, 0, "fulldown"),
    "1 px wide": (lambda: synthetic_bayer(480, 320), 1, 0, "scaled"),
    "1 px high": (lambda: synthetic_bayer(480, 320), 0, 1, "scaled"),
    "bayer scaled": (lambda: synthetic_bayer(480, 320), 96, 0, "scaled"),
    "xtrans scaled": (lambda: synthetic_xtrans(480, 320), 72, 0, "scaled"),
}


@pytest.mark.parametrize("case", list(SCALED_PLANS))
def test_scaled_plan_for_is_none_where_jax_is(case):
    make, maxwidth, maxheight, dem_path = SCALED_PLANS[case]
    raw = make()
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.maxwidth = maxwidth
    p.globals.settings.maxheight = maxheight
    plan = jengine.make_develop_plan(p, numerics="direct")
    assert plan.dem_path == dem_path
    tplan = tengine.plan_from_jax(plan, "cpu")
    sp = kds.scaled_plan_for(tplan)
    assert (sp is None) == (jds.scaled_plan_for(plan) is None)
    if sp is None:
        return
    assert sp.key == (plan.height, plan.width, plan.dem_h, plan.dem_w, plan.cfa_name)
    geom = kds.scaled_geometry(tplan)
    assert set(sp.geometry) == set(geom)
    for k, v in sp.geometry.items():
        assert torch.equal(torch.from_numpy(np.ascontiguousarray(v)), geom[k])
    assert sp.launch == kds.scaled_plan(tplan, kdev.calib_tables(tplan)[1].shape[-1])
    plane = torch.from_numpy(np.ascontiguousarray(raw.data))
    assert torch.equal(kds.develop_scaled(tplan, plane, sp), kds.develop_scaled(tplan, plane))


def test_scaled_plan_of_another_shape_class_is_refused():
    plan = tengine.plan_from_jax(_jax_plan(synthetic_bayer(480, 320), 96), "cpu")
    other = tengine.plan_from_jax(_jax_plan(synthetic_bayer(480, 320), 72), "cpu")
    plane = torch.zeros((320, 480), dtype=torch.uint16)
    with pytest.raises(ValueError, match="ScaledPlan"):
        kds.develop_scaled(other, plane, kds.scaled_plan_for(plan))


@pytest.mark.parametrize("settings", [{}, {"maxwidth": 1024, "linear": True},
                                      {"maxheight": 7, "use_fastpath": False}])
def test_settings_hash_by_keyword_matches_jax(settings):
    hashes = []
    for Settings, Hasher in ((JSettings, JHasher), (TSettings, THasher)):
        h = Hasher()
        Settings(**settings).hash(hasher=h)
        hashes.append(h.result())
    assert hashes[0] == hashes[1]
    h = THasher()
    TSettings(maxwidth=3).hash(hasher=h)
    assert h.result() != hashes[0]
