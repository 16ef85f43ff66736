"""PyTorch port: the width-sharded develop and the batch engine's spatial axis.

* `kernels.develop.develop_sp` on CPU devices (its plain version,
  `develop_sp_plain`: each shard developed from its own padded columns with
  global validity and CFA colour, the halos exchanged, the outputs
  assembled and flipped) against the JAX package's `develop_pallas_sp` in
  interpret mode on the 8 virtual CPU devices of tests/conftest.py, as
  tests/test_engine.py runs it: Bayer, X-Trans, an odd crop origin, an
  uneven split at spatial=3 and Rotate90. Contract (the JAX test's own):
  max |diff| <= 1 LSB on under 1% of values. Against the port's unsharded
  `develop_plain` it is bit-equal: no per-pixel operation or order depends
  on the shard.
* `BatchEngine(devices=["cpu"] * 4, spatial=2)` with direct-numerics plans
  and per-image white balance against the JAX engine's Pallas executor on a
  dp x sp mesh (<= 1 LSB, under 2%), and bit-equal to the port's spatial=1
  engine; thumbnails are never width-sharded.
* The split rule, the staging layout, the halo exchange and the wrappers'
  refusals. The shard launch itself is compared on the card by the
  `cuda`-marked test at the end.
"""

import jax
import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource as JSource
from imagepipe_tpu import Pipeline as JPipeline
from imagepipe_tpu import raw as jraw
from imagepipe_tpu.engine import make_develop_plan
from imagepipe_tpu.kernels.develop_pallas import develop_pallas_sp
from imagepipe_tpu.parallel import BatchEngine as JBatchEngine
from imagepipe_tpu.parallel import make_batch_mesh as jax_mesh
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.parallel import BatchEngine, make_batch_mesh
from imagepipe_tpu_torch.sources import ImageSource as TSource

torch.set_num_threads(1)


def _raw(module, make, width, height, seed, crops=None, orientation=None, wb=None):
    r = getattr(module, make)(width, height, seed=seed)
    if crops is not None:
        r.crops = crops
    if orientation is not None:
        r.orientation = module.Orientation(orientation)
    if wb is not None:
        r.wb_coeffs = wb
    return r


def _jax_plan(raw, bits=8):
    pipe = JPipeline.new_from_source(JSource.from_raw(raw))
    pipe.globals.settings.linear = bits == 16
    return make_develop_plan(pipe, out_bits=bits, numerics="direct")


def _contract(got, want, flip_fraction):
    maxd, frac = kdev.compare(got, want)
    assert maxd <= kdev.MAX_LSB and frac < flip_fraction, (maxd, frac)


SP_CASES = {   # (generator, width, height, crops (top, right, bottom, left), orientation, spatial, bits)
    "bayer": ("synthetic_bayer", 864, 128, None, None, 2, 8),
    "xtrans": ("synthetic_xtrans", 864, 128, None, None, 2, 8),
    "odd-origin-16bit": ("synthetic_bayer", 880, 134, (3, 5, 7, 11), None, 2, 16),
    "uneven-spatial3": ("synthetic_bayer", 864, 128, None, None, 3, 8),
    "rotate90": ("synthetic_bayer", 864, 128, None, "Rotate90", 2, 8),
}


@pytest.mark.parametrize("case", list(SP_CASES))
def test_develop_sp_matches_jax_and_unsharded(case):
    make, width, height, crops, orientation, spatial, bits = SP_CASES[case]
    raw = _raw(jraw, make, width, height, 7, crops, orientation)
    jplan = _jax_plan(raw, bits)
    mesh = jax_mesh(jax.devices()[:2 * spatial], spatial=spatial)
    want = np.asarray(develop_pallas_sp(jplan, raw.data, mesh))

    plan = tengine.plan_from_jax(jplan, "cpu")
    shards = tengine.stage_sp(plan, raw.data, spatial)
    assert len(shards) == spatial
    before = kdev.SP_LAUNCHES
    got = kdev.develop_sp(plan, shards, ["cpu"] * spatial)
    assert kdev.SP_LAUNCHES == before               # on the CPU: the plain version
    assert tuple(got.shape) == want.shape
    _contract(got, want, 0.01)
    unsharded = kdev.develop_plain(plan, torch.from_numpy(raw.data))
    assert torch.equal(got, unsharded)


def test_develop_sp_batch_plain_per_image_calibration():
    """The batched form: one exchange over [B, H, w + 2] shards, each image
    with its own calibration, bit-equal to the unsharded batch."""
    raws = [_raw(jraw, "synthetic_xtrans", 300, 72, s, wb=wb)
            for s, wb in ((1, None), (2, (1.0, 1.0, 2.6, float("nan"))), (3, None))]
    plans = [tengine.plan_from_jax(_jax_plan(r), "cpu") for r in raws]
    shards = tengine.stage_sp(plans[0], [r.data for r in raws], 3)
    assert [tuple(s.shape) for s in shards] == [(3, 72, 130), (3, 72, 130), (3, 72, 46)]
    got = kdev.develop_sp_batch(plans, shards, ["cpu"] * 3)
    want = kdev.develop_batch_plain(plans, torch.from_numpy(np.stack([r.data for r in raws])))
    assert torch.equal(got, want)
    assert not torch.equal(got[0], got[1])


def test_sp_shards_split_rule():
    """Whole 128-column tiles for every shard but the last, which takes the
    rest; a crop narrower than spatial - 1 tiles gets fewer shards."""
    assert tengine.sp_shards(6000, 2) == [(0, 3072), (3072, 2928)]
    assert tengine.sp_shards(6000, 3) == [(0, 2048), (2048, 2048), (4096, 1904)]
    assert tengine.sp_shards(9504, 3) == [(0, 3200), (3200, 3200), (6400, 3104)]
    assert tengine.sp_shards(256, 2) == [(0, 128), (128, 128)]
    assert tengine.sp_shards(96, 2) == [(0, 96)]
    assert tengine.sp_shards(300, 1) == [(0, 300)]
    for width in (1, 127, 129, 6017, 9504):
        for spatial in (1, 2, 3, 4):
            shards = tengine.sp_shards(width, spatial)
            assert len(shards) <= spatial
            assert sum(w for _, w in shards) == width
            assert all(w % 128 == 0 for _, w in shards[:-1])
            assert all(x == sum(w for _, w in shards[:i]) for i, (x, _) in enumerate(shards))
    with pytest.raises(ValueError):
        tengine.sp_shards(100, 0)


def test_stage_and_exchange_halos():
    """Staging puts a shard's own columns at 1..w and zeros at both ends;
    the exchange copies each neighbour's edge column into the inner halos
    and leaves the outer ones zero."""
    raw = _raw(traw, "synthetic_bayer", 300, 20, 1, crops=(1, 2, 3, 5))
    plan = tengine.make_develop_plan(tip.Pipeline.new_from_source(TSource.from_raw(raw), "cpu"),
                                     numerics="direct")
    crop = raw.data[plan.crop_y:plan.crop_y + plan.height, plan.crop_x:plan.crop_x + plan.width]
    shards = tengine.stage_sp(plan, raw.data, 3)
    assert [tuple(s.shape) for s in shards] == [(16, 130), (16, 130), (16, 39)]
    for s in shards:
        assert not s[:, 0].any() and not s[:, -1].any()
    tengine.exchange_halos(shards)
    full = np.concatenate([s[:, 1:-1].numpy() for s in shards], axis=1)
    np.testing.assert_array_equal(full, crop)
    np.testing.assert_array_equal(shards[1][:, 0].numpy(), crop[:, 127])
    np.testing.assert_array_equal(shards[0][:, -1].numpy(), crop[:, 128])
    np.testing.assert_array_equal(shards[2][:, 0].numpy(), crop[:, 255])
    np.testing.assert_array_equal(shards[1][:, -1].numpy(), crop[:, 256])
    assert not shards[0][:, 0].any() and not shards[2][:, -1].any()
    batch = tengine.stage_sp(plan, [raw.data, raw.data], 2)
    assert [tuple(s.shape) for s in batch] == [(2, 16, 258), (2, 16, 39)]
    np.testing.assert_array_equal(batch[1][1, :, 1:-1].numpy(), crop[:, 256:])


def test_develop_sp_refuses_what_it_does_not_take():
    raw = _raw(traw, "synthetic_bayer", 300, 20, 1)
    plan = tengine.make_develop_plan(tip.Pipeline.new_from_source(TSource.from_raw(raw), "cpu"),
                                     numerics="direct")
    shards = tengine.stage_sp(plan, raw.data, 3)
    with pytest.raises(ValueError, match="3 shards for 2 devices"):
        kdev.develop_sp(plan, shards, ["cpu"] * 2)
    with pytest.raises(ValueError, match="columns of a crop"):
        kdev.develop_sp(plan, shards[:2], ["cpu"] * 3)
    with pytest.raises(ValueError, match="more than one type"):
        kdev.develop_sp(plan, shards, ["cpu", "cpu", "meta"])
    with pytest.raises(TypeError, match="dtype"):
        kdev.develop_sp(plan, [s.to(torch.int32) for s in shards], ["cpu"] * 3)
    with pytest.raises(ValueError, match="contiguous"):
        kdev.develop_sp(plan, [s[None] for s in shards], ["cpu"] * 3)
    with pytest.raises(ValueError, match="contiguous"):
        kdev.develop_sp_batch([plan], shards, ["cpu"] * 3)
    meta = [torch.empty(tuple(s.shape), dtype=s.dtype, device="meta") for s in shards]
    with pytest.raises(ValueError, match="unsupported device"):
        kdev.develop_sp(plan, meta, ["meta"] * 3)


# -- the batch engine's spatial axis ---------------------------------------

class _DirectPort(BatchEngine):
    def _plan_for(self, source):
        pipe = tip.Pipeline.new_from_source(source, device="cpu")
        pipe.globals.settings.maxwidth, pipe.globals.settings.maxheight = self.maxwidth, self.maxheight
        return tengine.make_develop_plan(pipe, out_bits=self.out_bits, numerics="direct")


class _DirectJax(JBatchEngine):
    def _plan_for(self, source):
        pipe = JPipeline.new_from_source(source)
        return make_develop_plan(pipe, out_bits=self.out_bits, numerics="direct")


def _counting(monkeypatch):
    calls = []
    real = kdev.develop_sp_batch

    def counted(plans, shards, devices):
        calls.append((len(plans), len(shards), list(devices)))
        return real(plans, shards, devices)

    monkeypatch.setattr(kdev, "develop_sp_batch", counted)
    return calls


def test_batch_engine_spatial_matches_jax_dp_sp(monkeypatch):
    """dp x sp on four CPU devices: each chunk width-sharded across its
    row of two, chunks round-robin over the two rows; equal to the JAX
    engine's Pallas executor on its dp x sp mesh within the contract, and
    bit-equal to the port's spatial=1 engine."""
    raws = [_raw(traw, "synthetic_bayer", 864, 96, 80 + s) for s in range(5)]
    jraws = [_raw(jraw, "synthetic_bayer", 864, 96, 80 + s) for s in range(5)]
    for r in (raws[2], jraws[2]):
        r.wb_coeffs = (1.0, 1.0, 2.5, float("nan"))
    calls = _counting(monkeypatch)
    eng = _DirectPort(devices=["cpu"] * 4, spatial=2, max_batch=4)
    assert eng.rows == make_batch_mesh(["cpu"] * 4, 2)
    outs = eng.develop_sources([TSource.from_raw(r) for r in raws])
    assert calls == [(4, 2, [torch.device("cpu")] * 2), (1, 2, [torch.device("cpu")] * 2)]
    jouts = _DirectJax(jax_mesh(spatial=2), max_batch=4, executor="pallas").develop_sources(
        [JSource.from_raw(r) for r in jraws])
    unsharded = _DirectPort(devices=["cpu"], max_batch=4).develop_sources(
        [TSource.from_raw(r) for r in raws])
    for out, jout, flat in zip(outs, jouts, unsharded):
        assert out.shape == (96, 864, 3)
        _contract(out, jout, kdev.MAX_FLIP_FRACTION)
        np.testing.assert_array_equal(out, flat)
    assert not np.array_equal(outs[0], outs[2])


@pytest.mark.parametrize("orientation", ["Normal", "Rotate90"])
def test_batch_engine_spatial_per_image_calibration(monkeypatch, orientation):
    """Same-shape X-Trans frames with different white balance, 16-bit,
    spatial=3 on one repeated device (the one-card form): each keeps its
    own calibration, flips permute the assembled image, and the results
    are bit-equal to spatial=1."""
    raws = [_raw(traw, "synthetic_xtrans", 600, 60, 40, orientation=orientation),
            _raw(traw, "synthetic_xtrans", 600, 60, 40, orientation=orientation,
                 wb=(1.0, 1.0, 3.0, float("nan")))]
    calls = _counting(monkeypatch)
    eng = _DirectPort(devices=["cpu"] * 3, spatial=3, out_bits=16)
    outs = eng.develop_sources([TSource.from_raw(r) for r in raws])
    assert calls == [(2, 3, [torch.device("cpu")] * 3)]
    flat = _DirectPort(devices=["cpu"], out_bits=16).develop_sources(
        [TSource.from_raw(r) for r in raws])
    for out, want in zip(outs, flat):
        assert out.dtype == np.uint16
        np.testing.assert_array_equal(out, want)
    assert not np.array_equal(outs[0], outs[1])


def test_batch_engine_spatial_thumbnails_develop_whole(monkeypatch):
    """'scaled' plans are never width-sharded: under spatial=2 a thumbnail
    chunk develops whole on its row's first device, bit-equal to spatial=1."""
    raws = [_raw(traw, "synthetic_bayer", 600, 400, 30 + s) for s in range(2)]
    calls = _counting(monkeypatch)
    eng = _DirectPort(devices=["cpu"] * 2, spatial=2, maxwidth=96)
    plan = eng._plan_for(TSource.from_raw(raws[0]))
    assert plan.dem_path == "scaled" and eng._use_kernel(plan) and not eng._sharded(plan)
    outs = eng.develop_sources([TSource.from_raw(r) for r in raws])
    assert calls == []
    flat = _DirectPort(devices=["cpu"], maxwidth=96).develop_sources(
        [TSource.from_raw(r) for r in raws])
    for out, want in zip(outs, flat):
        assert out.shape[1] == 96
        np.testing.assert_array_equal(out, want)


def test_make_batch_mesh():
    assert make_batch_mesh(["cpu"] * 6, 3) == [[torch.device("cpu")] * 3] * 2
    assert make_batch_mesh(["cpu", "meta"], 1) == [[torch.device("cpu")], [torch.device("meta")]]
    for devices, spatial in ((["cpu"] * 4, 3), (["cpu"], 0), ([], 1)):
        with pytest.raises(ValueError, match="rows of spatial"):
            make_batch_mesh(devices, spatial)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bayer-spatial2", "xtrans-spatial3"])
def test_shard_launch_matches_unsharded_launch_on_card(case):
    """Shard launches at their column offsets, assembled, are bit-equal to
    the unsharded launch, and hold the contract against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    make, spatial = {"bayer-spatial2": ("synthetic_bayer", 2),
                     "xtrans-spatial3": ("synthetic_xtrans", 3)}[case]
    raw = _raw(traw, make, 880, 134, 5, crops=(3, 5, 7, 11), orientation="Rotate90")
    plan = tengine.make_develop_plan(tip.Pipeline.new_from_source(TSource.from_raw(raw), "cuda"),
                                     numerics="direct")
    shards = tengine.stage_sp(plan, raw.data, spatial)
    before = kdev.SP_LAUNCHES
    got = kdev.develop_sp(plan, shards, ["cuda"] * spatial)
    torch.cuda.synchronize()
    assert kdev.SP_LAUNCHES == before + spatial
    assert torch.equal(got, kdev.develop(plan, torch.from_numpy(raw.data).cuda()))
    plain = kdev.develop_sp_plain(plan, [s.cuda() for s in shards])
    _contract(got, plain, kdev.MAX_FLIP_FRACTION)
