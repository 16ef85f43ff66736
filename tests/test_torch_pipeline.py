"""PyTorch port: Pipeline, ops, serials and the CLI against the JAX package.

A DNG written by `imagepipe_tpu.dng.write_dng` goes through both packages'
`Pipeline.new_from_file(...).output_8bit()` / `output_16bit()`: max |diff|
<= 1 LSB, under 2% of values differing. Op content hashes and YAML serials
are byte-identical, before and after edits. What the port has not ported
yet raises NotImplementedError naming its ROADMAP item.
"""

import numpy as np
import pytest
import torch

import imagepipe_tpu as jip
from imagepipe_tpu.dng import write_dng
from imagepipe_tpu.raw import (Orientation, synthetic_bayer, synthetic_mono,
                               synthetic_xtrans)
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import cli
from imagepipe_tpu_torch.kernels.develop import MAX_FLIP_FRACTION, MAX_LSB, compare

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _dng(tmp_path, raw, name="frame.dng"):
    path = str(tmp_path / name)
    write_dng(path, raw)
    return path


@pytest.fixture
def bayer_dng(tmp_path):
    raw = synthetic_bayer(168, 112, seed=4)
    raw.orientation = Orientation.Rotate270
    raw.crops = (2, 4, 6, 8)
    return _dng(tmp_path, raw)


def _assert_contract(got, want):
    maxd, frac = compare(got, want)
    assert maxd <= MAX_LSB and frac < MAX_FLIP_FRACTION, (maxd, frac)


@pytest.mark.parametrize("make", [synthetic_bayer, synthetic_xtrans, synthetic_mono])
@pytest.mark.parametrize("bits", [8, 16])
def test_output_matches_jax(tmp_path, make, bits):
    path = _dng(tmp_path, make(174, 114, seed=5))
    jp = jip.Pipeline.new_from_file(path)
    tp = tip.Pipeline.new_from_file(path, device="cpu")
    want = jp.output_8bit() if bits == 8 else jp.output_16bit()
    got = tp.output_8bit() if bits == 8 else tp.output_16bit()
    assert (got.width, got.height) == (want.width, want.height)
    _assert_contract(got.data, want.data)


def test_edited_output_matches_jax(bayer_dng):
    jp = jip.Pipeline.new_from_file(bayer_dng)
    tp = tip.Pipeline.new_from_file(bayer_dng, device="cpu")
    for p in (jp, tp):
        p.ops.basecurve.exposure = 0.3
        p.ops.basecurve.points = [(0.2, 0.15), (0.5, 0.62), (0.8, 0.9)]
        p.ops.tolab.set_temp(5200.0, 1.05)
    _assert_contract(tp.output_8bit().data, jp.output_8bit().data)


def _edits():
    def exposure(p):
        p.ops.basecurve.exposure = 0.7

    def points(p):
        p.ops.basecurve.points = [(0.1, 0.05), (0.5, 0.55), (0.9, 0.97)]

    def orientation(p):
        p.ops.transform.rotation = type(p.ops.transform.rotation)("Rotate180")
        p.ops.transform.fliph = True

    def temperature(p):
        p.ops.tolab.set_temp(4300.0, 0.98)

    return {"default": None, "exposure": exposure, "points": points,
            "orientation": orientation, "temperature": temperature}


@pytest.mark.parametrize("edit", list(_edits()))
def test_hash_and_serial_match_jax(bayer_dng, edit):
    jp = jip.Pipeline.new_from_file(bayer_dng)
    tp = tip.Pipeline.new_from_file(bayer_dng, device="cpu")
    fn = _edits()[edit]
    if fn is not None:
        fn(jp)
        fn(tp)
    assert tp.ops.content_hash() == jp.ops.content_hash()
    assert tp.to_serial() == jp.to_serial()
    for jop, top in zip(jp.ops.all_ops(), tp.ops.all_ops()):
        assert top.name() == jop.name()
        assert top.shash() == jop.shash()
        assert top.to_settings() == jop.to_settings()
    assert tp.ops.tolab.get_temp() == jp.ops.tolab.get_temp()
    # The port's serial loads into the port and the JAX package alike.
    back = tip.Pipeline.new_from_serial(tp.globals.image, tp.to_serial(), device="cpu")
    assert back.ops == tp.ops
    jback = jip.Pipeline.new_from_serial(jp.globals.image, tp.to_serial())
    assert jback.ops.content_hash() == jp.ops.content_hash()
    assert tp.default_ops() == (fn is None)


SIZE_SETUPS = {
    # (maxwidth, maxheight, rotation) -> dem_path for Bayer / X-Trans / mono
    "no limit": (0, 0, "Normal"),                 # full everywhere
    "limit above size": (4000, 3000, "Normal"),   # full everywhere
    "thumbnail": (60, 50, "Normal"),              # scaled / fulldown / plaindown
    "slight downscale": (100, 0, "Rotate90"),     # fulldown / fulldown / plaindown
}


@pytest.mark.parametrize("make", [synthetic_bayer, synthetic_xtrans, synthetic_mono])
@pytest.mark.parametrize("setup", list(SIZE_SETUPS))
def test_size_planning_matches_jax(tmp_path, make, setup):
    from imagepipe_tpu.engine import make_develop_plan as jax_plan
    from imagepipe_tpu_torch.engine import make_develop_plan as port_plan

    path = _dng(tmp_path, make(150, 104, seed=8))
    maxw, maxh, rotation = SIZE_SETUPS[setup]
    jp = jip.Pipeline.new_from_file(path)
    tp = tip.Pipeline.new_from_file(path, device="cpu")
    for p in (jp, tp):
        p.globals.settings.maxwidth, p.globals.settings.maxheight = maxw, maxh
        p.ops.transform.rotation = type(p.ops.transform.rotation)(rotation)
    want, got = jax_plan(jp, out_bits=8), port_plan(tp, out_bits=8)
    for k in ("dem_path", "dem_w", "dem_h", "height", "width", "crop_x", "crop_y",
              "mode", "cfa_name", "n_knots"):
        assert getattr(got, k) == getattr(want, k), k
    assert tp.ops.content_hash() == jp.ops.content_hash()
    got_img, want_img = tp.output_8bit(), jp.output_8bit()
    assert (got_img.width, got_img.height) == (want_img.width, want_img.height)
    _assert_contract(got_img.data, want_img.data)


def test_raster_fastpath_matches_jax(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(6).integers(0, 256, (40, 56, 3), np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(rgb).save(path)
    for bits in (8, 16):
        jp = jip.Pipeline.new_from_file(path)
        tp = tip.Pipeline.new_from_file(path, device="cpu")
        want = jp.output_8bit() if bits == 8 else jp.output_16bit()
        got = tp.output_8bit() if bits == 8 else tp.output_16bit()
        np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("limits", [(96, 0), (0, 50), (80, 40)])
def test_thumbnail_output_matches_jax(tmp_path, limits, bits):
    raw = synthetic_bayer(240, 160, seed=9)
    raw.orientation = Orientation.Rotate90
    path = _dng(tmp_path, raw)
    jp = jip.Pipeline.new_from_file(path)
    tp = tip.Pipeline.new_from_file(path, device="cpu")
    for p in (jp, tp):
        p.globals.settings.maxwidth, p.globals.settings.maxheight = limits
    want = jp.output_8bit() if bits == 8 else jp.output_16bit()
    got = tp.output_8bit() if bits == 8 else tp.output_16bit()
    assert (got.width, got.height) == (want.width, want.height)
    assert got.width <= (limits[0] or 160) and got.height <= (limits[1] or 240)
    _assert_contract(got.data, want.data)


def test_simple_decode_8bit_thumbnail(bayer_dng):
    got = tip.simple_decode_8bit(bayer_dng, maxwidth=40, device="cpu")
    want = jip.simple_decode_8bit(bayer_dng, 40)
    assert (got.width, got.height) == (want.width, want.height) == (40, 60)
    _assert_contract(got.data, want.data)


def test_raster_fastpath_downscale_matches_jax(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(7).integers(0, 256, (81, 123, 3), np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(rgb).save(path)
    for bits in (8, 16):
        jp = jip.Pipeline.new_from_file(path)
        tp = tip.Pipeline.new_from_file(path, device="cpu")
        for p in (jp, tp):
            p.globals.settings.maxwidth = 50
        want = jp.output_8bit() if bits == 8 else jp.output_16bit()
        got = tp.output_8bit() if bits == 8 else tp.output_16bit()
        assert (got.width, got.height) == (want.width, want.height) == (50, 32)
        assert got.data.dtype == want.data.dtype
        _assert_contract(got.data, want.data)


def test_simple_decode_8bit(bayer_dng):
    got = tip.simple_decode_8bit(bayer_dng, device="cpu")
    want = jip.simple_decode_8bit(bayer_dng)
    _assert_contract(got.data, want.data)


def test_cli_on_dng_and_png(tmp_path, bayer_dng, capsys):
    from PIL import Image

    out = str(tmp_path / "out.jpg")
    assert cli.main(["converter", bayer_dng, out], device="cpu") == 0
    with Image.open(out) as im:
        want = jip.simple_decode_8bit(bayer_dng)
        assert im.size == (want.width, want.height)
    png = str(tmp_path / "in.png")
    Image.fromarray(np.full((20, 30, 3), 128, np.uint8)).save(png)
    assert cli.main(["converter", png], device="cpu") == 0
    with Image.open(png + ".jpg") as im:
        assert im.size == (30, 20)
    assert cli.main(["converter"], device="cpu") == 1
    assert cli.main(["converter", str(tmp_path / "missing.dng")], device="cpu") == 2


def test_out_of_slice_entry_points_raise(bayer_dng, tmp_path):
    from PIL import Image

    from imagepipe_tpu_torch.parallel import BatchEngine, MultiHostBatchEngine
    from imagepipe_tpu_torch.service import EditSession, RenderService

    p = tip.Pipeline.new_from_file(bayer_dng, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        p.output_8bit(cache=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        p.run()
    for op in p.ops.all_ops():
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            op.run(p.globals, None)
    p.ops.rotatecrop.rotation = 0.1
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        p.output_16bit()
    png = str(tmp_path / "edit.png")
    Image.fromarray(np.zeros((12, 16, 3), np.uint8)).save(png)
    r = tip.Pipeline.new_from_file(png, device="cpu")
    r.ops.basecurve.exposure = 0.5
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        r.output_8bit()
    for cls, item in ((MultiHostBatchEngine, "A11"), (EditSession, "A10"),
                      (RenderService, "A10")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            cls()
    # The batch engine is ported; its width-sharded axis is not.
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        BatchEngine(devices=["cpu"], spatial=2)


def test_sensor_plane_cache_is_the_ports_own(bayer_dng):
    p = tip.Pipeline.new_from_file(bayer_dng, device="cpu")
    p.output_8bit()
    raw = p.globals.image.raw
    device, plane = raw._torch_plane
    assert device == torch.device("cpu") and torch.is_tensor(plane)
    assert not hasattr(raw, "_device_plane") and not hasattr(raw, "_pallas_staged")
