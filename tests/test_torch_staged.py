"""PyTorch port: the staged pipeline (ops' `run`, `Pipeline.run`, the stage
cache, `output_8bit(cache)` / `output_16bit(cache)`) against the JAX
package.

Both packages build their pipelines from the same DNG (or the same raster
array) and compare numpy outputs; cache contents never cross.

Tolerances, and why:
  * each op's `run`, fed the same input buffer: allclose rtol 1e-5, atol
    2e-6 in float32. Both run 'lut' numerics on the CPU; XLA's CPU fusion
    rounds some intermediates differently from eager torch (the 1-ULP
    effect tests/test_torch_engine.py notes), and a ULP before a LUT lerp
    or a cbrt can move a Lab value a few ULPs;
  * rotatecrop's crops and the orientation transform: bit-equal (they
    select pixels). Its rotations: atol 2e-6 (tests/test_torch_rotate.py);
  * developed outputs: sizes equal, max |diff| <= 1 LSB on under 2% of
    values (the cross-path contract, kernels/develop.py MAX_LSB,
    MAX_FLIP_FRACTION); cache lengths equal after every request.
"""

import numpy as np
import pytest
import torch

import imagepipe_tpu as jip
from imagepipe_tpu.buffer import OpBuffer as JBuffer
from imagepipe_tpu.cache import MultiCache as JCache
from imagepipe_tpu.dng import write_dng
from imagepipe_tpu.ops import transform as jtransform
from imagepipe_tpu.ops.rotatecrop import OpRotateCrop as JRotateCrop
from imagepipe_tpu.pipeline import PipelineGlobals as JGlobals
from imagepipe_tpu.raw import (CFA, Orientation, RawImage, synthetic_bayer,
                               synthetic_linear, synthetic_mono, synthetic_xtrans)
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.buffer import OpBuffer as TBuffer
from imagepipe_tpu_torch.cache import MultiCache as TCache
from imagepipe_tpu_torch.kernels.develop import MAX_FLIP_FRACTION, MAX_LSB, compare
from imagepipe_tpu_torch.ops import transform as ttransform
from imagepipe_tpu_torch.ops.rotatecrop import OpRotateCrop as TRotateCrop
from imagepipe_tpu_torch.pipeline import PipelineGlobals as TGlobals

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 2e-6


def _assert_contract(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    maxd, frac = compare(got, want)
    assert maxd <= MAX_LSB and frac < MAX_FLIP_FRACTION, (maxd, frac)


def _pair_from_raw(tmp_path, raw, name="frame.dng"):
    path = str(tmp_path / name)
    write_dng(path, raw)
    return jip.Pipeline.new_from_file(path), tip.Pipeline.new_from_file(path, device="cpu")


def _pair_from_array(arr):
    return (jip.Pipeline.new_from_source(jip.ImageSource.from_raster(arr)),
            tip.Pipeline.new_from_source(tip.ImageSource.from_raster(arr), device="cpu"))


def _raster(bits, h=52, w=70, seed=3):
    dtype = np.uint8 if bits == 8 else np.uint16
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max + 1, (h, w, 3), dtype)


def _both(pipes, fn):
    for p in pipes:
        fn(p)


def _output(p, bits, cache):
    return p.output_8bit(cache) if bits == 8 else p.output_16bit(cache)


# -- each op's run ----------------------------------------------------------

SOURCES = {
    "bayer": lambda tp: _pair_from_raw(tp, synthetic_bayer(96, 72, seed=1)),
    "xtrans": lambda tp: _pair_from_raw(tp, synthetic_xtrans(96, 72, seed=2)),
    "mono": lambda tp: _pair_from_raw(tp, synthetic_mono(96, 72, seed=3)),
    "linear rgb": lambda tp: _pair_from_raw(tp, synthetic_linear(96, 72, seed=4)),
    "raster 8-bit": lambda tp: _pair_from_array(_raster(8)),
    "raster 16-bit": lambda tp: _pair_from_array(_raster(16)),
}


def _edit(p):
    p.ops.basecurve.exposure = 0.4
    p.ops.basecurve.points = [(0.2, 0.15), (0.5, 0.62), (0.8, 0.9)]
    p.ops.rotatecrop.rotation = 0.07
    p.ops.rotatecrop.crop_top = 0.05
    p.ops.transform.rotation = type(p.ops.transform.rotation)("Rotate90")
    p.ops.transform.fliph = True


@pytest.mark.parametrize("maxwidth", [0, 30], ids=["full size", "to 30 wide"])
@pytest.mark.parametrize("source", list(SOURCES))
def test_each_op_run_matches_jax(tmp_path, source, maxwidth):
    """Plan both pipelines, then feed every op the JAX op's input and hold
    its output to the JAX op's: gofloat, demosaic (full, scaled, fulldown
    or a 4-plane downscale), rotatecrop, to_lab, basecurve, from_lab,
    gamma, transform."""
    jp, tp = SOURCES[source](tmp_path)
    for p in (jp, tp):
        _edit(p)
        p.globals.settings.maxwidth = maxwidth
        p.globals.settings.use_fastpath = False
        p.run()        # size planning; settings.demosaic_* for demosaic
    jbuf = JBuffer.default()
    for jop, top in zip(jp.ops.all_ops(), tp.ops.all_ops()):
        tin = TBuffer(jbuf.width, jbuf.height, jbuf.colors, jbuf.monochrome,
                      torch.from_numpy(np.asarray(jbuf.data).copy()))
        jbuf, tbuf = jop.run(jp.globals, jbuf), top.run(tp.globals, tin)
        assert ((tbuf.width, tbuf.height, tbuf.colors, tbuf.monochrome)
                == (jbuf.width, jbuf.height, jbuf.colors, jbuf.monochrome)), jop.name()
        np.testing.assert_allclose(tbuf.to_numpy(), np.asarray(jbuf.data), rtol=RTOL,
                                   atol=ATOL, err_msg=jop.name())


def _ramp():
    data = np.arange(100 * 100 * 3, dtype=np.float32).reshape(100, 100, 3)
    return data, JBuffer.from_hwc(data), TBuffer.from_hwc(data, device="cpu")


ROTATECROP = {
    # tests/test_rotatecrop.py:19-79: settings -> (height, width, source
    # pixel of output [0, 0]) or None where only the size is checked.
    "crop_top": ({"crop_top": 0.1}, (90, 100), (10, 0)),
    "crop_bottom": ({"crop_bottom": 0.1}, (90, 100), (0, 0)),
    "crop_vertical": ({"crop_top": 0.1, "crop_bottom": 0.1}, (80, 100), (10, 0)),
    "crop_left": ({"crop_left": 0.1}, (100, 90), (0, 10)),
    "crop_right": ({"crop_right": 0.1}, (100, 90), (0, 0)),
    "crop_both": ({"crop_left": 0.1, "crop_right": 0.1, "crop_top": 0.1,
                   "crop_bottom": 0.1}, (80, 80), (10, 10)),
    "rotate_45": ({"rotation": 0.5}, (141, 141), None),
    "rotate_90": ({"rotation": 1.0}, (100, 100), None),
    "rotate_and_crop": ({"rotation": 0.21, "crop_left": 0.04, "crop_top": 0.02}, None, None),
}


@pytest.mark.parametrize("case", list(ROTATECROP))
def test_rotatecrop_run_matches_jax(case):
    settings, size, origin = ROTATECROP[case]
    data, jbuf, tbuf = _ramp()
    jop, top = JRotateCrop.empty(), TRotateCrop.empty()
    for op in (jop, top):
        for k, v in settings.items():
            setattr(op, k, v)
    jout = jop.run(JGlobals.mock(100, 100), jbuf)
    tout = top.run(TGlobals.mock(100, 100), tbuf)
    assert (tout.width, tout.height, tout.colors) == (jout.width, jout.height, jout.colors)
    got, want = tout.to_numpy(), np.asarray(jout.data)
    if size is not None:
        assert (tout.height, tout.width) == size
    if origin is not None:
        assert got[0, 0, 0] == data[origin[0], origin[1], 0]
        np.testing.assert_array_equal(got, want)
    else:
        # A ramp up to 3e4: 2e-6 relative to its values.
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * 3e4)


@pytest.mark.parametrize("orientation", [o.name for o in Orientation])
def test_transform_rotate_buffer_matches_jax(orientation):
    data = np.random.default_rng(5).random((7, 11, 3), dtype=np.float32)
    jout = jtransform.rotate_buffer(JBuffer.from_hwc(data), Orientation[orientation])
    tout = ttransform.rotate_buffer(TBuffer.from_hwc(data, device="cpu"),
                                    traw.Orientation[orientation])
    assert (tout.width, tout.height) == (jout.width, jout.height)
    np.testing.assert_array_equal(tout.to_numpy(), np.asarray(jout.data))


# -- the staged pipeline ----------------------------------------------------

GEOMETRY = {
    # test_pipeline.py:334-343: 45 degrees, the bounding box 141x141.
    "rotation 0.5": {"rotation": 0.5},
    "rotation 0.1, crop": {"rotation": 0.1, "crop_left": 0.05, "crop_bottom": 0.08},
    "crop only": {"crop_left": 0.125, "crop_top": 0.1},
}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("geometry", list(GEOMETRY))
def test_rotated_cropped_develop_matches_jax(tmp_path, geometry, bits):
    jp, tp = _pair_from_raw(tmp_path, synthetic_bayer(100, 100, seed=6))
    for p in (jp, tp):
        for k, v in GEOMETRY[geometry].items():
            setattr(p.ops.rotatecrop, k, v)
    want, got = _output(jp, bits, None), _output(tp, bits, None)
    assert (got.width, got.height) == (want.width, want.height)
    if geometry == "rotation 0.5":
        assert (got.width, got.height) == (141, 141)
        assert got.data[0, 0].sum() <= got.data[70, 70].sum()
    _assert_contract(got.data, want.data)


def test_dirty_suffix_cache_matches_jax(tmp_path):
    """test_pipeline.py:53-77 in both packages: 8 entries, a full hit adds
    none, an exposure edit 4, a rotation edit 6, a crop-only edit 6 more;
    the same lengths and outputs within the contract at every step."""
    jp, tp = _pair_from_raw(tmp_path, synthetic_bayer(120, 90, seed=7))
    jc, tc = jip.Pipeline.new_cache(200 << 20), tip.Pipeline.new_cache(200 << 20)

    def exposure(p):
        p.ops.basecurve.exposure = 0.5

    def rotate(p):
        p.ops.rotatecrop.rotation = 0.05
        p.ops.rotatecrop.crop_left = 0.05

    def crop_only(p):
        p.ops.rotatecrop.rotation = 0.0

    steps = [(None, 8), (None, 8), (exposure, 12), (None, 12), (rotate, 18), (crop_only, 24)]
    first = None
    for edit, want_len in steps:
        if edit is not None:
            _both((jp, tp), edit)
        want, got = jp.output_8bit(jc), tp.output_8bit(tc)
        assert len(tc) == len(jc) == want_len
        _assert_contract(got.data, want.data)
        if first is None:
            first = got.data
    again = tp.output_8bit(tc)
    np.testing.assert_array_equal(again.data, got.data)
    assert len(tc) == 24


def test_cache_respects_linear_flag(tmp_path):
    """test_pipeline.py:79-91: 8-bit and 16-bit outputs hash apart."""
    jp, tp = _pair_from_raw(tmp_path, synthetic_bayer(80, 60, seed=8))
    jc, tc = JCache(200 << 20), TCache(200 << 20)
    for bits in (8, 16, 8):
        want, got = _output(jp, bits, jc), _output(tp, bits, tc)
        _assert_contract(got.data, want.data)
        assert len(tc) == len(jc)
    assert len(tc) == 16
    out8 = tp.output_8bit(tc).data
    assert not np.array_equal(out8, (tp.output_16bit(tc).data >> 8).astype(np.uint8))


def test_cache_eviction_exact_semantics():
    """test_pipeline.py:269-299 on both caches, step by step: eviction
    order, byte accounting, the over-budget singleton, owner tags."""
    caches = (JCache(100), TCache(100))
    steps = [("put", b"a", 40, "x"), ("put", b"b", 40, None), ("put", b"c", 40, "x"),
             ("get", b"b"), ("put", b"d", 40, "y"), ("get", b"a"), ("put", b"e", 150, "y"),
             ("put", b"f", 30, "x"), ("put", b"f", 50, "y")]
    for step in steps:
        results = []
        for c in caches:
            if step[0] == "put":
                c.put(step[1], step[1].decode().upper(), step[2], owner=step[3])
                results.append(None)
            else:
                results.append(c.get(step[1]))
        assert results[0] == results[1], step
        assert [(len(c), c.total_bytes, c.bytes_for("x"), c.bytes_for("y")) for c in caches][0] \
            == (len(caches[1]), caches[1].total_bytes, caches[1].bytes_for("x"),
                caches[1].bytes_for("y")), step
    assert (len(caches[1]), caches[1].total_bytes) == (1, 50)
    assert caches[1].get(b"f") == "F" and caches[1].bytes_for("x") == 0


@pytest.mark.parametrize("budget", [3 * 120 * 80 * 4 * 4, 16], ids=["3 stages", "under one"])
def test_cache_eviction_under_pressure(tmp_path, budget):
    """test_pipeline.py:301-331: a small cache evicts its oldest stages (a
    tiny one keeps the newest alone) and re-renders stay right."""
    jp, tp = _pair_from_raw(tmp_path, synthetic_bayer(120, 80, seed=9))
    jc, tc = JCache(budget), TCache(budget)
    for edit in (None, None, 0.25):
        if edit is not None:
            _both((jp, tp), lambda p: setattr(p.ops.basecurve, "exposure", edit))
        want, got = jp.output_8bit(jc), tp.output_8bit(tc)
        _assert_contract(got.data, want.data)
        assert len(tc) == len(jc) and tc.total_bytes == jc.total_bytes
        assert len(tc) == 1 or tc.total_bytes <= budget
    fresh = tip.Pipeline.new_from_source(tp.globals.image, device="cpu")
    fresh.ops.basecurve.exposure = 0.25
    np.testing.assert_array_equal(got.data, fresh.output_8bit(TCache(1 << 30)).data)


@pytest.mark.parametrize("bits", [8, 16])
def test_oriented_frame_staged_matches_jax(tmp_path, bits):
    raw = synthetic_bayer(100, 60, seed=10)
    raw.orientation = Orientation.Rotate90
    raw.crops = (2, 4, 6, 8)
    jp, tp = _pair_from_raw(tmp_path, raw)
    _both((jp, tp), lambda p: setattr(p.globals.settings, "use_fastpath", False))
    want, got = _output(jp, bits, None), _output(tp, bits, None)
    assert (got.width, got.height) == (want.width, want.height) == (52, 88)
    _assert_contract(got.data, want.data)


def _mono_raw():
    """test_pipeline.py:142-163: a cpp=1, CFA-less gradient."""
    h, w = 40, 60
    grad = np.linspace(0, 16383, w, dtype=np.uint16)[None, :] * np.ones((h, 1), np.uint16)
    return RawImage(width=w, height=h, cpp=1, crops=(0, 0, 0, 0), blacklevels=(0,) * 4,
                    whitelevels=(16383,) * 4, wb_coeffs=(1.0, 1.0, 1.0, 0.0),
                    xyz_to_cam=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]], np.float32),
                    orientation=Orientation.Normal, cfa=CFA(""), data=grad)


def test_monochrome_raw_staged_matches_jax(tmp_path):
    jp, tp = _pair_from_raw(tmp_path, _mono_raw())
    jc, tc = JCache(64 << 20), TCache(64 << 20)
    want, got = jp.output_8bit(jc), tp.output_8bit(tc)
    _assert_contract(got.data, want.data)
    np.testing.assert_array_equal(got.data[..., 0], got.data[..., 2])
    assert got.data[..., 0].mean(axis=0)[-1] > got.data[..., 0].mean(axis=0)[0] + 100


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("depth", [8, 16])
def test_edited_raster_matches_jax(depth, bits):
    """A raster with an edit (exposure, a rotation) cannot take the fast
    path: gofloat's raster ingest (sRGB expand for 8-bit, /65535 for
    16-bit), then the staged chain."""
    jp, tp = _pair_from_array(_raster(depth))
    for p in (jp, tp):
        p.ops.basecurve.exposure = 0.5
        p.ops.rotatecrop.rotation = 0.04
    want, got = _output(jp, bits, None), _output(tp, bits, None)
    _assert_contract(got.data, want.data)


@pytest.mark.parametrize("bits", [8, 16])
def test_raster_use_fastpath_false_matches_jax(bits):
    jp, tp = _pair_from_array(_raster(8, seed=11))
    _both((jp, tp), lambda p: setattr(p.globals.settings, "use_fastpath", False))
    jc, tc = JCache(64 << 20), TCache(64 << 20)
    want, got = _output(jp, bits, jc), _output(tp, bits, tc)
    _assert_contract(got.data, want.data)
    assert len(tc) == len(jc) == 8


@pytest.mark.parametrize("make", [traw.synthetic_bayer, traw.synthetic_xtrans,
                                  traw.synthetic_mono, traw.synthetic_linear],
                         ids=["bayer", "xtrans", "mono", "linear rgb"])
@pytest.mark.parametrize("bits", [8, 16])
def test_staged_matches_fused_in_port(make, bits):
    """The staged path (a cache given) and the one-pass develop (cache=None)
    of the port on the same frame."""
    p = tip.Pipeline.new_from_source(tip.ImageSource.from_raw(make(90, 60, seed=12)),
                                     device="cpu")
    p.ops.basecurve.exposure = 0.2
    fused = _output(p, bits, None)
    staged = _output(p, bits, TCache(64 << 20))
    _assert_contract(staged.data, fused.data)


def test_run_returns_the_final_buffer(tmp_path):
    jp, tp = _pair_from_raw(tmp_path, synthetic_bayer(64, 48, seed=13))
    _both((jp, tp), lambda p: setattr(p.ops.rotatecrop, "rotation", 0.1))
    jbuf, tbuf = jp.run(), tp.run()
    assert isinstance(tbuf, TBuffer)
    assert (tbuf.width, tbuf.height, tbuf.colors) == (jbuf.width, jbuf.height, jbuf.colors)
    np.testing.assert_allclose(tbuf.to_numpy(), np.asarray(jbuf.data), rtol=RTOL, atol=1e-5)
    # The rotated frame's rotatecrop runs alone; the tail after it is one
    # fused segment (pipeline.FUSE_SUFFIX).
    names = [op.name() for op in tp.ops.all_ops()]
    assert list(tp.stage_ms) == names[:3] + ["+".join(names[3:])]


def test_serial_with_rotatecrop_renders_like_jax(tmp_path):
    jp, tp = _pair_from_raw(tmp_path, synthetic_xtrans(96, 72, seed=14))
    tp.ops.rotatecrop.rotation = 0.15
    tp.ops.rotatecrop.crop_right = 0.1
    tp.ops.basecurve.exposure = -0.3
    serial = tp.to_serial()
    jback = jip.Pipeline.new_from_serial(jp.globals.image, serial)
    tback = tip.Pipeline.new_from_serial(tp.globals.image, serial, device="cpu")
    assert tback.ops == tp.ops
    _assert_contract(tback.output_8bit(None).data, jback.output_8bit(None).data)


def test_float_and_cpp3_raws_staged_match_jax(tmp_path):
    """test_pipeline.py:216-255: an f32 sensor payload and a cpp=3 linear
    RAW develop staged like the JAX package's."""
    rng = np.random.default_rng(0)
    fraw = RawImage(width=64, height=48, cpp=1, crops=(0, 0, 0, 0), blacklevels=(0,) * 4,
                    whitelevels=(1,) * 4, wb_coeffs=(2.0, 1.0, 1.5, float("nan")),
                    xyz_to_cam=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]],
                                        np.float32),
                    orientation=Orientation.Normal, cfa=CFA("RGGB"),
                    data=rng.uniform(0.0, 1.0, (48, 64)).astype(np.float32))
    tsrc = tip.ImageSource.from_raw(traw.RawImage(**{k: getattr(fraw, k) for k in (
        "width", "height", "cpp", "crops", "blacklevels", "whitelevels", "wb_coeffs",
        "xyz_to_cam", "data")}, orientation=traw.Orientation.Normal, cfa=traw.CFA("RGGB")))
    jp = jip.Pipeline.new_from_source(jip.ImageSource.from_raw(fraw))
    tp = tip.Pipeline.new_from_source(tsrc, device="cpu")
    _both((jp, tp), lambda p: setattr(p.globals.settings, "use_fastpath", False))
    _assert_contract(tp.output_8bit().data, jp.output_8bit().data)

    jl, tl = _pair_from_raw(tmp_path, synthetic_linear(56, 40, seed=15), "linear.dng")
    _both((jl, tl), lambda p: setattr(p.globals.settings, "use_fastpath", False))
    _assert_contract(tl.output_8bit().data, jl.output_8bit().data)
