"""PyTorch port: colour and spline math against the JAX package.

The same numpy inputs go through `imagepipe_tpu.color` / `.spline` and
their counterparts in `imagepipe_tpu_torch`, in both numerics modes.
Floats agree to rtol 1e-6 (XLA-CPU and torch use different libm
transcendentals, a few ULP apart, and XLA may contract a multiply-add into
an FMA). Lab values near 0 come out of the cancellation L = 116*fy - 16,
so they are also allowed an absolute 1e-6 (8 ULP at 1.0).
"""

import numpy as np
import pytest
import torch

import imagepipe_tpu.color as jcc
import imagepipe_tpu.spline as jspline
import imagepipe_tpu_torch.color as tcc
import imagepipe_tpu_torch.spline as tspline

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 1e-6
LAB_ATOL = 1e-6
MODES = ("lut", "direct")


def _inputs(lo=-0.2, hi=1.3, n=4001, seed=0):
    rng = np.random.default_rng(seed)
    v = np.concatenate([np.linspace(lo, hi, n), rng.uniform(lo, hi, n),
                        [0.0, 1.0, 0.0031308, float(jcc._LAB_E)]])
    return v.astype(np.float32)


def _jax(fn, mode, *args):
    with jcc.numerics_mode(mode):
        out = fn(*args)
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else np.asarray(out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_constants_bit_equal():
    for name in ("SRGB_D65_33", "XYZ_D65_33", "XYZ_D65_34", "SRGB_D65_43"):
        np.testing.assert_array_equal(getattr(tcc, name), getattr(jcc, name))
    assert tcc._LAB_E == jcc._LAB_E and tcc._LAB_K == jcc._LAB_K
    assert tcc.SRGB_D65_XYZ_WHITE == jcc.SRGB_D65_XYZ_WHITE
    np.testing.assert_array_equal(tcc._inverse33(jcc.SRGB_D65_33),
                                  jcc._inverse33(jcc.SRGB_D65_33))


@pytest.mark.parametrize("lut", ["XYZ_LAB_TRANSFORM", "SRGB_GAMMA_TRANSFORM"])
@pytest.mark.parametrize("mode", MODES)
def test_transform_lut(lut, mode):
    jl, tl = getattr(jcc, lut), getattr(tcc, lut)
    np.testing.assert_array_equal(tl.table_np, jl.table_np)
    v = _inputs()
    want = _jax(jl, mode, v)
    got = tl(_t(v), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_resolve_numerics():
    assert tcc.resolve_numerics("auto", "cpu") == "lut"
    assert tcc.resolve_numerics("auto", "cuda") == "direct"
    assert tcc.resolve_numerics("direct", "cpu") == "direct"
    with pytest.raises(ValueError):
        tcc.resolve_numerics("fast", "cpu")


def _camera_planes(seed=1, n=20000):
    rng = np.random.default_rng(seed)
    planes = [rng.uniform(-0.05, 1.05, n).astype(np.float32) for _ in range(4)]
    planes[3][:] = 0.0
    mul = np.array([2.1, 1.0, 1.45, 1.0], np.float32)
    cm = np.array([[0.62, 0.21, 0.13, 0.0], [0.27, 0.81, -0.08, 0.0],
                   [0.01, -0.12, 1.21, 0.0]], np.float32)
    return planes, mul, cm


@pytest.mark.parametrize("mode", MODES)
def test_camera_to_lab_planar(mode):
    planes, mul, cm = _camera_planes()
    want = _jax(jcc.camera_to_lab_planar, mode, mul, cm, planes)
    got = tcc.camera_to_lab_planar(mul, cm, [_t(p) for p in planes], mode)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=LAB_ATOL)


def test_lab_to_rgb_planar():
    rng = np.random.default_rng(2)
    lab = [rng.uniform(0.0, 1.0, 20000).astype(np.float32),
           rng.uniform(0.3, 0.7, 20000).astype(np.float32),
           rng.uniform(0.3, 0.7, 20000).astype(np.float32)]
    want = [np.asarray(o) for o in jcc.lab_to_rgb_planar(jcc.XYZ_D65_33, lab)]
    got = tcc.lab_to_rgb_planar(tcc.XYZ_D65_33, [_t(p) for p in lab])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=LAB_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_camera_to_lab_pixels(mode):
    """The [..., 4] -> [..., 3] form, on a [100, 200, 4] image of pixels."""
    planes, mul, cm = _camera_planes(seed=3)
    pix = np.stack(planes, axis=-1).reshape(100, 200, 4)
    want = _jax(jcc.camera_to_lab, mode, mul, cm, pix)
    got = tcc.camera_to_lab(mul, cm, _t(pix), mode).numpy()
    assert got.shape == want.shape == (100, 200, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=LAB_ATOL)


def test_lab_to_rgb_pixels():
    rng = np.random.default_rng(4)
    pix = np.stack([rng.uniform(0.0, 1.0, 20000), rng.uniform(0.3, 0.7, 20000),
                    rng.uniform(0.3, 0.7, 20000)], axis=-1).astype(np.float32).reshape(100, 200, 3)
    want = np.asarray(jcc.lab_to_rgb(jcc.XYZ_D65_33, pix))
    got = tcc.lab_to_rgb(tcc.XYZ_D65_33, _t(pix)).numpy()
    assert got.shape == want.shape == (100, 200, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=LAB_ATOL)


@pytest.mark.parametrize("temp,tint", [(2000.0, 1.0), (5000.0, 0.9), (6504.0, 1.0),
                                       (9000.0, 1.2), (15000.0, 1.05)])
def test_temp_tint_to_rgb(temp, tint):
    """Host float math on the same constants and the same CCT table: equal."""
    assert tcc.temp_tint_to_rgb(temp, tint) == jcc.temp_tint_to_rgb(temp, tint)


@pytest.mark.parametrize("mode", MODES)
def test_apply_srgb_gamma(mode):
    v = np.clip(_inputs(), 0.0, 1.0)
    want = _jax(jcc.apply_srgb_gamma, mode, v)
    got = tcc.apply_srgb_gamma(_t(v), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("bits", [8, 16])
def test_quantizers(bits):
    v = _inputs(-0.1, 1.1, n=70000)
    jq, tq = (jcc.output8bit, tcc.output8bit) if bits == 8 else (jcc.output16bit, tcc.output16bit)
    want = np.asarray(jq(v))
    got = tq(_t(v)).numpy()
    assert got.dtype == want.dtype
    # Same float32 products and the same truncation: bit-equal.
    np.testing.assert_array_equal(got, want)


SPLINE_POINTS = [
    [(0.5, 0.6)],
    [],
    [(0.25, 0.2), (0.5, 0.6), (0.75, 0.85)],
    [(0.1, 0.3), (0.4, 0.35), (0.6, 0.9)],        # non-monotone slopes
    [(0.0, 0.1), (0.5, 0.6 * 2 ** 0.3), (1.0, 1.0)],
]


@pytest.mark.parametrize("points", SPLINE_POINTS)
def test_spline_coefficients_bit_equal(points):
    js, ts = jspline.SplineFunc(points), tspline.SplineFunc(points)
    for f in ("xs", "ys", "c1s", "c2s", "c3s"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2 ** 31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2 ** 31)) - ib, ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("points", SPLINE_POINTS)
def test_eval_spline_arrays(points):
    s = jspline.SplineFunc(points)
    v = _inputs(-0.1, 1.1)
    n = len(s.xs)
    want = np.asarray(jspline.eval_spline_arrays(s.xs, s.ys, s.c1s, s.c2s, s.c3s, n, v))
    got = tspline.eval_spline_arrays(*(_t(a) for a in (s.xs, s.ys, s.c1s, s.c2s, s.c3s)),
                                     n, _t(v)).numpy()
    assert _ulps(got, want).max() <= 2
    np.testing.assert_array_equal(tspline.SplineFunc(points)(_t(v)).numpy(), got)
