"""PyTorch port: the axis-aligned resampler against the JAX package and the
scalar oracle.

`imagepipe_tpu_torch.scaling.scale_down_planar` and the JAX package's
`imagepipe_tpu.scaling.scale_down_planar` resample the same seeded planes,
CFA-aware (the fused demosaic-downscale) and per channel, at scales ~2
(the paraboloid's max(0, .) clamp engages inside windows), ~6 (window
<= 16), ~25 (window 17-40) and ~50 (beyond the Pallas kernels' envelope).

Tolerances, and why:
  * against the JAX resampler run op by op (`jax.disable_jit`): bit-equal.
    Both form every product and sum in the same order with one rounding
    each;
  * against the jitted JAX resampler: rtol=1e-6, atol=1e-7. XLA's CPU
    fusion rounds some intermediates differently (the same 1-ULP effect
    tests/test_torch_engine.py notes for the develop);
  * against tests/oracle.py (scalar float32 loops of scaling.rs):
    bit-equal, as every numpy float32 scalar step rounds once in the same
    order;
  * `scale_down_srgb{,16}` against the JAX functions run op by op:
    bit-equal after the truncating quantize. Against the jitted ones the
    1-ULP float differences above can cross an integer before the
    truncation: max |diff| <= 1 on under 2% of values (the cross-path
    contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from imagepipe_tpu import scaling as jscaling
from imagepipe_tpu.raw import CFA as JCFA
from imagepipe_tpu_torch import scaling as tscaling
from imagepipe_tpu_torch.raw import CFA
from imagepipe_tpu_torch.kernels.develop import MAX_FLIP_FRACTION, MAX_LSB, compare

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

XTRANS = "GBGGRGRGRBGBGBGGRGRGRBGBGBGGRGGRGGBG"
CFAS = {"bayer": "RGGB", "xtrans": XTRANS, "planes": None}
# Output width of a 600x400 source: scale ~2, ~6, ~25, ~50.
WIDTHS = {"s2": 300, "s6": 100, "s25": 24, "s50": 12}
RTOL, ATOL = 1e-6, 1e-7


def _case(kind, scale, w=600, h=400, seed=0):
    nw = WIDTHS[scale] * w // 600
    nh = tscaling.scaling_size(w, h, nw, 0)[1]
    rng = np.random.default_rng(seed)
    src = rng.random((1 if CFAS[kind] else 4, h, w), dtype=np.float32)
    return src, nw, nh


def _port(src, nw, nh, name):
    cfa = CFA(name) if name else None
    return tscaling.scale_down_planar(torch.from_numpy(src), nw, nh, 4, cfa=cfa).numpy()


def _jax(src, nw, nh, name):
    cfa = JCFA(name) if name else None
    return np.asarray(jscaling.scale_down_planar(jnp.asarray(src), nw, nh, 4, cfa=cfa))


@pytest.mark.parametrize("scale", list(WIDTHS))
@pytest.mark.parametrize("kind", list(CFAS))
def test_scale_down_planar_matches_jax(kind, scale):
    src, nw, nh = _case(kind, scale)
    got = _port(src, nw, nh, CFAS[kind])
    want = _jax(src, nw, nh, CFAS[kind])
    assert got.shape == want.shape == (4, nh, nw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", ["s2", "s6"])
@pytest.mark.parametrize("kind", ["bayer", "planes"])
def test_scale_down_planar_bit_equal_to_unjitted_jax(kind, scale):
    src, nw, nh = _case(kind, scale, w=300, h=200, seed=1)
    with jax.disable_jit():
        want = _jax(src, nw, nh, CFAS[kind])
    np.testing.assert_array_equal(_port(src, nw, nh, CFAS[kind]), want)


@pytest.mark.parametrize("kind", list(CFAS))
@pytest.mark.parametrize("size", [(60, 40, 30, 20), (60, 40, 10, 6), (72, 48, 3, 2),
                                  (33, 57, 8, 14)])
def test_resampler_matches_oracle(kind, size):
    w, h, nw, nh = size
    name = CFAS[kind]
    src = np.random.default_rng(2).random((1 if name else 4, h, w), dtype=np.float32)
    got = _port(src, nw, nh, name)
    if name:
        want = oracle.transform_buffer(src.ravel(), w, h, (0, 0), (w - 1, 0), (0, h - 1),
                                       nw, nh, 4, JCFA(name))
    else:
        want = oracle.transform_buffer(np.moveaxis(src, 0, -1).ravel(), w, h, (0, 0),
                                       (w - 1, 0), (0, h - 1), nw, nh, 4)
    want = np.moveaxis(want.reshape(nh, nw, 4), -1, 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("size", [(97, 61, 40), (200, 120, 31)])
def test_scale_down_srgb_bit_equal(bits, size):
    w, h, nw = size
    nh = tscaling.scaling_size(w, h, nw, 0)[1]
    dtype = np.uint8 if bits == 8 else np.uint16
    data = np.random.default_rng(3).integers(0, np.iinfo(dtype).max + 1, (h, w, 3), dtype)
    port = tscaling.scale_down_srgb if bits == 8 else tscaling.scale_down_srgb16
    ref = jscaling.scale_down_srgb if bits == 8 else jscaling.scale_down_srgb16
    got = port(torch.from_numpy(data), nw, nh).numpy()
    with jax.disable_jit():
        want = np.asarray(ref(data, nw, nh))
    assert got.dtype == want.dtype == dtype and got.shape == (nh, nw, 3)
    np.testing.assert_array_equal(got, want)
    maxd, frac = compare(got, np.asarray(ref(data, nw, nh)))
    assert maxd <= MAX_LSB and frac < MAX_FLIP_FRACTION, (maxd, frac)


def test_host_index_math_matches_jax():
    v = np.array([-3.5, -0.0, 0.2, 7.9, 8.0, 12.7, np.nan, np.inf], np.float32)
    for maxv in (0, 8, 100):
        np.testing.assert_array_equal(tscaling.sat_floor_np(v, maxv),
                                      jscaling.sat_floor_np(v, maxv))
    for args in [(6000, 4000, 1024, 682), (601, 401, 24, 16), (50, 40, 49, 40)]:
        w, h, nw, nh = args
        g = tscaling.aligned_axes(w, h, (0, 0), (w - 1, 0), (0, h - 1), nw, nh)
        assert g.from_x.shape == g.to_x.shape == g.cx.shape == (nw,)
        assert g.from_y.shape == g.to_y.shape == g.cy.shape == (nh,)
        assert g.k_x == int((g.to_x - g.from_x).max()) + 1
        assert g.from_x[0] == 0 and g.to_x[-1] == w - 1 and g.to_y[-1] == h - 1


def test_rotated_geometry_raises():
    src = torch.zeros((40, 50, 3))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tscaling.transform_buffer(src, 50, 40, (5, 2), (44, 12), (-3, 33), 37, 29, 3)
