"""PyTorch port: the rotated resampler (kernels/rotate.py, scaling.py)
against the JAX package.

The port's plain version (`rotate_resample_plain`, `scaling.
_transform_rotated`; what `rotate_resample_planar` runs for a CPU tensor)
resamples the same seeded planes as:

  * the JAX gather loop `scaling._transform_impl`, jitted: max |diff| <=
    2e-6 (atol, rtol 0), the JAX package's own Pallas-vs-gather tolerance
    (tests/test_rotate_pallas.py:73). XLA's CPU fusion rounds some
    intermediates differently. Run op by op (`jax.disable_jit`) it is
    bit-equal: the same float32 operations in the same order;
  * the Pallas kernel `rotate_pallas.rotate_resample_planar` in interpret
    mode, where `rotate_plan` takes the geometry: the six CASES of
    test_rotate_pallas.py and a seeded random-geometry sweep, atol 2e-6;
  * the scalar oracle `tests/oracle.transform_buffer`, within that file's
    envelope ((diff > 1e-4).mean() < 0.005, max < 5e-3): near-45-degree
    windows degenerate and amplify ULPs through sum / count;
  * the degenerate geometries that `rotate_plan` refuses (an output extent
    of 1, a zero x-step, a window beyond its unroll bound), and the
    CFA-aware mode, against `_transform_impl` at 2e-6.

The host tables (`scaling.rotated_geometry`) equal `rotate_plan`'s bit for
bit. The CUDA kernel is compared with its plain version on the card by the
`cuda`-marked tests below and by chip_smoke.py (phase 1c).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from imagepipe_tpu import scaling as jscaling
from imagepipe_tpu.kernels import rotate_pallas as rp
from imagepipe_tpu.raw import CFA as JCFA
from imagepipe_tpu_torch import scaling as tscaling
from imagepipe_tpu_torch.kernels import rotate as krot
from imagepipe_tpu_torch.raw import CFA

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

f32 = np.float32
ATOL = 2e-6


def _corners(theta_deg, w, h, nw, nh, scale=1.0):
    """Inverse-mapped corner triple, as tests/test_rotate_pallas.py."""
    a = np.deg2rad(theta_deg)
    s, c = np.sin(a), np.cos(a)

    def rot(x, y):
        tx, ty = x - nw / 2, y - nh / 2
        return (int(f32((tx * c + ty * s) * scale + w / 2)),
                int(f32((-tx * s + ty * c) * scale + h / 2)))

    return rot(0, 0), rot(nw - 1, 0), rot(0, nh - 1)


CASES = [
    # (theta, w, h, nw, nh, scale, C): tests/test_rotate_pallas.py:54-62
    (4, 150, 120, 140, 110, 1.0, 4),
    (27, 160, 140, 150, 130, 1.0, 3),
    (45, 130, 130, 180, 180, 1.0, 4),     # degenerate windows, half empty
    (45, 140, 100, 150, 110, 1.4, 4),
    (75, 120, 120, 110, 110, 1.0, 1),     # mostly empty windows
    (12, 200, 90, 90, 40, 2.2, 4),        # rotation + downscale
]
CASE_IDS = [f"{c[0]}deg-{c[3]}x{c[4]}-C{c[6]}" for c in CASES]


def _data(seed, h, w, c):
    return np.random.default_rng(seed).random((h, w, c), dtype=np.float32)


def _port(data, w, h, tl, tr, bl, nw, nh, C):
    src = torch.from_numpy(np.ascontiguousarray(np.moveaxis(data, -1, 0)))
    return np.moveaxis(krot.rotate_resample_planar(src, w, h, tl, tr, bl, nw, nh, C).numpy(),
                       0, -1)


def _gather(data, w, h, tl, tr, bl, nw, nh, C, cfa=None):
    tile = jnp.asarray(cfa.pattern_tile(), jnp.uint8) if cfa else jnp.zeros((48, 48), jnp.uint8)
    return np.asarray(jscaling._transform_impl(
        jnp.asarray(data), tile, width=w, height=h, topleft=tl, topright=tr,
        bottomleft=bl, nwidth=nw, nheight=nh, components=C,
        cfa_key=cfa.name if cfa else None, out_dtype=jnp.float32))


def _pallas(data, w, h, tl, tr, bl, nw, nh, C):
    plan = rp.rotate_plan(w, h, tl, tr, bl, nw, nh, C)
    assert plan is not None
    out = rp.rotate_resample_planar(jnp.moveaxis(jnp.asarray(data), -1, 0), w, h, tl, tr,
                                    bl, nw, nh, C, interpret=True, plan=plan)
    return np.moveaxis(np.asarray(out), 0, -1)


@pytest.mark.parametrize("theta,w,h,nw,nh,sc,C", CASES, ids=CASE_IDS)
def test_plain_matches_gather_impl(theta, w, h, nw, nh, sc, C):
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    data = _data(theta * 7 + C, h, w, C)
    got = _port(data, w, h, tl, tr, bl, nw, nh, C)
    assert got.shape == (nh, nw, C)
    np.testing.assert_allclose(got, _gather(data, w, h, tl, tr, bl, nw, nh, C),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("theta,w,h,nw,nh,sc,C", CASES, ids=CASE_IDS)
def test_plain_matches_rotate_pallas_interpret(theta, w, h, nw, nh, sc, C):
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    data = _data(theta * 11 + C, h, w, C)
    np.testing.assert_allclose(_port(data, w, h, tl, tr, bl, nw, nh, C),
                               _pallas(data, w, h, tl, tr, bl, nw, nh, C), rtol=0, atol=ATOL)


@pytest.mark.parametrize("theta,w,h,nw,nh,sc,C", CASES, ids=CASE_IDS)
def test_plain_matches_oracle(theta, w, h, nw, nh, sc, C):
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    data = _data(theta * 13 + C, h, w, C)
    want = oracle.transform_buffer(data.ravel(), w, h, tl, tr, bl, nw, nh, C).reshape(nh, nw, C)
    diff = np.abs(_port(data, w, h, tl, tr, bl, nw, nh, C) - want)
    assert (diff > 1e-4).mean() < 0.005
    assert diff.max() < 5e-3


def test_plain_bit_equal_to_unjitted_gather_impl():
    w, h, nw, nh = 60, 48, 56, 44
    tl, tr, bl = _corners(21, w, h, nw, nh, 1.1)
    data = _data(5, h, w, 4)
    with jax.disable_jit():
        want = _gather(data, w, h, tl, tr, bl, nw, nh, 4)
    np.testing.assert_array_equal(_port(data, w, h, tl, tr, bl, nw, nh, 4), want)


@pytest.mark.parametrize("chunk", range(3))
def test_random_geometry_sweep(chunk):
    """Random corner triples (shears, mirrored axes, out-of-bounds corners):
    the plain version holds 2e-6 against the gather loop on every geometry
    and against the Pallas kernel wherever rotate_plan takes it."""
    rng = np.random.default_rng(100 + chunk)
    pallas_ran = 0
    for trial in range(6):
        w, h = int(rng.integers(40, 110)), int(rng.integers(40, 110))
        nw, nh = int(rng.integers(30, 100)), int(rng.integers(30, 100))
        tl = (int(rng.integers(-30, w + 30)), int(rng.integers(-30, h + 30)))
        tr = (tl[0] + int(rng.integers(-w, w)), tl[1] + int(rng.integers(-h, h)))
        bl = (tl[0] + int(rng.integers(-w, w)), tl[1] + int(rng.integers(-h, h)))
        data = rng.random((h, w, 3), dtype=np.float32)
        got = _port(data, w, h, tl, tr, bl, nw, nh, 3)
        msg = f"trial {trial} {tl} {tr} {bl} {nw}x{nh}"
        np.testing.assert_allclose(got, _gather(data, w, h, tl, tr, bl, nw, nh, 3),
                                   rtol=0, atol=ATOL, err_msg=msg)
        if rp.rotate_plan(w, h, tl, tr, bl, nw, nh, 3) is not None and pallas_ran < 2:
            pallas_ran += 1
            np.testing.assert_allclose(got, _pallas(data, w, h, tl, tr, bl, nw, nh, 3),
                                       rtol=0, atol=ATOL, err_msg=msg)
    assert pallas_ran >= 1


DEGENERATE = {
    # tests/test_rotate_pallas.py:133-141: geometries rotate_plan refuses.
    "nwidth 1": (100, 100, (0, 0), (99, 10), (-10, 99), 1, 50),
    "nheight 1": (100, 100, (0, 0), (99, 10), (-10, 99), 50, 1),
    "zero x-step": (100, 100, (5, 0), (5, 40), (0, 99), 50, 50),
    "1x1": (40, 30, (3, 2), (3, 2), (3, 2), 1, 1),
    "out-of-bounds corners": (60, 50, (-40, 80), (120, -30), (-90, -20), 40, 30),
}


@pytest.mark.parametrize("case", list(DEGENERATE))
def test_degenerate_geometry_matches_gather_impl(case):
    w, h, tl, tr, bl, nw, nh = DEGENERATE[case]
    data = _data(len(case), h, w, 4)
    got = _port(data, w, h, tl, tr, bl, nw, nh, 4)
    want = _gather(data, w, h, tl, tr, bl, nw, nh, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got == 0, want == 0)


def test_window_beyond_pallas_bound_matches_gather_impl():
    """A 30x downscale rotated: K_y beyond rotate_plan's unroll bound."""
    tl, tr, bl = _corners(30, 900, 900, 24, 24, 30.0)
    assert rp.rotate_plan(900, 900, tl, tr, bl, 24, 24, 4) is None
    data = _data(9, 900, 900, 4)
    np.testing.assert_allclose(_port(data, 900, 900, tl, tr, bl, 24, 24, 4),
                               _gather(data, 900, 900, tl, tr, bl, 24, 24, 4),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["RGGB", "GBGGRGRGRBGBGBGGRGRGRBGBGBGGRGGRGGBG"],
                         ids=["bayer", "xtrans"])
def test_cfa_mode_matches_gather_impl(name):
    """The CFA-aware rotated resample (the CPU's, kept as _transform_impl
    keeps it): one sensor plane in, four colour planes out."""
    w, h, nw, nh = 90, 70, 40, 30
    tl, tr, bl = _corners(17, w, h, nw, nh, 2.1)
    data = _data(3, h, w, 1)
    got = tscaling.transform_buffer_planar(torch.from_numpy(np.moveaxis(data, -1, 0).copy()),
                                           w, h, tl, tr, bl, nw, nh, 4, CFA(name)).numpy()
    want = _gather(data, w, h, tl, tr, bl, nw, nh, 4, JCFA(name))
    np.testing.assert_allclose(np.moveaxis(got, 0, -1), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_transform_buffer_rotated_matches_jax(bits):
    """The interleaved entry with a rotated geometry: the port's plain
    version against the JAX package's public entry (the Pallas kernel in
    interpret mode); integer outputs truncate, so they hold the cross-path
    contract (<= 1, under 2% of values)."""
    from imagepipe_tpu_torch.kernels.develop import compare

    w, h, nw, nh = 80, 64, 70, 56
    tl, tr, bl = _corners(9, w, h, nw, nh)
    dtype = {8: np.uint8, 16: np.uint16, 32: np.float32}[bits]
    rng = np.random.default_rng(bits)
    data = (rng.random((h, w, 3), dtype=np.float32) * (255 if bits == 8 else 65535)).astype(dtype)
    tdt = {8: torch.uint8, 16: torch.uint16, 32: torch.float32}[bits]
    jdt = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.float32}[bits]
    got = tscaling.transform_buffer(torch.from_numpy(data), w, h, tl, tr, bl, nw, nh, 3,
                                    out_dtype=tdt).numpy()
    want = np.asarray(jscaling.transform_buffer(jnp.asarray(data, jnp.float32), w, h, tl, tr,
                                                bl, nw, nh, 3, out_dtype=jdt))
    assert got.shape == want.shape == (nh, nw, 3) and got.dtype == want.dtype
    if bits == 32:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * 65535)
    else:
        maxd, frac = compare(got, want)
        assert maxd <= 1 and frac < 0.02, (maxd, frac)


@pytest.mark.parametrize("theta,w,h,nw,nh,sc,C", CASES[:3], ids=CASE_IDS[:3])
def test_host_tables_equal_rotate_plan(theta, w, h, nw, nh, sc, C):
    """rotated_geometry's row and column terms are rotate_plan's, bit for
    bit (its row table is lane-replicated; its column table orders x before
    y); the skips agree with its params row."""
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    g = tscaling.rotated_geometry(w, h, tl, tr, bl, nw, nh)
    statics, coltab, rowtab, aggtab = rp.rotate_plan(w, h, tl, tr, bl, nw, nh, C, tc_force=128)
    np.testing.assert_array_equal(g.rows, rowtab[:, :nh, 0])
    np.testing.assert_array_equal(g.cols, coltab[[2, 3, 0, 1, 5, 4], :nw])
    assert (g.sxx, g.syy) == (aggtab[0, 2], aggtab[0, 5])
    assert g.rows.dtype == g.cols.dtype == np.float32
    assert g.k_x >= statics["K_x"] and g.k_y >= statics["K_y"]


def test_wrapper_checks_and_routes():
    """The wrapper checks its source, takes the plain version for a CPU
    tensor (no launch counted) and refuses another device; so does the
    CFA route of a CFA-aware rotated resample, which raised before the
    route was ported."""
    w, h, nw, nh = 30, 20, 24, 18
    tl, tr, bl = _corners(10, w, h, nw, nh)
    src = torch.from_numpy(_data(1, 4, h, w))             # [4, h, w]
    before = krot.LAUNCHES
    out = krot.rotate_resample_planar(src, w, h, tl, tr, bl, nw, nh, 4)
    assert out.shape == (4, nh, nw) and krot.LAUNCHES == before
    torch.testing.assert_close(out, krot.rotate_resample_plain(src, w, h, tl, tr, bl, nw, nh, 4),
                               rtol=0, atol=0)
    with pytest.raises(TypeError):
        krot.rotate_resample_planar(src.double(), w, h, tl, tr, bl, nw, nh, 4)
    with pytest.raises(ValueError):
        krot.rotate_resample_planar(src[:3], w, h, tl, tr, bl, nw, nh, 4)
    with pytest.raises(ValueError):
        krot.rotate_resample_planar(src.transpose(1, 2), h, w, tl, tr, bl, nw, nh, 4)
    with pytest.raises(ValueError):
        krot.rotate_resample_planar(torch.zeros((9, h, w)), w, h, tl, tr, bl, nw, nh, 9)
    with pytest.raises(ValueError, match="unsupported device"):
        krot.rotate_resample_planar(src.to("meta"), w, h, tl, tr, bl, nw, nh, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tscaling.transform_buffer_planar(torch.zeros((1, h, w), device="meta"), w, h, tl, tr,
                                         bl, nw, nh, 4, CFA("RGGB"))
    before = krot.CFA_LAUNCHES
    plane = src[:1].contiguous()
    got = tscaling.transform_buffer_planar(plane, w, h, tl, tr, bl, nw, nh, 4, CFA("RGGB"))
    assert got.shape == (4, nh, nw) and krot.CFA_LAUNCHES == before
    torch.testing.assert_close(got, krot.rotate_resample_cfa_plain(
        plane, w, h, tl, tr, bl, nw, nh, CFA("RGGB")), rtol=0, atol=0)


CARD_CASES = {
    "24mp-like small angle": (4, 600, 400, 590, 420, 1.0, 4),
    "45 deg": (45, 300, 300, 424, 424, 1.0, 4),
    "rotate + x2 downscale": (12, 640, 480, 300, 220, 2.0, 4),
    "3 channels": (27, 320, 240, 300, 230, 1.0, 3),
    "nwidth 1": None,
    "zero x-step": None,
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    if CARD_CASES[case] is None:
        w, h, tl, tr, bl, nw, nh = DEGENERATE[case]
        C = 4
    else:
        theta, w, h, nw, nh, sc, C = CARD_CASES[case]
        tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    src = torch.from_numpy(_data(2, C, h, w)).cuda()
    before = krot.LAUNCHES
    got = krot.rotate_resample_planar(src, w, h, tl, tr, bl, nw, nh, C)
    torch.cuda.synchronize()
    assert krot.LAUNCHES == before + 1
    want = krot.rotate_resample_plain(src, w, h, tl, tr, bl, nw, nh, C)
    assert got.shape == want.shape == (C, nh, nw)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got == 0, want == 0)
    assert float((got - want).abs().nan_to_num(0.0).max()) <= krot.MAX_ABS_DIFF
