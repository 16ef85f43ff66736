"""PyTorch port: the CFA-aware rotated resample (kernels/rotate.py
`rotate_resample_cfa`, csrc/rotate.cu's CFA route) against the JAX package.

The route's plain version, `rotate_resample_cfa_plain` (`scaling.
_transform_rotated` with the CFA; what the wrapper runs for a CPU tensor),
resamples the same seeded sensor planes as the CFA mode of the JAX gather
loop `scaling._transform_impl`, jitted: max |diff| <= 2e-6 (atol, rtol 0),
with the same NaN and zero pattern, as tests/test_torch_rotate.py holds
the per-channel form. XLA's CPU fusion rounds some intermediates
differently; run op by op (`jax.disable_jit`) the two are bit-equal. Cases:
RGGB and X-Trans rotated, a x2 rotated downscale, the outputs 1 wide and 1
high (the staged scaled demosaic's case: every weight NaN, all zeros), and
sources with NaN and +-Inf, which reach the sums even from invalid samples
at clamped indices.

The slice as a whole: a staged scaled demosaic to an output 1 pixel wide
through the port's Pipeline goes through `rotate_resample_cfa` and agrees
with the JAX package's Pipeline within the cross-path contract.

The kernel is held bit-equal to the plain version on the card by the
`cuda`-marked tests below and by chip_smoke.py (phase 1c).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource as JSource
from imagepipe_tpu import Pipeline as JPipeline
from imagepipe_tpu import raw as jraw
from imagepipe_tpu import scaling as jscaling
from imagepipe_tpu.cache import MultiCache as JCache
from imagepipe_tpu.raw import CFA as JCFA
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch import scaling as tscaling
from imagepipe_tpu_torch.cache import MultiCache
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import rotate as krot
from imagepipe_tpu_torch.raw import CFA
from imagepipe_tpu_torch.sources import ImageSource

torch.set_num_threads(1)

ATOL = 2e-6
XTRANS = "GBGGRGRGRBGBGBGGRGRGRBGBGBGGRGGRGGBG"


def _corners(theta_deg, w, h, nw, nh, scale=1.0):
    """Inverse-mapped corner triple, as tests/test_rotate_pallas.py."""
    a = np.deg2rad(theta_deg)
    s, c = np.sin(a), np.cos(a)

    def rot(x, y):
        tx, ty = x - nw / 2, y - nh / 2
        return (int(np.float32((tx * c + ty * s) * scale + w / 2)),
                int(np.float32((-tx * s + ty * c) * scale + h / 2)))

    return rot(0, 0), rot(nw - 1, 0), rot(0, nh - 1)


# (cfa, width, height, topleft, topright, bottomleft, nwidth, nheight)
CASES = {
    "rggb rotated": ("RGGB", 90, 70, *_corners(17, 90, 70, 84, 64), 84, 64),
    "x-trans rotated": (XTRANS, 96, 72, *_corners(-8, 96, 72, 90, 66), 90, 66),
    "rggb x2 rotated downscale": ("RGGB", 120, 100, *_corners(11, 120, 100, 56, 46, 2.0),
                                  56, 46),
    "x-trans 45 deg": (XTRANS, 80, 80, *_corners(45, 80, 80, 112, 112), 112, 112),
    "output 1 wide": ("RGGB", 60, 90, (0, 0), (59, 0), (0, 89), 1, 30),
    "output 1 high": (XTRANS, 90, 60, (0, 0), (89, 0), (0, 59), 30, 1),
    "output 1 wide, rotated": ("RGGB", 100, 100, (0, 0), (99, 10), (-10, 99), 1, 50),
}


def _plane(seed, h, w, nonfinite=False):
    data = np.random.default_rng(seed).random((h, w), dtype=np.float32)
    if nonfinite:
        rng = np.random.default_rng(seed + 1)
        for value in (np.nan, np.inf, -np.inf):
            data[rng.integers(0, h, 12), rng.integers(0, w, 12)] = value
    return data


def _gather(data, case):
    name, w, h, tl, tr, bl, nw, nh = case
    return np.asarray(jscaling._transform_impl(
        jnp.asarray(data[..., None]), jnp.asarray(JCFA(name).pattern_tile(), jnp.uint8),
        width=w, height=h, topleft=tl, topright=tr, bottomleft=bl, nwidth=nw, nheight=nh,
        components=4, cfa_key=name, out_dtype=jnp.float32))


def _plain(data, case):
    name, w, h, tl, tr, bl, nw, nh = case
    out = krot.rotate_resample_cfa_plain(torch.from_numpy(data)[None], w, h, tl, tr, bl, nw,
                                         nh, CFA(name))
    return np.moveaxis(out.numpy(), 0, -1)


@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nan-inf"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_gather_impl(case, nonfinite):
    c = CASES[case]
    data = _plane(len(case), c[2], c[1], nonfinite)
    got, want = _plain(data, c), _gather(data, c)
    assert got.shape == want.shape == (c[7], c[6], 4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if case.startswith("output 1"):
        assert not got.any()                        # every weight NaN: zeros
    if nonfinite and not case.startswith("output 1"):
        assert np.isnan(got).any()


def test_plain_bit_equal_to_unjitted_gather_impl():
    c = CASES["x-trans rotated"]
    data = _plane(5, c[2], c[1], nonfinite=True)
    with jax.disable_jit():
        want = _gather(data, c)
    np.testing.assert_array_equal(_plain(data, c), want)


def test_invalid_samples_reach_the_sums():
    """A NaN read only at a clamped index (outside every window) still
    makes its colour's sum NaN, as in the JAX package: the route has no
    shorter walk. Here the last source column holds NaN and the windows of
    the right-most outputs are clamped onto it."""
    c = ("RGGB", 40, 30, (20, 0), (39, 0), (20, 29), 10, 15)
    data = _plane(3, 30, 40)
    data[:, -1] = np.nan
    got, want = _plain(data, c), _gather(data, c)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()


def test_wrapper_routes_and_refusals():
    """The wrapper takes the plain version for a CPU tensor (no launch
    counted) and refuses what the kernel does not take: another device,
    dtype, a source that is not one contiguous plane, an invalid CFA, an
    empty output."""
    name, w, h, tl, tr, bl, nw, nh = CASES["rggb rotated"]
    src = torch.from_numpy(_plane(1, h, w))[None]
    before = krot.CFA_LAUNCHES
    got = krot.rotate_resample_cfa(src, w, h, tl, tr, bl, nw, nh, CFA(name))
    assert got.shape == (4, nh, nw) and krot.CFA_LAUNCHES == before
    torch.testing.assert_close(got, krot.rotate_resample_cfa_plain(
        src, w, h, tl, tr, bl, nw, nh, CFA(name)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        krot.rotate_resample_cfa(src.to("meta"), w, h, tl, tr, bl, nw, nh, CFA(name))
    with pytest.raises(TypeError):
        krot.rotate_resample_cfa(src.double(), w, h, tl, tr, bl, nw, nh, CFA(name))
    with pytest.raises(ValueError):
        krot.rotate_resample_cfa(src.expand(2, h, w).contiguous(), w, h, tl, tr, bl, nw, nh,
                                 CFA(name))
    with pytest.raises(ValueError):
        krot.rotate_resample_cfa(src.transpose(1, 2), h, w, tl, tr, bl, nw, nh, CFA(name))
    with pytest.raises(ValueError, match="invalid CFA"):
        krot.rotate_resample_cfa(src, w, h, tl, tr, bl, nw, nh, CFA(""))
    with pytest.raises(ValueError):
        krot.rotate_resample_cfa(src, w, h, tl, tr, bl, 0, nh, CFA(name))


@pytest.mark.parametrize("interleaved", [False, True])
def test_transform_buffer_routes_cfa_to_the_wrapper(monkeypatch, interleaved):
    """A rotated geometry with a CFA goes through `rotate_resample_cfa`,
    from the planar and the interleaved entry; an axis-aligned one stays on
    the eager aligned resampler."""
    name, w, h, tl, tr, bl, nw, nh = CASES["x-trans rotated"]
    calls = []
    real = krot.rotate_resample_cfa
    monkeypatch.setattr(krot, "rotate_resample_cfa",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    data = _plane(2, h, w)
    if interleaved:
        got = tscaling.transform_buffer(torch.from_numpy(data)[..., None], w, h, tl, tr, bl,
                                        nw, nh, 4, cfa=CFA(name)).numpy()
    else:
        got = np.moveaxis(tscaling.transform_buffer_planar(
            torch.from_numpy(data)[None], w, h, tl, tr, bl, nw, nh, 4, CFA(name)).numpy(), 0, -1)
    assert calls == [(1, h, w)]
    np.testing.assert_array_equal(got, _plain(data, CASES["x-trans rotated"]))
    tscaling.transform_buffer_planar(torch.from_numpy(data)[None], w, h, (0, 0), (w - 1, 0),
                                     (0, h - 1), w // 3, h // 3, 4, CFA(name))
    assert len(calls) == 1


def test_staged_scaled_demosaic_to_one_pixel_wide(monkeypatch):
    """The slice's path: a staged render of a tall frame to maxwidth 1 runs
    the scaled demosaic to a 1-pixel-wide stage, the CFA-aware rotated
    resample, and agrees with the JAX package's staged render."""
    calls = []
    real = krot.rotate_resample_cfa
    monkeypatch.setattr(krot, "rotate_resample_cfa",
                        lambda *a, **k: calls.append(a[6:8]) or real(*a, **k))
    w, h = 40, 600
    p = tip.Pipeline.new_from_source(ImageSource.from_raw(traw.synthetic_bayer(w, h, seed=4)),
                                     device="cpu")
    p.globals.settings.maxwidth = 1
    got = p.output_8bit(MultiCache(64 << 20)).data
    assert calls == [(1, 15)] and got.shape == (15, 1, 3)
    j = JPipeline.new_from_source(JSource.from_raw(jraw.synthetic_bayer(w, h, seed=4)))
    j.globals.settings.maxwidth = 1
    want = np.asarray(j.output_8bit(JCache(64 << 20)).data)
    maxd, frac = kdev.compare(got, want)
    assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)


CARD_CASES = ["x-trans rotated", "rggb x2 rotated downscale", "output 1 wide, rotated"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_bit_equal_to_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    name, w, h, tl, tr, bl, nw, nh = CASES[case]
    src = torch.from_numpy(_plane(7, h, w, nonfinite=True))[None].cuda()
    before = krot.CFA_LAUNCHES
    got = krot.rotate_resample_cfa(src, w, h, tl, tr, bl, nw, nh, CFA(name))
    torch.cuda.synchronize()
    assert krot.CFA_LAUNCHES == before + 1
    want = krot.rotate_resample_cfa_plain(src, w, h, tl, tr, bl, nw, nh, CFA(name))
    assert got.shape == want.shape == (4, nh, nw)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                       want.masked_fill(nan, 0).view(torch.int32))
