"""PyTorch port: staged outputs with no pixels.

A staged render whose planned size rounds to 0 in one axis returns the
JAX package's empty image: the same shape ((0, 1, 3) or (2, 0, 3)) and
dtype (uint8 or uint16), for Bayer, X-Trans, mono and linear DNGs, 8-bit
and 16-bit: maxwidth 1 on a 98 x 54 frame, the same with
rotatecrop.crop_top = 0.12 and no cache, and a 24 x 54 frame with the fast
path off at maxwidth 71, maxheight 2. The resampler returns an empty
tensor for an output with no pixels before it picks a route, and the fused
suffix passes a 0-pixel frame through; neither launches a kernel (the
`cuda`-marked test holds that on the card).
"""

import pytest
import torch

from imagepipe_tpu import Pipeline as JPipeline
from imagepipe_tpu import dng as jdng
from imagepipe_tpu import raw as jraw
from imagepipe_tpu.cache import MultiCache as JCache
from imagepipe_tpu_torch import Pipeline as TPipeline
from imagepipe_tpu_torch import scaling as tscaling
from imagepipe_tpu_torch.cache import MultiCache as TCache
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds
from imagepipe_tpu_torch.kernels import rotate as krot
from imagepipe_tpu_torch.kernels import suffix as ksuf
from imagepipe_tpu_torch.raw import CFA

KINDS = ("synthetic_bayer", "synthetic_xtrans", "synthetic_mono", "synthetic_linear")


def _maxwidth_1(pipe):
    pipe.globals.settings.maxwidth = 1


def _crop_top(pipe):
    pipe.ops.rotatecrop.crop_top = 0.12
    pipe.globals.settings.maxwidth = 1


def _no_fastpath(pipe):
    s = pipe.globals.settings
    s.use_fastpath, s.maxwidth, s.maxheight = False, 71, 2


# (frame width, height, settings, with a cache, the expected shape)
SHAPES = {
    "maxwidth-1": (98, 54, _maxwidth_1, True, (0, 1, 3)),
    "crop-top-no-cache": (98, 54, _crop_top, False, (0, 1, 3)),
    "0x2-no-fastpath": (24, 54, _no_fastpath, False, (2, 0, 3)),
}


@pytest.fixture(scope="module")
def dngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("empty")
    paths = {}
    for kind in KINDS:
        for w, h in {(s[0], s[1]) for s in SHAPES.values()}:
            paths[kind, w, h] = str(d / f"{kind}_{w}x{h}.dng")
            jdng.write_dng(paths[kind, w, h], getattr(jraw, kind)(w, h, seed=3))
    return paths


def _render(pipe, cache, bits):
    return (pipe.output_8bit(cache) if bits == 8 else pipe.output_16bit(cache)).data


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_empty_output_matches_jax(dngs, shape, kind, bits):
    w, h, setup, cached, want_shape = SHAPES[shape]
    path = dngs[kind, w, h]
    jpipe = JPipeline.new_from_file(path)
    setup(jpipe)
    want = _render(jpipe, JCache(1 << 28) if cached else None, bits)
    tpipe = TPipeline.new_from_file(path, device="cpu")
    setup(tpipe)
    got = _render(tpipe, TCache(1 << 28) if cached else None, bits)
    assert want.shape == want_shape
    assert (got.shape, got.dtype) == (want.shape, want.dtype)


@pytest.mark.parametrize("cfa,rotated", [(None, False), ("RGGB", False), (None, True),
                                         ("RGGB", True)])
def test_resample_to_no_pixels_is_empty(cfa, rotated):
    """Aligned or rotated, per channel or CFA-aware: an output with no
    pixels is an empty float32 [C', nh, nw] tensor on the source's device."""
    src = torch.rand((1 if cfa else 3, 20, 30))
    tr = (29, 3) if rotated else (29, 0)
    for nw, nh in ((0, 5), (7, 0), (1, 0), (0, 0)):
        out = tscaling.transform_buffer_planar(src, 30, 20, (0, 0), tr, (0, 19), nw, nh, 3,
                                               CFA(cfa) if cfa else None)
        assert out.shape == (4 if cfa else 3, nh, nw) and out.dtype == torch.float32
        assert out.device == src.device


@pytest.mark.parametrize("quant", [None, 8, 16])
def test_suffix_passes_an_empty_frame(quant):
    """A 0-pixel frame through a whole segment: empty outputs of every kept
    stage and an empty quantized output, transposed as the frame is."""
    data = torch.empty((4, 0, 1), dtype=torch.float32)
    stages = ("to_lab", "from_lab", "gamma", "transform")
    params = (((1.0, 1.0, 1.0, 0.0), [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]]),
              ([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]],), (), (True, False, True))
    outs, q = ksuf.run_suffix(data, stages, params, quant)
    assert [tuple(o.shape) for o in outs] == [(3, 0, 1)] * 3 + [(3, 1, 0)]
    if quant is None:
        assert q is None
    else:
        assert q.shape == (3, 1, 0) and q.dtype == (torch.uint8 if quant == 8 else torch.uint16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["synthetic_bayer", "synthetic_linear"])
def test_empty_output_on_card_launches_nothing(dngs, kind):
    """The 98 x 54 staged render at maxwidth 1 on the card: (0, 1, 3), and no
    kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the staged path on the card")
    counters = lambda: (kdev.LAUNCHES, kds.LAUNCHES, krot.LAUNCHES,  # noqa: E731
                        krot.CFA_LAUNCHES, ksuf.LAUNCHES)
    before = counters()
    pipe = TPipeline.new_from_file(dngs[kind, 98, 54], device="cuda")
    _maxwidth_1(pipe)
    got = pipe.output_8bit(TCache(1 << 28)).data
    assert got.shape == (0, 1, 3)
    assert counters() == before
