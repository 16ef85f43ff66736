"""PyTorch port: the develop kernels' `stage_limit` cuts, against the JAX
package's.

`stage_limit` is the profiling knob of the JAX package's develop kernels
(`_finish_tile`, reached through `_develop_pallas_jit(stage_limit=)` and
`develop_scaled(stage_limit=)`): the back end stops after the demosaic (1:
RGBE's first three planes), after WB + matrix + Lab (2: L, A, B) or after
the tone spline (3), and what it has is quantized without gamma; 4 is the
whole chain. The port's plain versions `develop_plain(plan, plane, k)` and
`develop_scaled_plain(plan, plane, k)` (`engine.finish_planes`) are held
here to those Pallas kernels in interpret mode, as tests/test_pallas.py
and tests/test_scaled.py run them: Bayer, X-Trans and mono, 8-bit and
16-bit linear, small frames; the scaled kernel single-pass (-> 96 wide)
and chunked (600x400 -> 36 wide, windows of 19-20; cut 4 there is
tests/test_torch_scaled.py's). k = 4 equals the default, and any other
value raises. On a CPU tensor the wrappers are the plain versions and
count no launch. On the card (`cuda` marker) each kernel's cuts against
their plain versions, one CUT_LAUNCHES launch each.

Contract: max |diff| <= 1 LSB and under 2% of values differing
(kernels/develop.py MAX_LSB, MAX_FLIP_FRACTION).
"""

import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource, Pipeline
from imagepipe_tpu.engine import make_develop_plan
from imagepipe_tpu.kernels import develop_pallas as jdp
from imagepipe_tpu.kernels import develop_scaled as jds
from imagepipe_tpu.raw import Orientation, synthetic_bayer, synthetic_mono, synthetic_xtrans
from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CUTS = (1, 2, 3, 4)
FULL = {"bayer": synthetic_bayer, "xtrans": synthetic_xtrans, "mono": synthetic_mono}
# (kind, maxwidth, frame) of the scaled kernel's cases.
SCALED = {"bayer-96": ("bayer", 96, (480, 320)), "xtrans-96": ("xtrans", 96, (480, 320)),
          "bayer-36-chunked": ("bayer", 36, (600, 400))}
SCALED_CASES = [(c, b, k) for c in SCALED for b in (8, 16) for k in CUTS
                if not (c.endswith("chunked") and (b == 16 or k == 4))]


def _jax_plan(raw, bits, maxwidth=0):
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.linear = bits == 16
    p.globals.settings.maxwidth = maxwidth
    return make_develop_plan(p, out_bits=bits, numerics="direct")


def _plane(raw):
    return torch.from_numpy(np.ascontiguousarray(raw.data))


def _assert_contract(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    maxd, frac = kdev.compare(got, want)
    assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)


def _pallas_full(plan, raw, k):
    """The JAX develop kernel in interpret mode, cut at k: the body of
    `develop_pallas` with `stage_limit` passed to `_develop_pallas_jit`."""
    plane = jdp.stage_plane_pallas(plan, raw.data)
    cmap, scal, spline, statics = jdp.plan_tables_device(plan)
    return np.asarray(jdp._develop_pallas_jit(plane, cmap, scal, spline, interpret=True,
                                              stage_limit=k, **statics))


@pytest.mark.parametrize("k", CUTS)
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("kind", list(FULL))
def test_develop_plain_cut_matches_pallas_interpret(kind, bits, k):
    raw = FULL[kind](168, 112, seed=4)
    raw.orientation = Orientation.Rotate90 if bits == 16 else Orientation.Normal
    plan = _jax_plan(raw, bits)
    want = _pallas_full(plan, raw, k)
    tplan = tengine.plan_from_jax(plan, "cpu")
    got = kdev.develop_plain(tplan, _plane(raw), k)
    _assert_contract(got, want)
    # On a CPU tensor the wrapper is the plain version and counts nothing.
    before = kdev.LAUNCHES, dict(kdev.CUT_LAUNCHES)
    assert torch.equal(kdev.develop(tplan, _plane(raw), stage_limit=k), got)
    assert (kdev.LAUNCHES, kdev.CUT_LAUNCHES) == before


@pytest.mark.parametrize("case,bits,k", SCALED_CASES,
                         ids=[f"{c}-{b}-bit-cut{k}" for c, b, k in SCALED_CASES])
def test_develop_scaled_plain_cut_matches_pallas_interpret(case, bits, k):
    kind, maxwidth, (width, height) = SCALED[case]
    raw = FULL[kind](width, height, seed=6)
    plan = _jax_plan(raw, bits, maxwidth)
    sp = jds.scaled_plan_for(plan)
    assert sp is not None and bool(sp.statics.get("chunked")) == case.endswith("chunked")
    want = np.asarray(jds.develop_scaled(plan, raw.data, interpret=True, stage_limit=k))
    tplan = tengine.plan_from_jax(plan, "cpu")
    got = kds.develop_scaled_plain(tplan, _plane(raw), k)
    _assert_contract(got, want)
    before = kds.LAUNCHES, dict(kds.CUT_LAUNCHES)
    assert torch.equal(kds.develop_scaled(tplan, _plane(raw), stage_limit=k), got)
    assert (kds.LAUNCHES, kds.CUT_LAUNCHES) == before


def test_cuts_differ_and_full_is_the_default():
    """Each cut computes its own function, and 4 is the default's output,
    for both wrappers and the eager engine."""
    raw = synthetic_bayer(96, 64, seed=2)
    for maxwidth, fn in ((0, kdev.develop), (24, kds.develop_scaled)):
        plan = tengine.plan_from_jax(_jax_plan(raw, 8, maxwidth), "cpu")
        outs = [fn(plan, _plane(raw), stage_limit=k) for k in CUTS]
        assert torch.equal(outs[3], fn(plan, _plane(raw)))
        assert torch.equal(outs[3], tengine.develop_fused(plan, _plane(raw)))
        for i in range(len(outs)):
            for j in range(i):
                assert not torch.equal(outs[i], outs[j]), (maxwidth, i, j)


def test_cut_one_is_the_demosaic():
    """Cut 1 quantizes the levels-and-demosaic planes themselves: on a mono
    frame every plane is the levelled sample."""
    raw = synthetic_mono(64, 48, seed=3)
    plan = tengine.plan_from_jax(_jax_plan(raw, 16), "cpu")
    got = kdev.develop_plain(plan, _plane(raw), 1)
    assert torch.equal(got[0], got[1]) and torch.equal(got[1], got[2])
    p = plan.params
    v = (_plane(raw).float() - p["mins"][0]) / p["ranges"][0]
    want = torch.round(torch.clamp(torch.clamp(v, max=1.0) * 65535.0, 0.0, 65535.0))
    assert (got[0].int() - want.int()).abs().max() <= 1


@pytest.mark.parametrize("bad", [0, 5, -1, True, 2.5, "2", None])
def test_bad_stage_limit_raises(bad):
    raw = synthetic_bayer(48, 32, seed=1)
    full = tengine.plan_from_jax(_jax_plan(raw, 8), "cpu")
    scaled = tengine.plan_from_jax(_jax_plan(raw, 8, 8), "cpu")
    calls = [lambda: kdev.develop(full, _plane(raw), stage_limit=bad),
             lambda: kdev.develop_plain(full, _plane(raw), bad),
             lambda: kds.develop_scaled(scaled, _plane(raw), stage_limit=bad),
             lambda: kds.develop_scaled_plain(scaled, _plane(raw), bad),
             lambda: tengine.check_stage_limit(bad)]
    for call in calls:
        with pytest.raises(ValueError, match="stage_limit"):
            call()


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the develop kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", CUTS)
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("kind", list(FULL))
def test_develop_kernel_cut_matches_plain_on_card(card, kind, bits, k):
    raw = FULL[kind](168, 112, seed=4)
    raw.orientation = Orientation.Rotate90 if bits == 16 else Orientation.Normal
    plan = tengine.plan_from_jax(_jax_plan(raw, bits), card)
    plane = _plane(raw).to(card)
    before = kdev.LAUNCHES, dict(kdev.CUT_LAUNCHES)
    got = kdev.develop(plan, plane, stage_limit=k)
    want = dict(before[1])
    if k == 4:
        assert kdev.LAUNCHES == before[0] + 1
    else:
        want[k] += 1
        assert kdev.LAUNCHES == before[0]
    assert kdev.CUT_LAUNCHES == want
    _assert_contract(got.cpu(), kdev.develop_plain(plan, plane, k).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case,bits,k", SCALED_CASES,
                         ids=[f"{c}-{b}-bit-cut{k}" for c, b, k in SCALED_CASES])
def test_develop_scaled_kernel_cut_matches_plain_on_card(card, case, bits, k):
    kind, maxwidth, (width, height) = SCALED[case]
    raw = FULL[kind](width, height, seed=6)
    plan = tengine.plan_from_jax(_jax_plan(raw, bits, maxwidth), card)
    plane = _plane(raw).to(card)
    before = kds.LAUNCHES, dict(kds.CUT_LAUNCHES)
    got = kds.develop_scaled(plan, plane, stage_limit=k)
    want = dict(before[1])
    if k == 4:
        assert kds.LAUNCHES == before[0] + 1
    else:
        want[k] += 1
        assert kds.LAUNCHES == before[0]
    assert kds.CUT_LAUNCHES == want
    _assert_contract(got.cpu(), kds.develop_scaled_plain(plan, plane, k).cpu().numpy())
