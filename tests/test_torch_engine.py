"""PyTorch port: the eager develop engine against the JAX package's.

`imagepipe_tpu.engine.develop_fused` and `imagepipe_tpu_torch.engine.
develop_fused` develop the same sensor plane; the port's plan comes from
`plan_from_jax` on the JAX plan, so both run the same statics and params.
Contract: max |diff| <= 1 LSB and under 2% of values differing. Against
the jitted JAX engine 8-bit 'lut' output is not bit-equal: one or two
values in ~56k differ by 1 LSB, because XLA's fusion rounds some
intermediates differently. Run op by op (jax.disable_jit), the JAX engine
is bit-equal to the port, and a test pins that.
"""

import jax
import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource, Pipeline
from imagepipe_tpu import color as jcc
from imagepipe_tpu.engine import _develop_one, develop_fused, make_develop_plan
from imagepipe_tpu.raw import (Orientation, synthetic_bayer, synthetic_linear,
                               synthetic_mono, synthetic_xtrans)
from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch import profiling
from imagepipe_tpu_torch.kernels.develop import (MAX_FLIP_FRACTION, MAX_LSB,
                                                 compare)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KINDS = {"bayer": synthetic_bayer, "xtrans": synthetic_xtrans,
         "mono": synthetic_mono, "rgb": synthetic_linear}


def _both(raw, bits, numerics):
    """(JAX output, port output) as numpy [3, H', W'] for one RawImage."""
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.linear = bits == 16
    plan = make_develop_plan(p, out_bits=bits, numerics=numerics)
    want = np.asarray(develop_fused(plan, raw.data))
    tplan = tengine.plan_from_jax(plan, "cpu")
    assert tplan.numerics == numerics and tplan.mode == plan.mode
    got = tengine.develop_fused(tplan, torch.from_numpy(np.ascontiguousarray(raw.data)))
    return want, got.numpy()


def _assert_contract(want, got):
    maxd, frac = compare(got, want)
    assert maxd <= MAX_LSB and frac < MAX_FLIP_FRACTION, (maxd, frac)


@pytest.mark.parametrize("numerics", ["lut", "direct"])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("kind", list(KINDS))
def test_develop_fused_matches_jax(kind, bits, numerics):
    want, got = _both(KINDS[kind](168, 112), bits, numerics)
    _assert_contract(want, got)


@pytest.mark.parametrize("kind", ["bayer", "xtrans"])
def test_develop_fused_with_crops(kind):
    raw = KINDS[kind](150, 104)
    raw.crops = (3, 5, 7, 11)   # odd origin: the CFA is re-anchored
    want, got = _both(raw, 8, "direct")
    assert got.shape == (3, 104 - 10, 150 - 16)
    _assert_contract(want, got)


@pytest.mark.parametrize("orient", [o.value for o in Orientation if o is not Orientation.Unknown])
def test_develop_fused_orientations(orient):
    raw = synthetic_bayer(168, 112)
    raw.orientation = Orientation(orient)
    want, got = _both(raw, 8, "lut")
    _assert_contract(want, got)


@pytest.mark.parametrize("kind", ["bayer", "xtrans"])
def test_lut_8bit_bit_equal_to_unfused_jax(kind):
    raw = KINDS[kind](96, 64)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    plan = make_develop_plan(p, out_bits=8, numerics="lut")
    with jax.disable_jit(), jcc.numerics_mode("lut"):
        want = np.asarray(_develop_one(raw.data, plan.params, **plan.statics()))
    got = tengine.develop_fused(tengine.plan_from_jax(plan, "cpu"),
                                torch.from_numpy(raw.data))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plan_from_jax_carries_params():
    raw = synthetic_xtrans(174, 114)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.ops.basecurve.points = [(0.25, 0.2), (0.5, 0.6), (0.75, 0.85)]
    plan = make_develop_plan(p, out_bits=8, numerics="direct")
    tplan = tengine.plan_from_jax(plan, "cpu")
    for k, v in plan.params.items():
        np.testing.assert_array_equal(tplan.params[k].numpy(), np.asarray(v))
    for k in ("cfa_name", "height", "width", "crop_x", "crop_y", "mode",
              "out_bits", "linear", "apply_curve", "n_knots", "dem_path"):
        assert getattr(tplan, k) == getattr(plan, k), k
    assert tplan.orientation_flips == tuple(plan.orientation_flips)


def test_resize_paths_not_ported():
    """Every resize path is ported now. The thumbnail paths develop
    (tests/test_torch_scaled.py holds them to the JAX package), and the
    rotated resample behind rotatecrop, which raised ROADMAP A9 until it
    was ported, agrees with the JAX package's public entry
    (tests/test_torch_rotate.py holds it in detail)."""
    from imagepipe_tpu_torch.scaling import transform_buffer

    raw = synthetic_bayer(168, 112)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.maxwidth = 40
    plan = make_develop_plan(p, out_bits=8, numerics="direct")
    assert plan.dem_path == "scaled"
    tplan = tengine.plan_from_jax(plan, "cpu")
    got = tengine.develop_fused(tplan, torch.from_numpy(raw.data))
    _assert_contract(np.asarray(develop_fused(plan, raw.data)), got.numpy())
    from imagepipe_tpu.scaling import transform_buffer as jax_transform_buffer

    src = np.random.default_rng(0).random((112, 168, 3), dtype=np.float32)
    got = transform_buffer(torch.from_numpy(src), 168, 112, (5, 2), (160, 12), (-3, 100),
                           40, 26, 3)
    want = jax_transform_buffer(src, 168, 112, (5, 2), (160, 12), (-3, 100), 40, 26, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def _recorded_counters(fn):
    """(fn's result, the recorder's counters) with a profiler recording."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        got = fn()
        counters = profiling.counters()
    return got, counters


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("bits", [8, 16])
def test_planar_to_hwc_on_cpu_is_a_view_of_the_output(bits, transposed):
    """On the CPU the result is what `.cpu()` gave: a writeable [H, W, 3]
    view of the output's own memory, in its layout, and no pinned count."""
    dtype = np.uint8 if bits == 8 else np.uint16
    planes = np.random.default_rng(bits).integers(0, 1 << bits, (3, 5, 7), dtype=dtype)
    out = torch.from_numpy(planes)
    if transposed:
        out = out.transpose(-1, -2)
    got, counters = _recorded_counters(lambda: tengine.planar_to_hwc(out))
    want = np.moveaxis(out.numpy(), -3, -1)
    assert got.shape == want.shape == ((7, 5, 3) if transposed else (5, 7, 3))
    assert got.dtype == dtype and got.strides == want.strides
    np.testing.assert_array_equal(got, want)
    assert got.flags.writeable and np.shares_memory(got, planes)
    assert "output.pinned" not in counters and "output.pinned_grew" not in counters


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned output copy runs only from CUDA memory")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("bits", [8, 16])
def test_planar_to_hwc_on_card_equals_cpu_copy(bits, transposed):
    """On the card the result equals `out.cpu()` bit for bit, in the same
    layout, and is a view of a pinned block of its own."""
    dev = _card()
    dtype = np.uint8 if bits == 8 else np.uint16
    planes = np.random.default_rng(bits).integers(0, 1 << bits, (3, 48, 64), dtype=dtype)
    out = torch.from_numpy(planes).to(dev)
    if transposed:
        out = out.transpose(-1, -2)
    got = tengine.planar_to_hwc(out)
    want = np.moveaxis(out.cpu().numpy(), -3, -1)
    assert got.dtype == want.dtype and got.shape == want.shape and got.strides == want.strides
    np.testing.assert_array_equal(got, want)
    assert got.flags.writeable and got.base.base.is_pinned()
    assert not np.shares_memory(got, tengine.planar_to_hwc(out))


def _card_renders(dev, path, bits):
    """A render function of a tiny frame on the card through `path`: the
    fused `Pipeline.output_*bit(None)` or the staged `RenderService.edit`;
    each call moves the exposure."""
    from imagepipe_tpu_torch import ImageSource as TSource
    from imagepipe_tpu_torch import Pipeline as TPipeline
    from imagepipe_tpu_torch import raw as traw
    from imagepipe_tpu_torch.service import RenderService

    source = TSource.from_raw(traw.synthetic_bayer(96, 64, seed=5))
    exposures = iter(np.linspace(-1.0, 1.0, 64))
    if path == "fused":
        pipe = TPipeline.new_from_source(source, dev)

        def render():
            pipe.ops.basecurve.exposure = float(next(exposures))
            return (pipe.output_8bit(None) if bits == 8 else pipe.output_16bit(None)).data
    else:
        svc = RenderService(cache_bytes=64 << 20, device=dev)
        svc.open_source("f", source)

        def render():
            return svc.edit("f", {"basecurve": {"exposure": float(next(exposures))}},
                            bits=bits).data
    return render


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("path", ["fused", "staged"])
def test_card_renders_keep_separate_pinned_results(path, bits):
    """Back-to-back renders give results that share no memory, and a kept
    result holds its values while three more renders run."""
    render = _card_renders(_card(), path, bits)
    first, second = render(), render()
    assert not np.shares_memory(first, second)
    assert not np.array_equal(first, second)
    kept = first.copy()
    later = [render() for _ in range(3)]
    np.testing.assert_array_equal(first, kept)
    assert not any(np.shares_memory(first, r) for r in later + [second])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "staged"])
def test_card_renders_count_pinned_and_stop_growing(path):
    """While a profiler records, every render counts `output.pinned`; once
    the pool holds the blocks of what is kept, `output.pinned_grew` stops."""
    render = _card_renders(_card(), path, 8)
    kept = [render()]

    def renders():
        counts = []
        for i in range(8):
            kept.append(render())
            if len(kept) > 2:
                kept.pop(0)
            counts.append(profiling.counters())
        return counts

    counts, _ = _recorded_counters(renders)
    assert [c.get("output.pinned", 0) for c in counts] == list(range(1, 9))
    grew = [c.get("output.pinned_grew", 0) for c in counts]
    assert grew[2:] == [grew[2]] * 6, grew
