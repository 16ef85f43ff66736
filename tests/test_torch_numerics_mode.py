"""PyTorch port: the numerics-mode override against the JAX package's.

`color.set_numerics_mode`, `get_numerics_mode` and `numerics_mode` set a
process-wide choice between 'lut' and 'direct' numerics for the staged
ops (gofloat's raster ingest, to_lab, gamma) and the fused segments, as in
the JAX package. The port's unset mode resolves per device ('lut' on the
CPU, 'direct' on CUDA), so its context manager restores "unset" where the
JAX one restores the resolved mode; the fused develop plan and the batch
engine resolve by device alone, as the JAX plans resolve by backend.

A staged render of the same DNG (the JAX package's staged path, not its
fused engine: ROADMAP C, its 16-bit miss) under the same override in both
packages: max |diff| <= 1 LSB on under 2% of values (kernels/develop.py
MAX_LSB, MAX_FLIP_FRACTION). A segment fuses on the CPU and on CUDA in
either mode, the suffix kernel on CUDA computing the one the ops resolve:
the routing is a function (`kernels/suffix.fuses`) tested here without a
card, and on the card by the `cuda` case.
"""

import numpy as np
import pytest
import torch

import imagepipe_tpu as jip
from imagepipe_tpu import color as jcc
from imagepipe_tpu.dng import write_dng
from imagepipe_tpu.engine import make_develop_plan as jax_make_develop_plan
from imagepipe_tpu.raw import Orientation, synthetic_bayer
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import color as tcc
from imagepipe_tpu_torch import pipeline as ppl
from imagepipe_tpu_torch.cache import MultiCache
from imagepipe_tpu_torch.engine import make_develop_plan
from imagepipe_tpu_torch.kernels import suffix as ksuffix
from imagepipe_tpu_torch.kernels.develop import MAX_FLIP_FRACTION, MAX_LSB, compare
from imagepipe_tpu_torch.parallel import BatchEngine

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODES = ("lut", "direct")


@pytest.fixture(autouse=True)
def restore_modes():
    """Every test leaves both packages' numerics mode as it found it: the
    tests of other files in this worker must not see an override."""
    saved = tcc._NUMERICS_MODE, jcc._NUMERICS_MODE
    yield
    tcc._NUMERICS_MODE, jcc._NUMERICS_MODE = saved


@pytest.fixture(scope="module")
def dng_path(tmp_path_factory):
    raw = synthetic_bayer(168, 112, seed=12)
    raw.orientation = Orientation.Rotate90
    path = str(tmp_path_factory.mktemp("numerics") / "frame.dng")
    write_dng(path, raw)
    return path


def _assert_contract(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    maxd, frac = compare(got, want)
    assert maxd <= MAX_LSB and frac < MAX_FLIP_FRACTION, (maxd, frac)


def _staged(pipeline, bits, exposure=0.0, rotation=0.0):
    """A staged render (fast path off, so RAW sources do not develop in one
    pass) to host pixels."""
    pipeline.globals.settings.use_fastpath = False
    pipeline.globals.settings.linear = bits == 16
    pipeline.ops.basecurve.exposure = exposure
    pipeline.ops.rotatecrop.rotation = rotation
    out = pipeline.output_8bit(None) if bits == 8 else pipeline.output_16bit(None)
    return np.asarray(out.data)


def test_unset_mode_resolves_per_device():
    tcc._NUMERICS_MODE = None
    assert tcc.get_numerics_mode("cpu") == "lut"
    assert tcc.get_numerics_mode("cuda") == "direct"
    # No device: the default backend's, as in the JAX package.
    assert tcc.get_numerics_mode() == ("direct" if torch.cuda.is_available() else "lut")
    assert tcc.resolve_numerics("auto", "cpu") == "lut"
    assert tcc.resolve_numerics("auto", "cuda") == "direct"


@pytest.mark.parametrize("mode", MODES)
def test_set_and_get_as_in_jax(mode):
    tcc.set_numerics_mode(mode)
    jcc.set_numerics_mode(mode)
    assert tcc.get_numerics_mode() == jcc.get_numerics_mode() == mode
    for device in ("cpu", "cuda"):
        assert tcc.get_numerics_mode(device) == mode
        assert tcc.resolve_numerics("auto", device) == mode
        assert tcc.device_numerics("auto", device) == (
            "lut" if device == "cpu" else "direct")
    # An explicit mode is never overridden.
    other = MODES[1 - MODES.index(mode)]
    assert tcc.resolve_numerics(other, "cpu") == other


@pytest.mark.parametrize("cc", [tcc, jcc], ids=["port", "jax"])
def test_unknown_mode_raises(cc):
    with pytest.raises(ValueError):
        cc.set_numerics_mode("fast")
    with pytest.raises(ValueError):
        with cc.numerics_mode("auto"):
            pass


@pytest.mark.parametrize("mode", MODES)
def test_context_manager_restores_unset(mode):
    tcc._NUMERICS_MODE = None
    with tcc.numerics_mode(mode) as ctx:
        assert isinstance(ctx, tcc.numerics_mode)
        assert tcc.get_numerics_mode("cpu") == tcc.get_numerics_mode("cuda") == mode
    assert tcc._NUMERICS_MODE is None
    assert tcc.resolve_numerics("auto", "cpu") == "lut"
    assert tcc.resolve_numerics("auto", "cuda") == "direct"


def test_context_manager_nests_and_restores_on_error():
    tcc.set_numerics_mode("direct")
    with pytest.raises(RuntimeError):
        with tcc.numerics_mode("lut"):
            with tcc.numerics_mode("direct"):
                assert tcc.get_numerics_mode("cpu") == "direct"
            assert tcc.get_numerics_mode("cpu") == "lut"
            raise RuntimeError("inside")
    assert tcc.get_numerics_mode("cuda") == "direct"
    assert tcc._NUMERICS_MODE == "direct"


@pytest.mark.parametrize("mode", MODES)
def test_jax_context_manager_agrees_inside(mode):
    with jcc.numerics_mode(mode), tcc.numerics_mode(mode):
        assert jcc.get_numerics_mode() == tcc.get_numerics_mode() == mode


@pytest.mark.parametrize("mode", MODES)
def test_fused_plans_resolve_by_device(dng_path, mode):
    """make_develop_plan and the batch engine ignore the override in both
    packages: 'auto' is 'lut' on the CPU (the JAX package's CPU backend)."""
    with jcc.numerics_mode(mode), tcc.numerics_mode(mode):
        jplan = jax_make_develop_plan(jip.Pipeline.new_from_file(dng_path))
        tplan = make_develop_plan(tip.Pipeline.new_from_file(dng_path, device="cpu"))
        engine = BatchEngine(devices=["cpu"])
    assert jplan.numerics == tplan.numerics == engine.numerics == "lut"


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("mode", MODES)
def test_staged_render_matches_jax_under_override(dng_path, mode, bits):
    jcc.set_numerics_mode(mode)
    tcc.set_numerics_mode(mode)
    want = _staged(jip.Pipeline.new_from_file(dng_path), bits, exposure=0.3)
    got = _staged(tip.Pipeline.new_from_file(dng_path, device="cpu"), bits, exposure=0.3)
    _assert_contract(got, want)


def test_override_reaches_the_staged_ops(dng_path):
    """At 16 bits 'lut' and 'direct' differ on some values: the staged
    render follows the override (each within the contract of the other)."""
    outs = {}
    for mode in MODES:
        with tcc.numerics_mode(mode):
            outs[mode] = _staged(tip.Pipeline.new_from_file(dng_path, device="cpu"), 16)
    assert not np.array_equal(outs["lut"], outs["direct"])
    _assert_contract(outs["direct"], outs["lut"])
    tcc._NUMERICS_MODE = None
    np.testing.assert_array_equal(
        _staged(tip.Pipeline.new_from_file(dng_path, device="cpu"), 16), outs["lut"])


def test_raster_ingest_follows_the_override():
    """gofloat's 8-bit raster ingest (expand_srgb_gamma) under 'direct' and
    'lut' against the JAX op under the same override."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (40, 56, 3), np.uint8)
    for mode in MODES:
        with jcc.numerics_mode(mode), tcc.numerics_mode(mode):
            jp = jip.Pipeline.new_from_source(jip.ImageSource.from_raster(rgb.copy()))
            tp = tip.Pipeline.new_from_source(tip.ImageSource.from_raster(rgb.copy()), "cpu")
            _assert_contract(_staged(tp, 16, exposure=0.2), _staged(jp, 16, exposure=0.2))


@pytest.mark.parametrize("mode,device,fuses", [
    ("lut", "cuda", True), ("direct", "cuda", True), (None, "cuda", True),
    ("lut", "cpu", True), ("direct", "cpu", True), (None, "cpu", True)])
def test_segment_routing(mode, device, fuses):
    """A segment fuses in either mode: on CUDA the kernel has a 'lut' and
    a 'direct' form, on the CPU the plain version computes either mode."""
    tcc._NUMERICS_MODE = mode
    assert ksuffix.fuses(torch.device(device)) is fuses


@pytest.mark.parametrize("mode", MODES)
def test_lut_on_a_cuda_buffer_runs_the_ops(dng_path, monkeypatch, mode):
    """The pipeline asks `fuses` for the segment's device; with a buffer
    that claims a CUDA device, either override fuses the segment: one
    run_suffix call in the overriding mode (the CPU buffer takes the plain
    version, no launch), bit-equal to FUSE_SUFFIX = False and with the
    same cache entries."""
    real = ksuffix.fuses
    monkeypatch.setattr(ksuffix, "fuses", lambda device: real(torch.device("cuda")))
    calls = []

    def spy(*args, **kwargs):
        calls.append((args[1], tcc.resolve_numerics(kwargs.get("numerics", "auto"),
                                                    args[0].device)))
        return real_run(*args, **kwargs)

    real_run = ksuffix.run_suffix
    monkeypatch.setattr(ksuffix, "run_suffix", spy)
    before = ksuffix.LAUNCHES
    with tcc.numerics_mode(mode):
        outs = {}
        for fuse in (True, False):
            monkeypatch.setattr(ppl, "FUSE_SUFFIX", fuse)
            p = tip.Pipeline.new_from_file(dng_path, device="cpu")
            p.ops.basecurve.exposure = 0.3
            cache = MultiCache(1 << 28)
            outs[fuse] = (np.asarray(p.output_8bit(cache).data), len(cache))
    assert ksuffix.LAUNCHES == before
    assert [m for _, m in calls] == [mode], calls
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    assert outs[True][1] == outs[False][1] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_lut_staged_render_on_card(dng_path, bits):
    """On the card: a 'lut' staged render launches the suffix kernel's
    'lut' form once and holds the contract against the JAX staged render
    in 'lut' and the port's 'direct' render; after the context, 'direct'
    launches the 'direct' form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staged path's kernels have no CPU form")
    jcc.set_numerics_mode("lut")
    want = _staged(jip.Pipeline.new_from_file(dng_path), bits, rotation=0.05)
    before = ksuffix.LAUNCHES, ksuffix.LUT_LAUNCHES
    with tcc.numerics_mode("lut"):
        got = _staged(tip.Pipeline.new_from_file(dng_path, device="cuda"), bits, rotation=0.05)
    assert (ksuffix.LAUNCHES, ksuffix.LUT_LAUNCHES) == (before[0], before[1] + 1)
    _assert_contract(got, want)
    direct = _staged(tip.Pipeline.new_from_file(dng_path, device="cuda"), bits, rotation=0.05)
    assert (ksuffix.LAUNCHES, ksuffix.LUT_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _assert_contract(direct, got)
