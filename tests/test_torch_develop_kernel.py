"""PyTorch port: the develop kernel's wrapper and its plain version.

The CUDA kernel (imagepipe_tpu_torch/csrc/develop.cu) has no CPU mode. Here
its plain PyTorch version `develop_plain` is held to the JAX package: to the
Pallas kernel in interpret mode (one small Bayer case; interpret mode is
slow) and to the JAX engine in 'direct' numerics for the rest. On a CPU
tensor the wrapper `develop` is the plain version. The kernel itself is
compared with the plain version on the card by the `cuda`-marked tests
below (`python -m pytest tests/test_torch_develop_kernel.py -m cuda` on a
machine with an NVIDIA GPU) and by chip_smoke.py.

Contract: max |diff| <= 1 LSB and under 2% of values differing.
"""

import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource, Pipeline
from imagepipe_tpu.engine import develop_fused, make_develop_plan
from imagepipe_tpu.kernels import develop_pallas as jdp
from imagepipe_tpu.raw import (Orientation, synthetic_bayer, synthetic_linear,
                               synthetic_mono, synthetic_xtrans)
from imagepipe_tpu_torch.engine import plan_from_jax
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import library
from imagepipe_tpu_torch.ops.transform import apply_flips

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _jax_plan(raw, bits=8, points=None):
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.linear = bits == 16
    if points is not None:
        p.ops.basecurve.points = points
    return make_develop_plan(p, out_bits=bits, numerics="direct")


def _plane(raw):
    return torch.from_numpy(np.ascontiguousarray(raw.data))


def _assert_contract(got, want):
    maxd, frac = kdev.compare(got, want)
    assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)


def test_plain_matches_pallas_interpret():
    raw = synthetic_bayer(168, 112)
    plan = _jax_plan(raw)
    want = np.asarray(jdp.develop_pallas(plan, raw.data, interpret=True))
    tplan = plan_from_jax(plan, "cpu")
    got = kdev.develop_plain(tplan, _plane(raw))
    _assert_contract(got, want)
    # On a CPU tensor the wrapper is the plain version, and launches nothing.
    before = kdev.LAUNCHES
    np.testing.assert_array_equal(kdev.develop(tplan, _plane(raw)).numpy(), got.numpy())
    assert kdev.LAUNCHES == before


def _rotated(o):
    raw = synthetic_bayer(168, 112)
    raw.orientation = o
    return raw


def _cropped():
    raw = synthetic_xtrans(150, 110)
    raw.crops = (3, 5, 7, 11)
    return raw


def _float_plane():
    raw = synthetic_bayer(168, 112)
    raw.data = raw.data.astype(np.float32)
    return raw


def _past_tile(make):
    """A frame cropped at the odd origin (11, 3) to 129 x 17: one pixel past
    the develop kernel's 128 x 8 tile in x and in y."""
    raw = make(129 + 16, 17 + 10)
    raw.crops = (3, 5, 7, 11)
    return raw


CASES = {
    "bayer16": (lambda: synthetic_bayer(168, 112), 16),
    "xtrans8": (lambda: synthetic_xtrans(174, 114), 8),
    "xtrans16": (lambda: synthetic_xtrans(174, 114), 16),
    "mono8": (lambda: synthetic_mono(168, 112), 8),
    "rotate90": (lambda: _rotated(Orientation.Rotate90), 8),
    "transverse16": (lambda: _rotated(Orientation.Transverse), 16),
    "crops": (_cropped, 8),
    "float_plane": (_float_plane, 8),
    "odd_size": (lambda: synthetic_xtrans(37, 29), 8),   # partial blocks, ragged edge
    "past_tile": (lambda: _past_tile(synthetic_bayer), 8),
    "past_tile_xtrans16": (lambda: _past_tile(synthetic_xtrans), 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_direct(case):
    make, bits = CASES[case]
    raw = make()
    plan = _jax_plan(raw, bits)
    want = np.asarray(develop_fused(plan, raw.data))
    got = kdev.develop_plain(plan_from_jax(plan, "cpu"), _plane(raw))
    _assert_contract(got, want)


@pytest.mark.parametrize("points", [None, [], [(0.2, 0.15), (0.5, 0.62), (0.8, 0.9)],
                                    [(x / 20, (x / 20) ** 0.8) for x in range(1, 20)]])
def test_calib_tables_equal(points):
    plan = _jax_plan(synthetic_bayer(64, 48), points=points)
    want = jdp.calib_tables(plan)
    got = kdev.calib_tables(plan_from_jax(plan, "cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("make", [synthetic_bayer, synthetic_xtrans, synthetic_mono,
                                  synthetic_linear])
def test_kernel_supported_mirrors_pallas(make):
    plan = _jax_plan(make(64, 48))
    assert kdev.kernel_supported(plan_from_jax(plan, "cpu")) == jdp.pallas_supported(plan)


@pytest.mark.parametrize("flips", [(t, x, y) for t in (False, True)
                                   for x in (False, True) for y in (False, True)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_apply_flips(flips, dtype):
    a = np.arange(3 * 5 * 7).reshape(3, 5, 7).astype(dtype)
    want = np.asarray(jdp.apply_flips(a, flips))
    got = apply_flips(torch.from_numpy(a), flips)
    assert got.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    raw = synthetic_linear(64, 48)
    tplan = plan_from_jax(_jax_plan(raw), "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        kdev.develop(tplan, torch.empty((48, 64), device="meta"))


def _kernel_demosaic(levels, pattern, interior):
    """csrc/develop.cu's demosaic in numpy float32, from its per-phase
    tables: the sums in offset order, then each average by the table's
    count (`interior`, for pixels whose nine offsets lie inside the crop) or
    by the valid neighbours counted (the border tiles' path); a power-of-two
    count multiplies by its reciprocal."""
    h, w = levels.shape
    ph, pw = pattern.shape
    phases = kdev.demosaic_phases(pattern)
    rows, cols = np.arange(h)[:, None], np.arange(w)[None, :]
    e = phases[(rows % ph) * pw + cols % pw]                       # [h, w, 16]
    padded = np.pad(levels, 1)
    s = np.zeros((4, h, w), np.float32)
    n = np.zeros((4, h, w), np.int64)
    for o, (dy, dx) in enumerate(kdev.OFFSETS_3X3):
        v = padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        valid = ((rows + dy >= 0) & (rows + dy < h)) & ((cols + dx >= 0) & (cols + dx < w))
        code = e[..., o] if interior else np.where(valid, e[..., o], 4)
        for c in range(4):
            s[c] = np.where(code == c, s[c] + v, s[c])
            n[c] += code == c
    if interior:
        n = np.moveaxis(e[..., 9:13], -1, 0).astype(np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        pow2 = (n & (n - 1)) == 0
        recip = np.ldexp(np.float32(1.0), -np.log2(np.maximum(n, 1)).astype(np.int32))
        avg = np.where(pow2, s * recip.astype(np.float32), s / n.astype(np.float32))
    out = np.where(n == 0, np.float32(0.0), avg).astype(np.float32)
    if interior:
        # The 2x2 path: the plus and cross sums, or the row and column pairs.
        v = {o: padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
             for o, (dy, dx) in enumerate(kdev.OFFSETS_3X3)}
        quad = e[..., 15]
        va = np.where(quad == 1, (((v[1] + v[3]) + v[5]) + v[7]) * np.float32(0.25),
                      (v[3] + v[5]) * np.float32(0.5))
        vb = np.where(quad == 1, (((v[0] + v[2]) + v[6]) + v[8]) * np.float32(0.25),
                      (v[1] + v[7]) * np.float32(0.5))
        for c in range(4):
            fast = np.where(e[..., 4] == c, v[4], np.where(e[..., 13] == c, va,
                            np.where(e[..., 14] == c, vb, np.float32(0.0))))
            out[c] = np.where(quad != 0, fast, out[c])
    return out


@pytest.mark.parametrize("case", ["bayer", "xtrans", "bayer_crop", "xtrans_crop", "xtrans_37x29",
                                  "2x4"])
def test_demosaic_phase_tables_match_stencil(case):
    """The develop kernel's per-phase colour and count tables give the plain
    stencil's RGBE bit for bit: through the border path at every pixel, and
    through the interior path wherever all nine offsets lie inside."""
    from imagepipe_tpu_torch.kernels.demosaic_full import stencil_demosaic_planes
    from imagepipe_tpu_torch.raw import CFA as PortCFA

    make = {"bayer": lambda: synthetic_bayer(64, 48), "xtrans": lambda: synthetic_xtrans(66, 48),
            "bayer_crop": lambda: _past_tile(synthetic_bayer),
            "xtrans_crop": lambda: _past_tile(synthetic_xtrans),
            "xtrans_37x29": lambda: synthetic_xtrans(37, 29),
            "2x4": lambda: synthetic_bayer(64, 48)}[case]
    raw = make()
    cfa_name = raw.cropped_cfa().name if case != "2x4" else "2x4:RGBGBGRG"
    pattern = PortCFA(cfa_name).pattern.astype(np.uint8)
    t, r, b, l = raw.crops
    h, w = raw.height - t - b, raw.width - l - r
    levels = np.random.default_rng(3).uniform(-0.1, 1.0, (h, w)).astype(np.float32)
    want = np.stack([p.numpy() for p in
                     stencil_demosaic_planes(torch.from_numpy(levels), cfa_name, h, w)])
    np.testing.assert_array_equal(_kernel_demosaic(levels, pattern, interior=False), want)
    inner = _kernel_demosaic(levels, pattern, interior=True)
    np.testing.assert_array_equal(inner[:, 1:-1, 1:-1], want[:, 1:-1, 1:-1])


@pytest.mark.parametrize("name", ["RGGB", "BGGR", "GRBG", "GBRG", "xtrans", "2x4:RGBGBGRG"])
def test_demosaic_phases_table(name):
    """Per phase: the centre keeps its own colour, same-colour neighbours are
    not summed, and the counts add up to the summed offsets."""
    from imagepipe_tpu_torch.raw import CFA as PortCFA

    if name == "xtrans":
        name = synthetic_xtrans(12, 12).cfa.name
    pattern = PortCFA(name).pattern.astype(np.uint8)
    ph, pw = pattern.shape
    t = kdev.demosaic_phases(pattern)
    assert t.shape == (ph * pw, 16) and t.dtype == np.uint8
    for py in range(ph):
        for px in range(pw):
            e = t[py * pw + px]
            assert e[4] == pattern[py, px]
            assert not any(e[o] == e[4] for o in range(9) if o != 4)
            assert int(e[9:13].sum()) == int((e[:9] < 4).sum())
            assert e[9 + e[4]] == 1
            # Bayer's four phases take the 2x2 path; other CFAs never do.
            assert (e[15] != 0) == (name in ("RGGB", "BGGR", "GRBG", "GBRG"))
            if e[15] == 1:
                assert e[9 + e[13]] == 4 and e[9 + e[14]] == 4
            if e[15] == 2:
                assert e[9 + e[13]] == 2 and e[9 + e[14]] == 2


@pytest.mark.parametrize("spline_stride", [16, 24, 160])
def test_develop_launch_fits_every_cfa(spline_stride):
    """A develop-kernel block fits in shared memory for every CFA period up
    to 48 x 48, and the wrapper raises (never falls back) past 227 KB."""
    sizes = [kdev.develop_smem_bytes(ph, pw, spline_stride)
             for ph in range(1, kdev.MAX_PATTERN + 1) for pw in range(1, kdev.MAX_PATTERN + 1)]
    assert max(sizes) == kdev.develop_smem_bytes(48, 48, spline_stride) <= library.MAX_SMEM
    assert kdev.develop_smem_bytes(48, 48, 10_000) > library.MAX_SMEM


@pytest.mark.cuda
def test_div_rcp_equals_ieee_division_on_card():
    """finish.cuh's div_rcp gives __fdiv_rn's quotient for every float
    dividend of each constant divisor and every u16 raw of the levels of the
    test calibrations (and every float raw of one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the check is a CUDA kernel")
    pairs = [tuple(float(v) for v in kdev.calib_tables(plan_from_jax(_jax_plan(make()), "cpu"))[0][0, :2])
             for make, _ in CASES.values()] + [(0.0, 1.0), (512.0, 15871.0), (2047.5, 0.37)]
    res = kdev.division_mismatches(pairs, pairs[:1])
    assert len(res["constants"]) == 8 and len(res["levels"]) == len(pairs)
    assert res["checked"] == {"constants": 1 << 32, "levels": len(pairs) << 16,
                              "levels_f32": 1 << 32}
    assert not any(res["constants"]) and not any(res["levels"]) and not any(res["levels_f32"]), res


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bayer8"] + list(CASES))
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    make, bits = CASES.get(case, (lambda: synthetic_bayer(168, 112), 8))
    raw = make()
    tplan = plan_from_jax(_jax_plan(raw, bits), "cuda")
    plane = _plane(raw).cuda()
    before = kdev.LAUNCHES
    got = kdev.develop(tplan, plane)
    torch.cuda.synchronize()
    assert kdev.LAUNCHES == before + 1
    _assert_contract(got, kdev.develop_plain(tplan, plane))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rgb-direct", "bayer-lut", "mono-direct"])
def test_eager_engine_on_card_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: compares the eager engine on the card with the CPU")
    from imagepipe_tpu_torch import engine as tengine

    kind, numerics = case.split("-")
    make = {"rgb": synthetic_linear, "bayer": synthetic_bayer, "mono": synthetic_mono}[kind]
    raw = make(168, 112)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    plan = make_develop_plan(p, out_bits=8, numerics=numerics)
    want = tengine.develop_fused(plan_from_jax(plan, "cpu"), _plane(raw))
    got = tengine.develop_fused(plan_from_jax(plan, "cuda"), _plane(raw).cuda())
    _assert_contract(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bayer", "xtrans", "mono", "rgb"])
def test_pipeline_routing_on_card(kind):
    """On CUDA, full-size cfa/mono plans launch the kernel once per output;
    rgb plans run the eager engine and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    import imagepipe_tpu_torch as tip
    from imagepipe_tpu_torch import raw as traw
    from imagepipe_tpu_torch.sources import ImageSource as PortSource

    make = {"bayer": traw.synthetic_bayer, "xtrans": traw.synthetic_xtrans,
            "mono": traw.synthetic_mono, "rgb": traw.synthetic_linear}[kind]
    src = PortSource.from_raw(make(168, 112))
    card = tip.Pipeline.new_from_source(src, device="cuda")
    cpu = tip.Pipeline.new_from_source(src, device="cpu")
    before = kdev.LAUNCHES
    got = card.output_8bit().data
    assert kdev.LAUNCHES == before + (0 if kind == "rgb" else 1)
    # The CPU pipeline runs 'lut' numerics, the card 'direct': <= 1 LSB apart.
    _assert_contract(got, cpu.output_8bit().data)


def _wb(i):
    return (1.0 + 0.15 * i, 1.0, 2.0 + 0.3 * i, float("nan"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bayer8", "bayer16", "xtrans8", "rotate90", "float_plane",
                                  "past_tile", "past_tile_xtrans16"])
def test_batch_kernel_matches_single_launches_on_card(case):
    """One batched launch equals B single launches bit for bit, each image
    with its own calibration, and holds the plain version's contract."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    make, bits = CASES.get(case, (lambda: synthetic_bayer(168, 112), 8))
    raws = [make() for _ in range(3)]
    for i, raw in enumerate(raws):
        raw.wb_coeffs = _wb(i)
    plans = [plan_from_jax(_jax_plan(raw, bits), "cuda") for raw in raws]
    planes = torch.from_numpy(np.stack([raw.data for raw in raws])).cuda()
    before = kdev.BATCH_LAUNCHES
    got = kdev.develop_batch(plans, planes)
    torch.cuda.synchronize()
    assert kdev.BATCH_LAUNCHES == before + 1
    for i, plan in enumerate(plans):
        assert torch.equal(got[i], kdev.develop(plan, planes[i]))
    _assert_contract(got, kdev.develop_batch_plain(plans, planes))
    assert not torch.equal(got[0], got[2])
