"""PyTorch port: the fused dirty suffix in 'lut' numerics (kernels/suffix.py,
csrc/suffix.cu's 'lut' form) against the JAX package under
`color.numerics_mode("lut")`.

* The plain version `suffix_plain(numerics="lut")` against the JAX ops'
  own stage functions (`ImageOp.device_chain`, run op by op under the JAX
  override, as eager jnp ops) for every segment start (to_lab, basecurve,
  from_lab, gamma) to the 8-bit and the 16-bit linear output, at Normal,
  Rotate90 and Transverse, and a monochrome frame. The inputs, made from a
  numpy seed, carry NaN, +-Inf, negatives, values above 1, exact table
  knots i / 8191 and subnormals. Tolerance: bit-equal (NaN at the same
  places) on every pixel but two kinds, and rtol 1e-6, atol 1e-6 on
  those: the JAX package's out-of-range fallback takes a float32 cbrt
  where the port's takes the cube root in float64 rounded once (a pixel
  whose XYZ / W lookup is above 1), and XLA on the CPU flushes subnormal
  inputs to zero (a pixel with a subnormal input). The quantized output
  equal on the other pixels and within the cross-path contract
  (kernels/develop.py: max |diff| <= 1 LSB on under 2% of values)
  everywhere.
* The fused staged render of a DNG in 'lut' against the JAX package's
  `_dispatch_fused` in 'lut', within the contract, with the segment fused
  in both packages.
* `run_suffix` resolves 'auto' as the staged ops do and passes the mode
  through.
* On the card (`cuda` marker): the kernel's 'lut' form against its plain
  version, bit for bit, NaN and +-Inf inputs included.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import imagepipe_tpu as jip
import imagepipe_tpu.pipeline as jpl
from imagepipe_tpu import color as jcc
from imagepipe_tpu.dng import write_dng
from imagepipe_tpu.raw import Orientation as JOrientation
from imagepipe_tpu.raw import synthetic_bayer as jsynthetic_bayer
from imagepipe_tpu.raw import synthetic_mono as jsynthetic_mono
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import color as tcc
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.buffer import OpBuffer
from imagepipe_tpu_torch.cache import MultiCache
from imagepipe_tpu_torch.kernels import suffix as ksuffix
from imagepipe_tpu_torch.kernels.develop import MAX_FLIP_FRACTION, MAX_LSB, compare

torch.set_num_threads(1)

W, H = 64, 48
STARTS = ("to_lab", "basecurve", "from_lab", "gamma")
SETTINGS = [(bits, o, False) for bits in (8, 16) for o in ("Normal", "Rotate90", "Transverse")]
SETTINGS += [(8, "Normal", True), (16, "Normal", True)]
# Every (setting, start) with a segment from that start: a 16-bit linear
# frame has no gamma stage.
CASES = [(s, start) for s in SETTINGS for start in STARTS if not (s[0] == 16 and start == "gamma")]
CASE_IDS = [f"{b}-bit-{o}{'-mono' if m else ''}-from-{start}" for (b, o, m), start in CASES]


@pytest.fixture(autouse=True)
def restore_modes():
    """Leave both packages' numerics override as this test found it."""
    saved = tcc._NUMERICS_MODE, jcc._NUMERICS_MODE
    yield
    tcc._NUMERICS_MODE, jcc._NUMERICS_MODE = saved


def _chains(bits, orientation, mono):
    """The whole chainable tail's chains (rotatecrop to transform) of both
    packages' pipelines over the same synthetic frame, exposure +0.3:
    the port's [(stage, params)] and the JAX package's [(fn, params)],
    identities dropped."""
    traw_ = (traw.synthetic_mono if mono else traw.synthetic_bayer)(W, H, seed=1)
    jraw = (jsynthetic_mono if mono else jsynthetic_bayer)(W, H, seed=1)
    traw_.orientation = traw.Orientation[orientation]
    jraw.orientation = JOrientation[orientation]
    tp = tip.Pipeline.new_from_source(tip.ImageSource.from_raw(traw_), "cpu")
    jp = jip.Pipeline.new_from_source(jip.ImageSource.from_raw(jraw))
    for p in (tp, jp):
        p.globals.settings.linear = bits == 16
        p.ops.basecurve.exposure = 0.3
    tc = tp._chains(tp.ops.all_ops(), 3, OpBuffer(W, H, 4, mono, torch.empty(0)))
    meta, jc = (W, H, 4, mono), []
    for op in jp.ops.all_ops()[3:]:
        c = op.device_chain(jp.globals, meta)
        if c is None:
            break
        jc.append(c)
        meta = c[3]
    assert [c[0][0] for c in tc] == [c[0][0] for c in jc]
    keep = [k for k, c in enumerate(tc) if c[1] is not None]
    assert keep == [k for k, c in enumerate(jc) if c[1] is not None]
    return [(tc[k][1], tc[k][2]) for k in keep], [(jc[k][1], jc[k][2]) for k in keep]


def _planted(x: np.ndarray, seed: int) -> np.ndarray:
    """x with NaN, +-Inf, exact table knots i / 8191, 0, 1 and subnormals
    planted at seeded places (each at least once per plane on average)."""
    rng = np.random.default_rng(seed)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, 12 * 24, replace=False).reshape(12, 24)
    flat[idx[0]], flat[idx[1]], flat[idx[2]] = np.nan, np.inf, -np.inf
    knots = rng.integers(0, 8192, idx[3:7].size) / np.float32(8191)
    flat[idx[3:7].reshape(-1)] = knots.astype(np.float32)
    flat[idx[7]], flat[idx[8]] = np.float32(0.0), np.float32(1.0)
    flat[idx[9]], flat[idx[10]] = np.float32(1e-40), np.float32(-1e-40)
    flat[idx[11]] = np.float32(np.nextafter(np.float32(1.0), np.float32(2.0)))
    return x


def _inputs(chains, seed):
    """One input per segment start: a seeded [4, H, W] plane over [-0.1,
    1.2), then the port's plain 'lut' stage outputs on it, each planted."""
    rng = np.random.default_rng(seed)
    base = (rng.random((4, H, W), dtype=np.float32) * np.float32(1.3)
            - np.float32(0.1)).astype(np.float32)
    stages, params = [s for s, _ in chains], [p for _, p in chains]
    outs = ksuffix.suffix_plain(torch.from_numpy(base.copy()), stages, params,
                                numerics="lut")[0]
    ins = [base] + [o.numpy().copy() for o in outs[:len(STARTS) - 1]]
    return [_planted(x, seed + 1 + k) for k, x in enumerate(ins)]


def _fallback_cbrt(x: np.ndarray, params) -> np.ndarray:
    """[H, W]: the pixels of a to_lab input whose XYZ / W lookups take the
    out-of-range cube root (a value above 1, +Inf included), computed as
    color.camera_to_lab_planar computes them (IEEE float32, left to
    right)."""
    mul, cm = (np.asarray(p, np.float32) for p in params)
    wb = [np.minimum(x[c] * mul[c], np.float32(1.0)) for c in range(4)]
    with np.errstate(invalid="ignore"):
        xyz = [((wb[0] * cm[r, 0] + wb[1] * cm[r, 1]) + wb[2] * cm[r, 2]) + wb[3] * cm[r, 3]
               for r in range(3)]
        looked = [xyz[0] / np.float32(tcc.XW), xyz[1], xyz[2] / np.float32(tcc.ZW)]
        return np.any([v > 1.0 for v in looked], axis=0)


def _flip(mask, flips):
    transpose, flip_x, flip_y = flips
    if flip_x:
        mask = mask[:, ::-1]
    if flip_y:
        mask = mask[::-1, :]
    return mask.T if transpose else mask


def _jax_segment(jchains, x, bits):
    """The JAX stage functions op by op (eager jnp) under the JAX 'lut'
    override, then its quantize: ([each stage's output], quantized)."""
    outs = []
    with jcc.numerics_mode("lut"):
        d = jnp.asarray(x)
        for fn, p in jchains:
            d = fn(d, *p)
            outs.append(np.asarray(d))
        q = np.asarray(jcc.output8bit(d) if bits == 8 else jcc.output16bit(d))
    return outs, q


@pytest.mark.parametrize("setting,start", CASES, ids=CASE_IDS)
def test_plain_lut_matches_jax_stage_functions(setting, start):
    bits, orientation, mono = setting
    tchains, jchains = _chains(bits, orientation, mono)
    stages = [s for s, _ in tchains]
    k = stages.index(start)
    x = _inputs(tchains, 40 + 7 * k)[STARTS.index(start)]
    got, q = ksuffix.suffix_plain(torch.from_numpy(x.copy()), stages[k:],
                                  [p for _, p in tchains[k:]], bits, numerics="lut")
    want, jq = _jax_segment(jchains[k:], x, bits)
    subnormal = ((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)).any(axis=0)
    exact = ~subnormal
    if start == "to_lab":
        exact &= ~_fallback_cbrt(x, tchains[0][1])
    assert exact.mean() > 0.5, exact.mean()
    flips = dict(tchains).get("transform", (False, False, False))
    for stage, g, w in zip(stages[k:], got, want):
        g = g.numpy()
        mask = _flip(exact, flips) if stage == "transform" else exact
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, stage
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=stage)
        same = (g.view(np.int32) == w.view(np.int32)) | np.isnan(g)
        assert same[:, mask].all(), (stage, int((~same[:, mask]).sum()))
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=stage)
    q = q.numpy()
    mask = _flip(exact, flips)
    np.testing.assert_array_equal(q[:, mask], jq[:, mask])
    maxd, frac = compare(q, jq)
    assert maxd <= MAX_LSB and frac < MAX_FLIP_FRACTION, (maxd, frac)


def test_inputs_reach_every_branch():
    """The planted inputs reach the lookups' fallback on both sides of
    [0, 1] and with NaN, and the table knots: what the bit-equality above
    and phase 1e on the card rest on."""
    tchains, _ = _chains(8, "Normal", False)
    ins = _inputs(tchains, 40)
    x = ins[0]
    assert _fallback_cbrt(x, tchains[0][1]).any()
    for v in ins:
        assert np.isnan(v).any() and np.isposinf(v).any() and np.isneginf(v).any()
        assert (v < 0).any() and (v > 1).any()
    knots = x * np.float32(8191)
    assert (np.isfinite(knots) & (knots == np.trunc(knots)) & (x > 0) & (x < 1)).any()


def _dng(tmp_path, orientation=JOrientation.Rotate90):
    raw = jsynthetic_bayer(168, 112, seed=12)
    raw.orientation = orientation
    path = str(tmp_path / "frame.dng")
    write_dng(path, raw)
    return path


@pytest.mark.parametrize("rotation", [0.0, 0.05], ids=["no rotation", "rotated 0.05"])
@pytest.mark.parametrize("bits", [8, 16])
def test_fused_lut_render_matches_jax_dispatch_fused(tmp_path, monkeypatch, bits, rotation):
    """A staged render with a cache (fast path off) and an exposure edit, in
    'lut' in both packages, each fusing its dirty suffix: the JAX package's
    `_dispatch_fused` jits it in 'lut', the port's `_dispatch_fused` runs
    `run_suffix` in 'lut'. Within the contract, the same cache entries."""
    path = _dng(tmp_path)
    seen = {"jax": 0, "port": []}
    jorig = jpl.Pipeline._dispatch_fused

    def jspy(self, *a, **k):
        seen["jax"] += 1
        assert jcc.get_numerics_mode() == "lut"
        return jorig(self, *a, **k)

    torig = ksuffix.suffix_plain

    def tspy(*a, **k):
        seen["port"].append(k.get("numerics", a[5] if len(a) > 5 else "auto"))
        return torig(*a, **k)

    monkeypatch.setattr(jpl.Pipeline, "_dispatch_fused", jspy)
    monkeypatch.setattr(ksuffix, "suffix_plain", tspy)
    jcc.set_numerics_mode("lut")
    tcc.set_numerics_mode("lut")
    pipes = (jip.Pipeline.new_from_file(path), tip.Pipeline.new_from_file(path, device="cpu"))
    caches = (jip.Pipeline.new_cache(200 << 20), MultiCache(200 << 20))
    for p in pipes:
        p.globals.settings.use_fastpath = False
        p.globals.settings.linear = bits == 16
        p.ops.rotatecrop.rotation = rotation
    for exposure in (0.0, 0.3):
        outs = []
        for p, c in zip(pipes, caches):
            p.ops.basecurve.exposure = exposure
            out = p.output_8bit(c) if bits == 8 else p.output_16bit(c)
            outs.append(np.asarray(out.data))
        want, got = outs
        assert got.shape == want.shape and got.dtype == want.dtype
        maxd, frac = compare(got, want)
        assert maxd <= MAX_LSB and frac < MAX_FLIP_FRACTION, (exposure, maxd, frac)
        assert len(caches[1]) == len(caches[0])
    assert seen["jax"] >= 2 and len(seen["port"]) >= 2, seen
    assert set(seen["port"]) == {"lut"}, seen


@pytest.mark.parametrize("override,numerics,want", [
    (None, "auto", "lut"), ("direct", "auto", "direct"), ("lut", "auto", "lut"),
    ("direct", "lut", "lut"), ("lut", "direct", "direct")])
def test_run_suffix_passes_the_resolved_mode(monkeypatch, override, numerics, want):
    """'auto' resolves through color.resolve_numerics (the override, else
    the device's mode: 'lut' on the CPU); an explicit mode passes. On a CPU
    tensor run_suffix is the plain version in that mode, bit for bit."""
    tchains, _ = _chains(8, "Rotate90", False)
    stages, params = [s for s, _ in tchains], [p for _, p in tchains]
    x = torch.from_numpy(_inputs(tchains, 40)[0])
    seen = []
    orig = ksuffix.suffix_plain
    monkeypatch.setattr(ksuffix, "suffix_plain",
                        lambda *a, **k: seen.append(a[5]) or orig(*a, **k))
    tcc._NUMERICS_MODE = override
    got = ksuffix.run_suffix(x, stages, params, 8, numerics=numerics)
    assert seen == [want]
    tcc._NUMERICS_MODE = None
    ref = orig(x, stages, params, 8, numerics=want)
    for g, w in zip(got[0] + [got[1]], ref[0] + [ref[1]]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_lut_and_direct_differ_and_fuse_alike(monkeypatch):
    """The two forms compute different functions (the plain version's
    'lut' and 'direct' differ on the 16-bit output), and a segment fuses
    on the CPU and CUDA in both (`fuses`), elsewhere in neither."""
    tchains, _ = _chains(16, "Normal", False)
    stages, params = [s for s, _ in tchains], [p for _, p in tchains]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((4, H, W), dtype=np.float32))
    q = {m: ksuffix.suffix_plain(x, stages, params, 16, numerics=m)[1] for m in ("lut", "direct")}
    assert not torch.equal(q["lut"], q["direct"])
    for mode in ("lut", "direct", None):
        tcc._NUMERICS_MODE = mode
        assert ksuffix.fuses("cpu") and ksuffix.fuses(torch.device("cuda"))
        assert not ksuffix.fuses("meta")


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the suffix kernel has no CPU form")
    return torch.device("cuda")


def _same_bits(g, w):
    if not g.is_floating_point():
        return torch.equal(g, w)
    nan = g.isnan()
    return torch.equal(nan, w.isnan()) and torch.equal(
        g.masked_fill(nan, 0).contiguous().view(torch.int32),
        w.masked_fill(nan, 0).contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("setting,start", CASES, ids=CASE_IDS)
def test_lut_kernel_bit_equals_plain_on_card(card, setting, start):
    """The kernel's 'lut' form against suffix_plain(numerics="lut") on the
    card: one LUT_LAUNCHES launch, every output bit-equal (NaN at the same
    places), every stage kept and only the last."""
    bits, orientation, mono = setting
    tchains, _ = _chains(bits, orientation, mono)
    stages = [s for s, _ in tchains]
    k = stages.index(start)
    x = torch.from_numpy(_inputs(tchains, 40 + 7 * k)[STARTS.index(start)]).to(card)
    st, pa = stages[k:], [p for _, p in tchains[k:]]
    for keep in ([True] * len(st), [i == len(st) - 1 for i in range(len(st))]):
        before = ksuffix.LUT_LAUNCHES, ksuffix.LAUNCHES
        got = ksuffix.run_suffix(x, st, pa, bits, keep, numerics="lut")
        assert (ksuffix.LUT_LAUNCHES, ksuffix.LAUNCHES) == (before[0] + 1, before[1])
        want = ksuffix.suffix_plain(x, st, pa, bits, keep, numerics="lut")
        for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
            assert (g is None) == (w is None)
            if g is not None:
                assert _same_bits(g, w)
