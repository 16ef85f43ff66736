"""PyTorch port: the fused dirty suffix (pipeline.FUSE_SUFFIX,
`ImageOp.device_chain`, `Pipeline._dispatch_fused`, kernels/suffix.py).

The staged path runs each maximal run of joining ops (a no-op rotatecrop,
to_lab, basecurve, from_lab, gamma, transform) as one segment: on CUDA one
launch of csrc/suffix.cu, on the CPU its plain version. The contract is the
JAX package's (tests/test_fused_suffix.py): outputs bit-equal to the
per-stage loop (`FUSE_SUFFIX = False`), the same cache entries and resume
depth. Where the JAX package falls back to the per-stage loop when its
fused dispatch fails, the port raises.

Tolerances: fused against staged in the port, bit-equal; the port against
the JAX package (both fused), the cross-path contract of
tests/test_torch_staged.py: max |diff| <= 1 LSB on under 2% of values.
The kernel against its plain version (`cuda` marker, on the card only):
bit-equal, NaN where the plain version has NaN.
"""

import numpy as np
import pytest
import torch

import imagepipe_tpu as jip
import imagepipe_tpu.pipeline as jpl
from imagepipe_tpu.raw import synthetic_bayer as jsynthetic_bayer
import imagepipe_tpu_torch as tip
import imagepipe_tpu_torch.pipeline as pl
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.buffer import OpBuffer, from_rgb_str_vec
from imagepipe_tpu_torch.cache import MultiCache
from imagepipe_tpu_torch.color import output8bit, output16bit
from imagepipe_tpu_torch.kernels import suffix as ksuffix
from imagepipe_tpu_torch.kernels.develop import MAX_FLIP_FRACTION, MAX_LSB, compare

torch.set_num_threads(1)

EXPOSURES = [{"exposure": 0.25}, {"exposure": 0.3}]


def _pipeline(make=traw.synthetic_bayer, orientation=None, settings=None, seed=0):
    raw = make(96, 72, seed=seed)
    if orientation is not None:
        raw.orientation = traw.Orientation[orientation]
    p = tip.Pipeline.new_from_source(tip.ImageSource.from_raw(raw), device="cpu")
    if settings is not None:
        p.ops.load_settings_dict(settings)
    return p


def _render(p, cache, bits):
    return (p.output_8bit(cache) if bits == 8 else p.output_16bit(cache)).data


def _develop(fuse, *, bits=8, orientation=None, edits=EXPOSURES, crop=0.0,
             make=traw.synthetic_bayer, settings=None, cache_inter=True, monkeypatch=None):
    """Render, then apply each basecurve edit and render again, with one
    cache. Returns (outputs, cache entries after each request, the first
    op each request ran)."""
    monkeypatch.setattr(pl, "FUSE_SUFFIX", fuse)
    monkeypatch.setattr(pl, "CACHE_FUSED_INTERMEDIATES", cache_inter)
    p = _pipeline(make, orientation, settings)
    p.ops.rotatecrop.crop_left = crop
    cache = MultiCache(200 << 20)
    outs, lens, starts = [], [], []
    for edit in [{}] + list(edits):
        for k, v in edit.items():
            setattr(p.ops.basecurve, k, v)
        outs.append(_render(p, cache, bits))
        lens.append(len(cache))
        starts.append(next(iter(p.stage_ms), "").split("+")[0])
    return outs, lens, starts


@pytest.fixture
def segments(monkeypatch):
    """The op names of every fused segment dispatched."""
    calls = []
    orig = pl.Pipeline._dispatch_fused

    def spy(self, ops, startpos, chains, *a, **k):
        calls.append([op.name() for op in ops[startpos:startpos + len(chains)]])
        return orig(self, ops, startpos, chains, *a, **k)

    monkeypatch.setattr(pl.Pipeline, "_dispatch_fused", spy)
    return calls


CASES = {
    "8-bit": {},
    "16-bit linear": {"bits": 16},
    "Rotate90": {"orientation": "Rotate90"},
    "Rotate180": {"orientation": "Rotate180"},
    "Transverse": {"orientation": "Transverse"},
    # Curve-point edits change the knot count.
    "spline curve edit": {"edits": [{"points": [(0.2, 0.3), (0.5, 0.6), (0.8, 0.85)]},
                                    {"points": [(0.5, 0.55)]}]},
    # An active crop declines to join: the tail after it still fuses.
    "past an active crop": {"crop": 0.1},
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_bit_equals_staged(case, segments, monkeypatch):
    kw = CASES[case]
    fused, flens, fstarts = _develop(True, monkeypatch=monkeypatch, **kw)
    fused_segments = list(segments)
    segments.clear()
    staged, slens, sstarts = _develop(False, monkeypatch=monkeypatch, **kw)
    assert not segments
    assert fused_segments and all(len(s) >= 2 for s in fused_segments)
    if kw.get("crop"):
        assert fused_segments[0][0] == "to_lab", fused_segments
    for f, s in zip(fused, staged):
        assert f.shape == s.shape and f.dtype == s.dtype
        np.testing.assert_array_equal(f, s)
    assert (flens, fstarts) == (slens, sstarts)


@pytest.mark.parametrize("cache_inter", [True, False], ids=["every stage", "last stage"])
def test_cache_entries_and_resume_depth(cache_inter, monkeypatch):
    """Every stage cached: entries and resume depth as the per-stage loop.
    Only a segment's last stage cached: the same outputs, one entry per
    segment, and an edit inside the segment resumes from the deepest entry
    before it (the no-op rotatecrop after demosaic)."""
    fused, flens, fstarts = _develop(True, cache_inter=cache_inter, monkeypatch=monkeypatch)
    staged, slens, sstarts = _develop(False, monkeypatch=monkeypatch)
    for f, s in zip(fused, staged):
        np.testing.assert_array_equal(f, s)
    assert (slens, sstarts) == ([8, 12, 16], ["gofloat", "basecurve", "basecurve"])
    if cache_inter:
        assert (flens, fstarts) == (slens, sstarts)
    else:
        assert (flens, fstarts) == ([3, 4, 5], ["gofloat", "rotatecrop", "rotatecrop"])


def test_cache_hit_adds_no_entry(monkeypatch):
    monkeypatch.setattr(pl, "FUSE_SUFFIX", True)
    p = _pipeline()
    cache = MultiCache(200 << 20)
    first = _render(p, cache, 8)
    n = len(cache)
    np.testing.assert_array_equal(_render(p, cache, 8), first)
    assert len(cache) == n and p.stage_ms == {}


@pytest.mark.parametrize("bits", [8, 16])
def test_run_impl_fuses_the_quantize(bits, segments):
    p = _pipeline()
    cache = MultiCache(200 << 20)
    _render(p, cache, bits)
    p.ops.basecurve.exposure = 0.4
    p.globals.settings.linear = bits == 16
    buffer, quant = p._run_impl(cache, final_quant=bits)
    assert segments[-1] == ["basecurve", "from_lab", "gamma", "transform"]
    assert quant is not None
    assert tuple(quant.shape) == (3, 72, 96)
    assert quant.dtype == (torch.uint8 if bits == 8 else torch.uint16)
    want = output8bit(buffer.data) if bits == 8 else output16bit(buffer.data)
    assert torch.equal(quant, want)
    # run() keeps its return: the final buffer, nothing quantized.
    assert isinstance(p.run(cache), OpBuffer)


@pytest.mark.parametrize("bits", [8, 16])
def test_fused_matches_jax(bits, monkeypatch):
    """Both packages fused (their FUSE_SUFFIX default): the first render
    and two exposure edits, held to the cross-path contract."""
    assert jpl.FUSE_SUFFIX and pl.FUSE_SUFFIX
    jraw, traw_ = jsynthetic_bayer(96, 72, seed=3), traw.synthetic_bayer(96, 72, seed=3)
    np.testing.assert_array_equal(np.asarray(jraw.data), np.asarray(traw_.data))
    jp = jip.Pipeline.new_from_source(jip.ImageSource.from_raw(jraw))
    tp = tip.Pipeline.new_from_source(tip.ImageSource.from_raw(traw_), device="cpu")
    jc, tc = jip.Pipeline.new_cache(200 << 20), MultiCache(200 << 20)
    for edit in [{}] + EXPOSURES:
        for p in (jp, tp):
            for k, v in edit.items():
                setattr(p.ops.basecurve, k, v)
        want, got = _render(jp, jc, bits), _render(tp, tc, bits)
        assert got.shape == want.shape and got.dtype == want.dtype
        maxd, frac = compare(got, want)
        assert maxd <= MAX_LSB and frac < MAX_FLIP_FRACTION, (edit, maxd, frac)
        assert len(tc) == len(jc)


def test_segment_failure_raises(monkeypatch):
    """The JAX package falls back to the per-stage loop when its fused
    dispatch fails (test_fused_dispatch_failure_falls_back_per_stage); the
    port raises, and runs no op after the failed segment."""
    def boom(*a, **k):
        raise RuntimeError("suffix kernel launch failed: cudaError 1")

    monkeypatch.setattr(ksuffix, "run_suffix", boom)
    ran = []
    orig = pl.colorspaces.OpToLab.run
    monkeypatch.setattr(pl.colorspaces.OpToLab, "run",
                        lambda self, *a: ran.append(1) or orig(self, *a))
    p = _pipeline()
    with pytest.raises(RuntimeError, match="suffix kernel"):
        p.output_8bit(MultiCache(200 << 20))
    assert not ran


# -- the keys of device_chain -------------------------------------------------

@pytest.mark.parametrize("make", [traw.synthetic_mono, traw.synthetic_bayer],
                         ids=["monochrome", "colour"])
def test_monochrome_and_colour_frames_with_equal_settings(make, monkeypatch):
    """A monochrome frame and a colour frame with the colour frame's
    settings of the suffix's ops: each fused render bit-equal to its staged
    one, and to_lab's key tells the two apart."""
    colour = _pipeline(traw.synthetic_bayer).ops.to_settings_dict()
    settings = {k: colour[k] for k in ("tolab", "basecurve", "fromlab", "gamma", "transform")}
    fused, flens, _ = _develop(True, make=make, settings=settings, monkeypatch=monkeypatch)
    staged, slens, _ = _develop(False, make=make, settings=settings, monkeypatch=monkeypatch)
    for f, s in zip(fused, staged):
        np.testing.assert_array_equal(f, s)
    assert flens == slens
    op = _pipeline(make, settings=settings).ops.tolab
    assert op.shash() == _pipeline(traw.synthetic_bayer).ops.tolab.shash()
    keys = {mono: op.device_chain(None, (96, 72, 4, mono))[0] for mono in (False, True)}
    assert keys[False] != keys[True]


def _settings(linear=False):
    return tip.PipelineGlobals(None, tip.PipelineSettings(linear=linear))


def _variants(name):
    """(op, globals, meta) over the statics that op's device_chain reads."""
    ops = _pipeline().ops
    metas = [(96, 72, c, mono) for c in (3, 4) for mono in (False, True)]
    out = []
    if name == "rotatecrop":
        for rotation in (0.0, 0.1):
            op = type(ops.rotatecrop)()
            op.rotation = rotation
            out += [(op, _settings(), m) for m in metas]
    elif name == "to_lab":
        for wb in ([2.0, 1.0, 1.5, float("nan")], [1.0, 1.0, 1.0, 0.0]):
            op = _pipeline().ops.tolab
            op.wb_coeffs = wb
            out += [(op, _settings(), m) for m in metas]
    elif name == "basecurve":
        for points, exposure in (([], 0.0), ([], 0.5), ([(0.5, 0.6)], 0.0),
                                 ([(0.2, 0.3), (0.5, 0.6), (0.8, 0.85)], 0.2)):
            op = _pipeline().ops.basecurve
            op.points, op.exposure = points, exposure
            out += [(op, _settings(), m) for m in metas]
    elif name in ("from_lab", "gamma"):
        op = ops.fromlab if name == "from_lab" else ops.gamma
        out += [(op, _settings(linear), m) for m in metas for linear in (False, True)]
    else:
        for rotation in ("Normal", "Rotate90", "Rotate180", "Rotate270"):
            for fliph in (False, True):
                for flipv in (False, True):
                    op = _pipeline().ops.transform
                    op.rotation = type(op.rotation)(rotation)
                    op.fliph, op.flipv = fliph, flipv
                    out += [(op, _settings(), m) for m in metas]
    return out


def _statics(chain, meta):
    """What a segment launch takes from one op: its stage, the host
    values of its params, and whether it swaps the buffer's sides."""
    _, stage, params, out_meta = chain
    return (stage, tuple(np.asarray(p).tobytes() if isinstance(p, np.ndarray) else p
                         for p in params), out_meta[:2] != meta[:2])


@pytest.mark.parametrize("name", ksuffix.STAGES[:4] + ("rotatecrop", "transform"))
def test_device_chain_key_holds_every_static(name):
    """Equal settings (shash) and an equal key give the same stage, params
    and output descriptor, so a memo keyed on (shash, key) would be exact;
    the JAX package's param key omits monochrome (pipeline.py:392)."""
    seen = {}
    for op, g, meta in _variants(name):
        chain = op.device_chain(g, meta)
        if chain is None:
            continue
        assert chain[1] in ksuffix.STAGES or chain[1] is None
        ident = (op.shash(), chain[0])
        statics = _statics(chain, meta)
        assert seen.setdefault(ident, statics) == statics, (name, ident)
    assert seen


# -- the wrapper -------------------------------------------------------------

BAD_SEGMENTS = {
    "no stage": ([], 4),
    "out of order": (["from_lab", "basecurve"], 3),
    "unknown stage": (["sharpen"], 3),
    "to_lab on 3 planes": (["to_lab"], 3),
    "quantize to 12 bits": (["gamma"], 3),
}


@pytest.mark.parametrize("case", list(BAD_SEGMENTS))
def test_run_suffix_checks_its_segment(case):
    stages, planes = BAD_SEGMENTS[case]
    data = torch.zeros((planes, 4, 5))
    quant = 12 if "12" in case else 8
    with pytest.raises(ValueError):
        ksuffix.run_suffix(data, stages, [()] * len(stages), quant)


def test_run_suffix_keeps_what_it_is_asked_for():
    """Outputs not kept are None; a transposing transform swaps the sides
    of its output and of the quantize."""
    p = _pipeline(orientation="Rotate90")
    cache = MultiCache(200 << 20)
    _render(p, cache, 8)
    dem = cache.get(_stage_hash(p, 2))
    meta = (dem.width, dem.height, dem.colors, dem.monochrome)
    chains = p._chains(p.ops.all_ops(), 2, dem)
    assert [c[1] for c in chains] == [None, *ksuffix.STAGES]
    assert meta[:2] == (96, 72) and chains[-1][3][:2] == (72, 96)
    real = chains[1:]
    keep = [False, True, False, False, True]
    outs, quant = ksuffix.run_suffix(dem.data, [c[1] for c in real], [c[2] for c in real], 8,
                                     keep)
    assert [o is not None for o in outs] == keep
    assert tuple(outs[-1].shape) == tuple(quant.shape) == (3, 96, 72)
    want = ksuffix.suffix_plain(dem.data, [c[1] for c in real], [c[2] for c in real], 8)
    for got, w, k in zip(outs, want[0], keep):
        if k:
            assert torch.equal(got, w)
    assert torch.equal(quant, want[1])


def _stage_hash(p, nstages):
    from imagepipe_tpu_torch.hasher import BufHasher
    from imagepipe_tpu_torch.sources import image_content_hash

    h = BufHasher()
    h.write(image_content_hash(p.globals.image))
    p.globals.settings.hash(h)
    for op in p.ops.all_ops()[:nstages]:
        op.hash(h)
    return h.result()


# -- the OpBuffer constructors ----------------------------------------------

CONSTRUCTORS = {
    "OpBuffer.new": lambda **k: OpBuffer.new(5, 4, 3, False, **k),
    "OpBuffer.from_hwc": lambda **k: OpBuffer.from_hwc(np.ones((4, 5, 3), np.float32), **k),
    "from_rgb_str_vec": lambda **k: from_rgb_str_vec(["RGBO ", "OOOOO"], **k),
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_buffer_constructors_default_to_the_default_device(name, monkeypatch):
    """Like the JAX package's, which put a buffer on its default device:
    the port's is `default_device()` (the first CUDA device); the CPU when
    asked for."""
    monkeypatch.setattr(pl, "default_device", lambda: torch.device("meta"))
    assert CONSTRUCTORS[name]().data.device.type == "meta"
    assert CONSTRUCTORS[name](device="cpu").data.device.type == "cpu"


# -- on the card ---------------------------------------------------------------

def _planted(shape, seed):
    """A seeded [C, H, W] float32 input over [-0.1, 1.2) with NaN, +Inf
    and -Inf planted."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(-0.1, 1.2, shape).astype(np.float32)
    flat = data.reshape(-1)
    for value in (np.nan, np.inf, -np.inf):
        flat[rng.integers(0, flat.size, 40)] = value
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("orientation", ["Normal", "Rotate90", "Transverse"])
@pytest.mark.parametrize("bits", [8, 16])
def test_suffix_kernel_bit_equal_to_plain(bits, orientation):
    """The kernel against its plain version on the card, every stage from
    to_lab, on an odd-sized input with NaN and +-Inf planted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the suffix kernel has no CPU form")
    p = _pipeline(orientation=orientation)
    p.globals.settings.linear = bits == 16
    p.ops.basecurve.exposure = 0.3
    chains = p._chains(p.ops.all_ops(), 3, OpBuffer(131, 67, 4, False, torch.zeros(0)))
    real = [c for c in chains if c[1] is not None]
    data = torch.from_numpy(_planted((4, 67, 131), 5)).cuda()
    args = ([c[1] for c in real], [c[2] for c in real], bits)
    got, want = ksuffix.run_suffix(data, *args), ksuffix.suffix_plain(data, *args)
    torch.cuda.synchronize()
    for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.is_floating_point():
            assert torch.equal(g.isnan(), w.isnan())
            g, w = g.nan_to_num(0.0), w.nan_to_num(0.0)
        assert torch.equal(g, w)
