"""PyTorch port: the batch engine's width-sharded eager route and `shard_batch`.

* `BatchEngine(devices=["cpu"] * n, spatial=s)` develops every chunk the
  eager engine takes width-sharded (`engine.develop_batch_perimage_sp`):
  cfa, mono and rgb plans at full size in 'lut' and 'direct' numerics,
  8-bit and 16-bit, Normal / Rotate90 / Transverse, with crops, at an odd
  width and at a width narrower than the shards; 'fulldown', 'plaindown'
  and eager 'scaled' plans by output columns. Each result is bit-equal to
  the port's spatial=1 engine: no per-pixel operation or order depends on
  the shard.
* The same against the JAX package's XLA engine on its dp x sp mesh
  (`BatchEngine(make_batch_mesh(spatial=2), executor="xla")`, GSPMD
  partitioning over the 8 virtual CPU devices of tests/conftest.py) at
  widths it takes (the sensor width a multiple of `spatial`): max |diff|
  <= 1 LSB on under 2% of values. At 16 bits with a transposing
  orientation the reference is the JAX staged path (ROADMAP "Known": the
  JAX fused engine misses its own staged path there by up to 13 LSB).
* The resize shards' source spans cover every window of their output
  columns.
* `parallel.shard_batch`: its pieces concatenate back to the input and
  equal the JAX `shard_batch`'s addressable shards where B and W divide.

The eager route launches no kernel: the `cuda`-marked test holds it on two
shards of one card, bit-equal to spatial=1, with every launch counter
unchanged.
"""

import jax
import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource as JSource
from imagepipe_tpu import Pipeline as JPipeline
from imagepipe_tpu import raw as jraw
from imagepipe_tpu.cache import MultiCache as JCache
from imagepipe_tpu.engine import make_develop_plan as jax_make_develop_plan
from imagepipe_tpu.parallel import BatchEngine as JBatchEngine
from imagepipe_tpu.parallel import make_batch_mesh as jax_mesh
from imagepipe_tpu.parallel import shard_batch as jax_shard_batch
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch import scaling as tscaling
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds
from imagepipe_tpu_torch.kernels import rotate as krot
from imagepipe_tpu_torch.kernels import suffix as ksuf
from imagepipe_tpu_torch.parallel import BatchEngine, make_batch_mesh, shard_batch
from imagepipe_tpu_torch.sources import ImageSource as TSource

torch.set_num_threads(1)


def _raws(module, make, width, height, seeds, orientation=None, crops=None):
    """Frames of one shape class from `module`'s generator, the second with
    its own white balance (per-image calibration)."""
    out = []
    for i, seed in enumerate(seeds):
        r = getattr(module, make)(width, height, seed=seed)
        if orientation is not None:
            r.orientation = module.Orientation(orientation)
        if crops is not None:
            r.crops = crops
        if i == 1 and make != "synthetic_mono":
            r.wb_coeffs = (1.0, 1.0, 2.4, float("nan"))
        out.append(r)
    return out


class _Port(BatchEngine):
    """The port's engine with plans in the chosen numerics."""

    def __init__(self, numerics, **kw):
        super().__init__(**kw)
        self.numerics = numerics


class _Jax(JBatchEngine):
    """The JAX engine with plans in the chosen numerics."""

    def __init__(self, mesh, numerics, **kw):
        super().__init__(mesh, **kw)
        self.numerics = numerics

    def _plan_for(self, source):
        pipe = JPipeline.new_from_source(source)
        s = pipe.globals.settings
        s.maxwidth, s.maxheight, s.linear = self.maxwidth, self.maxheight, self.out_bits == 16
        return jax_make_develop_plan(pipe, out_bits=self.out_bits, numerics=self.numerics)


def _counting(monkeypatch):
    """Record (images, shards, devices) of each sharded eager develop."""
    calls = []
    real = tengine.develop_batch_perimage_sp

    def counted(plans, shards, devices):
        calls.append((len(plans), len(shards), len(devices)))
        return real(plans, shards, devices)

    from imagepipe_tpu_torch.parallel import batch as tbatch

    monkeypatch.setattr(tbatch, "develop_batch_perimage_sp", counted)
    return calls


def _develop(numerics, raws, **kw):
    return _Port(numerics, max_batch=2, **kw).develop_sources(
        [TSource.from_raw(r) for r in raws])


def _assert_contract(got, want):
    maxd, frac = kdev.compare(got, want)
    assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)


# -- bit-equal to spatial=1 ---------------------------------------------------

# (generator, width, height, numerics, bits, orientation, crops (t, r, b, l),
#  devices, spatial, maxwidth, executor, want dem_path)
CASES = {
    "bayer-lut-odd": ("synthetic_bayer", 301, 40, "lut", 8, None, None, 2, 2, 0, "auto",
                      "full"),
    "bayer-direct-16-rot90-crop": ("synthetic_bayer", 300, 42, "direct", 16, "Rotate90",
                                   (3, 5, 2, 11), 3, 3, 0, "eager", "full"),
    "xtrans-lut-transverse-dpsp": ("synthetic_xtrans", 300, 36, "lut", 8, "Transverse", None,
                                   4, 2, 0, "auto", "full"),
    "xtrans-direct-16-odd": ("synthetic_xtrans", 389, 30, "direct", 16, None, None, 4, 4, 0,
                             "eager", "full"),
    "mono-lut-16-rot90": ("synthetic_mono", 301, 30, "lut", 16, "Rotate90", None, 2, 2, 0,
                          "auto", "full"),
    "mono-direct-transverse-crop": ("synthetic_mono", 290, 30, "direct", 8, "Transverse",
                                    (1, 4, 3, 6), 3, 3, 0, "eager", "full"),
    "rgb-lut-dpsp": ("synthetic_linear", 301, 30, "lut", 8, None, None, 4, 2, 0, "auto",
                     "full"),
    "rgb-direct-16-rot90": ("synthetic_linear", 260, 30, "direct", 16, "Rotate90", None, 2, 2,
                            0, "auto", "full"),
    "bayer-narrow": ("synthetic_bayer", 97, 30, "lut", 8, "Rotate90", None, 3, 3, 0, "auto",
                     "full"),
    "bayer-fulldown": ("synthetic_bayer", 400, 40, "lut", 8, None, None, 3, 3, 260, "auto",
                       "fulldown"),
    "xtrans-fulldown-16-transverse": ("synthetic_xtrans", 401, 42, "direct", 16, "Transverse",
                                      None, 2, 2, 30, "auto", "fulldown"),
    "bayer-scaled-lut": ("synthetic_bayer", 601, 40, "lut", 8, "Rotate90", None, 2, 2, 15,
                         "auto", "scaled"),
    "bayer-scaled-eager-direct": ("synthetic_bayer", 602, 44, "direct", 16, None, (2, 3, 4, 5),
                                  4, 2, 150, "eager", "scaled"),
    "xtrans-scaled-lut": ("synthetic_xtrans", 900, 36, "lut", 8, None, None, 3, 3, 300, "auto",
                          "scaled"),
    "mono-plaindown": ("synthetic_mono", 401, 40, "lut", 16, "Transverse", None, 2, 2, 30,
                       "auto", "plaindown"),
    "rgb-plaindown-direct": ("synthetic_linear", 403, 41, "direct", 8, "Rotate90", None, 3, 3,
                             30, "auto", "plaindown"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eager_sp_bit_equal_to_unsharded(monkeypatch, case):
    (make, width, height, numerics, bits, orientation, crops, ndev, spatial, maxwidth,
     executor, dem_path) = CASES[case]
    raws = _raws(traw, make, width, height, (3, 4, 5), orientation, crops)
    calls = _counting(monkeypatch)
    kw = dict(out_bits=bits, maxwidth=maxwidth, executor=executor)
    eng = _Port(numerics, devices=["cpu"] * ndev, spatial=spatial, max_batch=2, **kw)
    plan = eng._plan_for(TSource.from_raw(raws[0]))
    assert (plan.dem_path, plan.numerics) == (dem_path, numerics)
    assert eng._sharded(plan) and not eng._use_kernel(plan)
    outs = eng.develop_sources([TSource.from_raw(r) for r in raws])
    shards = len(tengine.sp_spans(plan, spatial))
    assert calls == [(2, shards, spatial), (1, shards, spatial)]
    flat = _develop(numerics, raws, devices=["cpu"], **kw)
    for out, want in zip(outs, flat):
        assert out.dtype == (np.uint8 if bits == 8 else np.uint16)
        np.testing.assert_array_equal(out, want)
    assert not np.array_equal(outs[0], outs[1])


def test_scaled_kernel_plans_develop_whole(monkeypatch):
    """'scaled' plans the scaled kernel takes keep `develop_scaled_batch`
    whole on the row's first device; the same plans in 'lut' numerics, or
    under executor='eager', are width-sharded."""
    raw = traw.synthetic_bayer(600, 40, seed=2)
    src = TSource.from_raw(raw)
    direct = _Port("direct", devices=["cpu"] * 2, spatial=2, maxwidth=150)
    plan = direct._plan_for(src)
    assert plan.dem_path == "scaled" and kds.scaled_supported(plan)
    assert direct._use_kernel(plan) and not direct._sharded(plan)
    for eng in (_Port("lut", devices=["cpu"] * 2, spatial=2, maxwidth=150),
                _Port("direct", devices=["cpu"] * 2, spatial=2, maxwidth=150,
                      executor="eager")):
        assert eng._sharded(eng._plan_for(src))
    calls = _counting(monkeypatch)
    direct.develop_sources([src])
    assert calls == []


# -- the resize shards' source spans ------------------------------------------

@pytest.mark.parametrize("geometry", [(400, 40, 260, 3), (601, 40, 150, 2), (900, 36, 300, 3),
                                      (6000, 8, 1024, 4), (1000, 8, 999, 2), (300, 320, 1, 2)])
def test_resize_spans_cover_every_window(geometry):
    """Each shard's span holds every column its output columns read (their
    windows from_x .. to_x and the clamped walk to from_x + k_x - 1); the
    output columns are cut without gap or overlap."""
    width, height, dem_w, spatial = geometry
    raw = traw.synthetic_bayer(width, height, seed=0)
    pipe = tip.Pipeline.new_from_source(TSource.from_raw(raw), device="cpu")
    pipe.globals.settings.maxwidth = dem_w
    plan = tengine.make_develop_plan(pipe, numerics="lut")
    assert plan.dem_path != "full"
    g = tscaling.scale_down_axes(plan.width, plan.height, plan.dem_w, plan.dem_h)
    spans = tengine.sp_spans(plan, spatial)
    assert [o0 for o0, _, _, _ in spans] == list(np.cumsum([0] + [n for _, n, _, _ in spans])[:-1])
    assert sum(n for _, n, _, _ in spans) == plan.dem_w
    for o0, n, x0, w in spans:
        fx, tx = g.from_x[o0:o0 + n], g.to_x[o0:o0 + n]
        assert x0 <= fx.min() and tx.max() < x0 + w
        assert np.minimum(fx + g.k_x - 1, plan.width - 1).max() < x0 + w <= plan.width


# -- against the JAX package's dp x sp engine --------------------------------

# (generator, width, height, numerics, bits, orientation, maxwidth)
JAX_CASES = {
    "bayer-lut": ("synthetic_bayer", 300, 40, "lut", 8, None, 0),
    "xtrans-direct-16": ("synthetic_xtrans", 300, 36, "direct", 16, None, 0),
    "mono-lut-rot90": ("synthetic_mono", 290, 30, "lut", 8, "Rotate90", 0),
    "rgb-lut": ("synthetic_linear", 260, 30, "lut", 8, "Transverse", 0),
    "bayer-fulldown": ("synthetic_bayer", 400, 40, "lut", 8, None, 260),
    "bayer-scaled-eager": ("synthetic_bayer", 600, 40, "lut", 8, "Rotate90", 15),
    "mono-plaindown-16": ("synthetic_mono", 400, 40, "lut", 16, None, 270),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_eager_sp_matches_jax_dp_sp(case):
    make, width, height, numerics, bits, orientation, maxwidth = JAX_CASES[case]
    assert width % 2 == 0                      # the JAX sp route's own limit
    seeds = (11, 12, 13)
    kw = dict(out_bits=bits, maxwidth=maxwidth)
    outs = _Port(numerics, devices=["cpu"] * 4, spatial=2, max_batch=2, **kw).develop_sources(
        [TSource.from_raw(r) for r in _raws(traw, make, width, height, seeds, orientation)])
    jeng = _Jax(jax_mesh(spatial=2), numerics, max_batch=2, executor="xla", **kw)
    jouts = jeng.develop_sources(
        [JSource.from_raw(r) for r in _raws(jraw, make, width, height, seeds, orientation)])
    for out, jout in zip(outs, jouts):
        assert out.shape == np.asarray(jout).shape
        _assert_contract(out, np.asarray(jout))


@pytest.mark.parametrize("orientation", ["Rotate90", "Transverse"])
def test_eager_sp_16bit_transposed_matches_jax_staged(orientation):
    """16 bits with a transposing orientation, the frame of ROADMAP "Known":
    held to the JAX staged path (a cache forces it), not to the JAX fused
    engine, which misses its own staged path there."""
    make = lambda m: _raws(m, "synthetic_bayer", 40, 64, (250, 251), orientation)  # noqa: E731
    outs = _Port("lut", devices=["cpu"] * 2, spatial=2, out_bits=16).develop_sources(
        [TSource.from_raw(r) for r in make(traw)])
    for out, r in zip(outs, make(jraw)):
        pipe = JPipeline.new_from_source(JSource.from_raw(r))
        want = np.asarray(pipe.output_16bit(JCache(1 << 28)).data)
        _assert_contract(out, want)


# -- shard_batch ----------------------------------------------------------------

@pytest.mark.parametrize("shape,spatial,rows", [((4, 6, 512), 2, 2), ((4, 5, 256, 3), 2, 2),
                                                ((8, 3, 384), 3, 1)])
def test_shard_batch_matches_jax(shape, spatial, rows):
    """Where B divides over the rows and W into whole 128-column shards the
    pieces are the JAX package's addressable shards, row by row."""
    a = np.random.default_rng(5).integers(0, 4096, shape).astype(np.uint16)
    grid = make_batch_mesh(["cpu"] * (rows * spatial), spatial)
    pieces = shard_batch(grid, a)
    mesh = jax_mesh(jax.devices()[:rows * spatial], spatial=spatial)
    jshards = {(s.index[0].start or 0, s.index[2].start or 0): np.asarray(s.data)
               for s in jax_shard_batch(mesh, a).addressable_shards}
    assert len(jshards) == rows * spatial
    for row in pieces:
        assert len(row) == spatial
        for piece in row:
            assert piece.device.type == "cpu" and piece.is_contiguous()
    block, cols = shape[0] // rows, tengine.sp_shards(shape[2], spatial)
    for r, row in enumerate(pieces):
        for (x, _), piece in zip(cols, row):
            np.testing.assert_array_equal(piece.numpy(), jshards[(r * block, x)])


@pytest.mark.parametrize("shape,spatial,rows", [((5, 4, 301), 2, 2), ((3, 4, 97, 3), 3, 2),
                                                ((1, 2, 130), 2, 3)])
def test_shard_batch_concatenates_back(shape, spatial, rows):
    """Any B and W: contiguous batch blocks of ceil(B / rows), columns by
    `sp_shards` (fewer pieces than devices for a narrow W, empty blocks for
    rows past the batch); the pieces concatenate back to the input."""
    a = torch.from_numpy(np.random.default_rng(6).random(shape, dtype=np.float32))
    pieces = shard_batch(make_batch_mesh(["cpu"] * (rows * spatial), spatial), a)
    assert len(pieces) == rows
    block = -(-shape[0] // rows)
    cols = tengine.sp_shards(shape[2], spatial)
    for r, row in enumerate(pieces):
        assert len(row) == len(cols)
        assert all(p.shape[0] == max(0, min(block, shape[0] - r * block)) for p in row)
    joined = torch.cat([torch.cat(row, dim=2) for row in pieces], dim=0)
    assert torch.equal(joined, a)


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("maxwidth", [0, 150])
def test_eager_sp_on_card_bit_equal_and_launches_nothing(maxwidth):
    """Two shards on one card (the one-card form), executor='eager': bit-equal
    to spatial=1 on the card, and no kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sharded eager route on the card")
    raws = _raws(traw, "synthetic_xtrans", 601, 48, (1, 2, 3), "Rotate90")
    counters = lambda: (kdev.LAUNCHES, kdev.BATCH_LAUNCHES, kdev.SP_LAUNCHES,  # noqa: E731
                        kds.LAUNCHES, kds.BATCH_LAUNCHES, krot.LAUNCHES, krot.CFA_LAUNCHES,
                        ksuf.LAUNCHES)
    before = counters()
    kw = dict(executor="eager", maxwidth=maxwidth, max_batch=2)
    outs = BatchEngine(devices=["cuda:0"] * 2, spatial=2, **kw).develop_sources(
        [TSource.from_raw(r) for r in raws])
    flat = BatchEngine(devices=["cuda:0"], **kw).develop_sources(
        [TSource.from_raw(r) for r in raws])
    assert counters() == before
    for out, want in zip(outs, flat):
        np.testing.assert_array_equal(out, want)
