"""PyTorch port: the rotate kernel's staged route (csrc/rotate.cu,
kernels/rotate.py::rotate_tile_plan) on the CPU.

The kernel cannot run here, so these tests hold what it relies on:

  (a) tile boxes: the plan's box of each tile (from its band tables, one
      float32 add of a row and a column band term, then sat/floor) equals
      the min and max over every pixel of the tile of the per-pixel window
      indices, bit for bit, and covers every index the plain version reads
      (clamped ones included); its empty flag is the per-pixel max `to` <
      min `from`, and every window of an empty tile is empty. The six CASES
      of test_torch_rotate.py, a seeded random sweep and the host tables of
      the three 24 MP geometries of chip_smoke.py;
  (b) the kernel's schedule, emulated in vectorised torch: the tight walk
      (ky < min(K_y, to_y - from_y + 1), kx likewise) where the tile's box
      is all finite, the full K_y x K_x walk where it is not, empty tiles
      as zeros, dy^2 once per window row. It equals the plain
      version `rotate_resample_plain` exactly (atol 0, same NaN pattern) on
      finite sources and on sources with NaN and +-Inf planted where the
      full walk reads them with weight 0 only (skipped by the tight walk),
      inside windows with a positive weight, and inside windows where every
      weight is 0. Finite cases also hold the JAX package's
      `_transform_impl`: 2e-6 jitted, bit-equal under jax.disable_jit;
  (c) routes: staged for the 24 MP geometries and a x2 downscale, within
      227 KB of shared memory; direct for a x8 rotated downscale (its
      block's two box buffers over the budget) and for the degenerate
      geometries whose tables hold a non-finite value.

The `cuda`-marked cases compare the kernel with the plain version on the
card for non-finite sources and direct-route geometries, and count routes.
"""

import jax
import numpy as np
import pytest
import torch

from imagepipe_tpu_torch import scaling as tscaling
from imagepipe_tpu_torch.kernels import rotate as krot
from imagepipe_tpu_torch.ops.rotatecrop import OpRotateCrop
from imagepipe_tpu_torch.scaling import rotated_geometry, sat_floor_np
from test_torch_rotate import CASE_IDS, CASES, DEGENERATE, _corners, _gather

torch.set_num_threads(1)

ATOL = 2e-6
BAYER = (6000, 4000)
# chip_smoke.ROTATE_CASES: (rotation, crop_left) of rotatecrop on a 24 MP frame.
ROTATE_24MP = {"0.05 crop 0.05": (0.05, 0.05), "0.1 crop 0.05": (0.1, 0.05),
               "45 deg": (0.5, 0.0)}


def _rotatecrop(rotation, crop_left, width, height):
    op = OpRotateCrop()
    op.rotation, op.crop_left = rotation, crop_left
    return op.geometry(width, height)


def _geometry(w, h, tl, tr, bl, nw, nh):
    return rotated_geometry(w, h, tl, tr, bl, nw, nh)


# -- (a) tile boxes ----------------------------------------------------------

def _check_boxes(g, height, width, plan, chunk_bands=16):
    """Per-pixel windows reduced over each tile, in chunks of row bands,
    against the tile boxes and empty flags the kernel derives from the
    plan's band tables; the plan's shared memory holds every box."""
    th, tw = plan.tile_h, krot.TILE_W
    nh, nw = g.rows.shape[1], g.cols.shape[1]
    nrb, ncb = -(-nh // th), -(-nw // tw)
    boxes, empty_tiles = krot.tile_boxes(plan, g, height, width)
    y0, y1, x0, x1 = boxes
    assert (y1 - y0 + 1).max() <= plan.box_bound[0] and (x1 - x0 + 1).max() <= plan.box_bound[1]
    for b0 in range(0, nrb, chunk_bands):
        r0, r1 = b0 * th, min(nh, (b0 + chunk_bands) * th)

        def px(i, maxv):
            with np.errstate(over="ignore"):
                s = g.rows[i, r0:r1, None] + g.cols[i, None, :]
            return sat_floor_np(s, maxv, np.int32)

        fy, ty = px(0, height - 1), px(1, height - 1)
        fx, tx = px(2, width - 1), px(3, width - 1)
        nb = -(-(r1 - r0) // th)

        def tiles(a, fn):
            a = np.pad(a, ((0, nb * th - a.shape[0]), (0, ncb * tw - nw)), mode="edge")
            return fn(a.reshape(nb, th, ncb, tw), axis=(1, 3))

        sl = slice(b0, b0 + nb)
        np.testing.assert_array_equal(tiles(fy, np.min), y0[sl])
        np.testing.assert_array_equal(tiles(fx, np.min), x0[sl])
        np.testing.assert_array_equal(
            np.minimum(tiles(fy, np.max) + g.k_y - 1, height - 1), y1[sl])
        np.testing.assert_array_equal(
            np.minimum(tiles(fx, np.max) + g.k_x - 1, width - 1), x1[sl])
        empty = (tiles(ty, np.max) < tiles(fy, np.min)) | (tiles(tx, np.max) < tiles(fx, np.min))
        np.testing.assert_array_equal(empty, empty_tiles[sl])

        # Every index the plain version reads lies in its tile's box, and
        # every window of an empty tile is empty.
        box = [np.repeat(np.repeat(a[sl], th, axis=0)[:r1 - r0], tw, axis=1)[:, :nw]
               for a in boxes]
        assert (fy >= box[0]).all() and (np.minimum(fy + g.k_y - 1, height - 1) <= box[1]).all()
        assert (fx >= box[2]).all() and (np.minimum(fx + g.k_x - 1, width - 1) <= box[3]).all()
        if empty_tiles[sl].any():
            in_empty = np.repeat(np.repeat(empty_tiles[sl], th, axis=0)[:r1 - r0], tw,
                                 axis=1)[:, :nw]
            assert ((ty < fy) | (tx < fx))[in_empty].all()


@pytest.mark.parametrize("theta,w,h,nw,nh,sc,C", CASES, ids=CASE_IDS)
def test_tile_boxes_equal_per_pixel_min_max(theta, w, h, nw, nh, sc, C):
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    g = _geometry(w, h, tl, tr, bl, nw, nh)
    for tile_h in (8, 32):
        plan = krot.rotate_tile_plan(g, C, h, w, tile_h)
        assert plan.route == "staged", plan.reason
        _check_boxes(g, h, w, plan)


# A mirrored, sheared geometry with whole tiles of empty windows at tile
# height 8. Such tiles are rare: the 75-degree case of CASES has 68% of its
# windows empty but no empty tile, since `from` spreads over a tile further
# than a window inverts (one of 300 geometries of a random sweep has one).
EMPTY_TILES = (80, 111, (95, 71), (35, 128), (88, 78), 98, 17)


def test_empty_tiles():
    w, h, tl, tr, bl, nw, nh = EMPTY_TILES
    g = _geometry(w, h, tl, tr, bl, nw, nh)
    plan = krot.rotate_tile_plan(g, 3, h, w, 8)
    empty = krot.tile_boxes(plan, g, h, w)[1]
    assert plan.route == "staged" and empty.any() and not empty.all()
    _check_boxes(g, h, w, plan)
    src = _source(8, 3, h, w)
    src[:, ::5, ::3] = float("nan")              # inside the empty tiles' boxes too
    got, _ = _emulate(src, w, h, tl, tr, bl, nw, nh, 8)
    _assert_bit_equal(got, krot.rotate_resample_plain(src, w, h, tl, tr, bl, nw, nh, 3))


@pytest.mark.parametrize("chunk", range(3))
def test_tile_boxes_random_sweep(chunk):
    """Random corner triples (shears, mirrored axes, corners outside)."""
    rng = np.random.default_rng(200 + chunk)
    for _ in range(8):
        w, h = int(rng.integers(40, 160)), int(rng.integers(40, 160))
        nw, nh = int(rng.integers(2, 150)), int(rng.integers(2, 150))
        tl = (int(rng.integers(-30, w + 30)), int(rng.integers(-30, h + 30)))
        tr = (tl[0] + int(rng.integers(-w, w)), tl[1] + int(rng.integers(-h, h)))
        bl = (tl[0] + int(rng.integers(-w, w)), tl[1] + int(rng.integers(-h, h)))
        g = _geometry(w, h, tl, tr, bl, nw, nh)
        plan = krot.rotate_tile_plan(g, 3, h, w, int(rng.choice([8, 16, 32])))
        assert plan.row_bands is not None
        _check_boxes(g, h, w, plan)


@pytest.mark.parametrize("case", list(ROTATE_24MP))
def test_tile_boxes_24mp_host_tables(case):
    w, h = BAYER
    tl, tr, bl, nw, nh = _rotatecrop(*ROTATE_24MP[case], w, h)
    g = _geometry(w, h, tl, tr, bl, nw, nh)
    plan = krot.rotate_tile_plan(g, 4, h, w)
    assert plan.route == "staged" and not krot.tile_boxes(plan, g, h, w)[1].any()
    _check_boxes(g, h, w, plan, chunk_bands=8)


def test_band_tables_are_band_min_max():
    theta, w, h, nw, nh, sc, C = CASES[1]
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    g = _geometry(w, h, tl, tr, bl, nw, nh)
    plan = krot.rotate_tile_plan(g, C, h, w, 16)
    assert plan.row_bands.dtype == plan.col_bands.dtype == np.float32
    assert plan.row_bands.shape == (8, -(-nh // 16)) and plan.col_bands.shape == (8, -(-nw // 32))
    for b in range(plan.row_bands.shape[1]):
        part = g.rows[:4, b * 16:(b + 1) * 16]
        np.testing.assert_array_equal(plan.row_bands[:, b], np.concatenate([part.min(1),
                                                                            part.max(1)]))
    for b in range(plan.col_bands.shape[1]):
        part = g.cols[:4, b * 32:(b + 1) * 32]
        np.testing.assert_array_equal(plan.col_bands[:, b], np.concatenate([part.min(1),
                                                                            part.max(1)]))
    with pytest.raises(ValueError, match="multiple of 8"):
        krot.rotate_tile_plan(g, C, h, w, 12)


# -- (b) the kernel's schedule -----------------------------------------------

def _emulate(src, w, h, tl, tr, bl, nw, nh, tile_h):
    """csrc/rotate.cu's staged route in vectorised torch: per tile, the tight
    walk where its box is all finite, else the full walk; empty tiles 0;
    dy^2 once per window row. A sample the walk skips adds nothing."""
    f = torch.float32
    g = _geometry(w, h, tl, tr, bl, nw, nh)
    plan = krot.rotate_tile_plan(g, src.shape[0], h, w, tile_h)
    assert plan.route == "staged", plan.reason
    rows, cols = torch.from_numpy(g.rows), torch.from_numpy(g.cols)

    def pixel(i):
        return rows[i][:, None] + cols[i][None, :]

    fy, ty = tscaling._sat_idx(pixel(0), h - 1), tscaling._sat_idx(pixel(1), h - 1)
    fx, tx = tscaling._sat_idx(pixel(2), w - 1), tscaling._sat_idx(pixel(3), w - 1)
    cy, cx = pixel(4), pixel(5)
    sxx, syy = torch.tensor(float(g.sxx)), torch.tensor(float(g.syy))

    # The block-uniform flag: no non-finite value in the tile's box
    # (an integral image of non-finite counts).
    bad = (~torch.isfinite(src)).any(0).to(torch.int64)
    s = torch.zeros((h + 1, w + 1), dtype=torch.int64)
    s[1:, 1:] = bad.cumsum(0).cumsum(1)
    boxes, empty_tiles = krot.tile_boxes(plan, g, h, w)
    y0, y1, x0, x1 = (torch.from_numpy(a) for a in boxes)
    finite_tile = (s[y1 + 1, x1 + 1] - s[y0, x1 + 1] - s[y1 + 1, x0] + s[y0, x0]) == 0
    rt, ct = torch.arange(nh) // plan.tile_h, torch.arange(nw) // krot.TILE_W
    finite = finite_tile[rt][:, ct]
    empty = torch.from_numpy(empty_tiles)[rt][:, ct]
    ny = torch.where(finite, torch.clamp(torch.minimum(ty - fy + 1, torch.tensor(g.k_y)), min=0),
                     g.k_y)
    nx = torch.where(finite, torch.clamp(torch.minimum(tx - fx + 1, torch.tensor(g.k_x)), min=0),
                     g.k_x)

    flat = src.reshape(src.shape[0], -1)
    sums = torch.zeros((src.shape[0], nh, nw), dtype=f)
    count = torch.zeros((nh, nw), dtype=f)
    for ky in range(g.k_y):
        y = fy + ky
        valid_y = y <= ty
        yc = torch.clamp(y, max=h - 1)
        dy = (y.to(f) - cy) / syy
        dy2 = dy * dy
        for kx in range(g.k_x):
            x = fx + kx
            xc = torch.clamp(x, max=w - 1)
            dx = (x.to(f) - cx) / sxx
            wgt = (1.0 - dx * dx) - dy2
            wgt = torch.where(wgt < 0.0, 0.0, wgt)
            wgt = torch.where(valid_y & (x <= tx), wgt, 0.0)
            walked = (ky < ny) & (kx < nx)
            val = flat[:, yc * w + xc]
            sums = torch.where(walked, sums + val * wgt, sums)
            count = torch.where(walked, count + wgt, count)
    out = torch.where(count > 0.0, sums / count, 0.0)
    return torch.where(empty, 0.0, out), finite_tile


def _assert_bit_equal(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _source(seed, c, h, w):
    return torch.from_numpy(np.random.default_rng(seed).random((c, h, w), dtype=np.float32))


@pytest.mark.parametrize("theta,w,h,nw,nh,sc,C", CASES, ids=CASE_IDS)
def test_schedule_equals_plain_and_jax_on_finite_sources(theta, w, h, nw, nh, sc, C):
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    src = _source(theta * 17 + C, C, h, w)
    want = krot.rotate_resample_plain(src, w, h, tl, tr, bl, nw, nh, C)
    for tile_h in (8, 32):
        got, finite = _emulate(src, w, h, tl, tr, bl, nw, nh, tile_h)
        assert finite.all()
        _assert_bit_equal(got, want)
    jax_out = _gather(np.moveaxis(src.numpy(), 0, -1), w, h, tl, tr, bl, nw, nh, C)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 0, -1), jax_out, rtol=0, atol=ATOL)


def test_schedule_bit_equal_to_unjitted_jax():
    w, h, nw, nh = 60, 48, 56, 44
    tl, tr, bl = _corners(21, w, h, nw, nh, 1.1)
    src = _source(5, 4, h, w)
    got, _ = _emulate(src, w, h, tl, tr, bl, nw, nh, 8)
    with jax.disable_jit():
        want = _gather(np.moveaxis(src.numpy(), 0, -1), w, h, tl, tr, bl, nw, nh, 4)
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 0, -1), want)


def _read_positions(w, h, tl, tr, bl, nw, nh):
    """Flat source positions the full walk reads, split by what it reads
    them with: 'skipped' (only outside every window: the select's +0, and
    the tight walk never reads them), 'window' (inside a window with a
    positive weight) and 'zero weight' (inside windows, every weight 0)."""
    g = _geometry(w, h, tl, tr, bl, nw, nh)
    rows, cols = torch.from_numpy(g.rows), torch.from_numpy(g.cols)

    def pixel(i):
        return rows[i][:, None] + cols[i][None, :]

    fy, ty = tscaling._sat_idx(pixel(0), h - 1), tscaling._sat_idx(pixel(1), h - 1)
    fx, tx = tscaling._sat_idx(pixel(2), w - 1), tscaling._sat_idx(pixel(3), w - 1)
    cy, cx = pixel(4), pixel(5)
    read = torch.zeros(h * w, dtype=torch.bool)
    in_window = torch.zeros(h * w, dtype=torch.bool)
    positive = torch.zeros(h * w, dtype=torch.bool)
    for ky in range(g.k_y):
        for kx in range(g.k_x):
            y, x = fy + ky, fx + kx
            pos = (torch.clamp(y, max=h - 1) * w + torch.clamp(x, max=w - 1)).ravel()
            dx = (x.float() - cx) / float(g.sxx)
            dy = (y.float() - cy) / float(g.syy)
            wgt = ((1.0 - dx * dx) - dy * dy).ravel()
            inside = ((y <= ty) & (x <= tx)).ravel()
            read[pos] = True
            in_window[pos[inside]] = True
            positive[pos[inside & ~(wgt <= 0.0)]] = True
    return {"skipped": torch.nonzero(read & ~in_window).ravel(),
            "window": torch.nonzero(positive).ravel(),
            "zero weight": torch.nonzero(in_window & ~positive).ravel()}


NONFINITE_CASES = {
    # (theta, w, h, nw, nh, scale, C): the 45-degree case has every kind.
    "45deg": (45, 130, 130, 180, 180, 1.0, 4),
    "27deg": (27, 160, 140, 150, 130, 1.0, 3),
}


@pytest.mark.parametrize("kind", ["skipped", "window", "zero weight"])
@pytest.mark.parametrize("case", list(NONFINITE_CASES))
def test_schedule_equals_plain_on_nonfinite_sources(case, kind):
    theta, w, h, nw, nh, sc, C = NONFINITE_CASES[case]
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    positions = _read_positions(w, h, tl, tr, bl, nw, nh)[kind]
    assert positions.numel() >= 3, kind
    rng = np.random.default_rng(len(kind) + theta)
    src = _source(theta + 1, C, h, w)
    chosen = positions[torch.from_numpy(rng.choice(positions.numel(), 3, replace=False))]
    for value, pos in zip((float("nan"), float("inf"), float("-inf")), chosen):
        src.view(C, -1)[int(rng.integers(C)), pos] = value
    want = krot.rotate_resample_plain(src, w, h, tl, tr, bl, nw, nh, C)
    assert torch.isnan(want).any()
    for tile_h in (8, 32):
        got, finite = _emulate(src, w, h, tl, tr, bl, nw, nh, tile_h)
        assert not finite.all()
        _assert_bit_equal(got, want)


def test_tight_walk_alone_would_differ_on_skipped_nonfinite_values():
    """Why the flag exists: with NaN only where the full walk reads it with
    weight 0, the plain version gives NaN that a tight walk would miss. A
    tight walk never reads those positions, so on this source it gives what
    it gives on the finite one, which is the plain version's there."""
    theta, w, h, nw, nh, sc, C = NONFINITE_CASES["45deg"]
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    skipped = _read_positions(w, h, tl, tr, bl, nw, nh)["skipped"]
    finite_src = _source(3, C, h, w)
    src = finite_src.clone()
    src.view(C, -1)[:, skipped] = float("nan")
    want = krot.rotate_resample_plain(src, w, h, tl, tr, bl, nw, nh, C)
    tight = krot.rotate_resample_plain(finite_src, w, h, tl, tr, bl, nw, nh, C)
    assert torch.isnan(want).any() and not torch.isnan(tight).any()


# -- (c) routes ---------------------------------------------------------------

def _route_geometry(name):
    w, h = BAYER
    if name in ROTATE_24MP:
        return (w, h, *_rotatecrop(*ROTATE_24MP[name], w, h))
    tl, tr, bl, nw, nh = _rotatecrop(0.05, 0.05, w, h)
    if name == "x2 downscale":
        return (w, h, tl, tr, bl, nw // 2, nh // 2)
    if name == "x8 downscale":
        return (w, h, tl, tr, bl, nw // 8, nh // 8)
    return DEGENERATE[name]


ROUTES = {"0.05 crop 0.05": "staged", "0.1 crop 0.05": "staged", "45 deg": "staged",
          "x2 downscale": "staged", "x8 downscale": "direct", "nwidth 1": "direct",
          "nheight 1": "direct", "1x1": "direct"}


@pytest.mark.parametrize("name", list(ROUTES))
def test_plan_route(name):
    w, h, tl, tr, bl, nw, nh = _route_geometry(name)
    g = _geometry(w, h, tl, tr, bl, nw, nh)
    plan = krot.rotate_tile_plan(g, 4, h, w)
    assert plan.route == ROUTES[name], plan.reason
    finite = np.isfinite(g.rows).all() and np.isfinite(g.cols).all()
    if plan.route == "staged":
        assert 0 < plan.smem_bytes <= krot.STAGE_SMEM_BYTES <= 232448
        boxes = krot.tile_boxes(plan, g, h, w)[0]
        largest = int(((boxes[1] - boxes[0] + 1) * (boxes[3] - boxes[2] + 1)).max())
        # Two buffers of a box widened by up to 6 columns for 16-byte copies.
        widest = int((boxes[3] - boxes[2] + 1).max())
        assert plan.box_floats >= 4 * (boxes[1] - boxes[0] + 1).max() * (widest + 6)
        assert plan.box_floats >= 4 * largest and plan.box_floats % 4 == 0
        fixed = 4 * 2 * 6 * (plan.tile_h + krot.TILE_W)
        assert plan.smem_bytes == fixed + 8 * plan.box_floats
        assert plan.box_floats <= 1.3 * 4 * largest
    elif finite:      # x8: two box buffers too large for a block, at tile height 8
        assert plan.tile_h == 8 and plan.smem_bytes > krot.STAGE_SMEM_BYTES
    else:
        assert plan.row_bands is None and "non-finite" in plan.reason


def test_cpu_wrapper_counts_no_launch():
    w, h, nw, nh = 30, 20, 24, 18
    tl, tr, bl = _corners(10, w, h, nw, nh)
    src = _source(1, 4, h, w)
    before = (krot.LAUNCHES, krot.DIRECT_LAUNCHES)
    out = krot.rotate_resample_planar(src, w, h, tl, tr, bl, nw, nh, 4)
    assert (krot.LAUNCHES, krot.DIRECT_LAUNCHES) == before
    _assert_bit_equal(out, krot.rotate_resample_plain(src, w, h, tl, tr, bl, nw, nh, 4))


# -- (d) on the card -------------------------------------------------------------

CARD_SOURCES = ["skipped", "window", "zero weight"]


def _card_compare(src, w, h, tl, tr, bl, nw, nh, want_direct):
    C = src.shape[0]
    before, direct = krot.LAUNCHES, krot.DIRECT_LAUNCHES
    got = krot.rotate_resample_planar(src, w, h, tl, tr, bl, nw, nh, C)
    torch.cuda.synchronize()
    assert krot.LAUNCHES == before + 1 and krot.DIRECT_LAUNCHES == direct + want_direct
    want = krot.rotate_resample_plain(src, w, h, tl, tr, bl, nw, nh, C)
    assert got.shape == want.shape == (C, nh, nw)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got == 0, want == 0)
    assert float((got - want).abs().nan_to_num(0.0).max()) <= krot.MAX_ABS_DIFF


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CARD_SOURCES)
def test_kernel_matches_plain_on_nonfinite_sources(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    theta, w, h, nw, nh, sc, C = NONFINITE_CASES["45deg"]
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    positions = _read_positions(w, h, tl, tr, bl, nw, nh)[kind]
    src = _source(4, C, h, w)
    src.view(C, -1)[:, positions[::7]] = float("nan")
    src.view(C, -1)[1, positions[3::11]] = float("inf")
    src.view(C, -1)[2, positions[5::13]] = float("-inf")
    _card_compare(src.cuda(), w, h, tl, tr, bl, nw, nh, want_direct=0)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [301, 302, 304])
def test_kernel_matches_plain_at_any_row_alignment(width):
    """Widths that are not a multiple of 4 take the staged route's 4-byte
    copies, a multiple of 4 its 16-byte copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    h, nw, nh = 203, 311, 230
    tl, tr, bl = _corners(7, width, h, nw, nh)
    _card_compare(_source(7, 3, h, width).cuda(), width, h, tl, tr, bl, nw, nh, want_direct=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["x8 downscale", "nwidth 1", "1x1"])
def test_kernel_matches_plain_on_direct_route(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    if name == "x8 downscale":
        w, h, nw, nh = 640, 480, 80, 60
        tl, tr, bl = _corners(8, w, h, nw, nh, 8.0)
    else:
        w, h, tl, tr, bl, nw, nh = DEGENERATE[name]
    _card_compare(_source(6, 4, h, w).cuda(), w, h, tl, tr, bl, nw, nh, want_direct=1)
