"""PyTorch port: the CFA route's staged form (csrc/rotate.cu
`rotate_kernel_staged<1, true>`, chosen by kernels/rotate.py::
`rotate_tile_plan(g, 1, H, W, cfa=True)`) on the CPU.

The kernel cannot run here, so these tests hold what it relies on:

  (a) tile boxes: with the CFA route's plan (one plane, the pattern tile
      in shared memory) each tile's box from the band tables equals the min and max
      of the per-pixel window indices over the tile, bit for bit, covers
      every index the plain version reads, and its empty flag is exact
      (tests/test_torch_rotate_tiled.py's check); the plan's shared memory
      is two buffers of terms and values plus the pattern tile;
  (b) the kernel's schedule, emulated in vectorised torch: per tile the
      box origin (y0, xa, xa rounded down to a multiple of 4 where the
      16-byte copies apply), each sample's colour from the pattern tile at
      the box origin's phase plus the sample's offset in the box, and each
      pixel's walk read from the box:
      the tight walk (ky < min(K_y, to_y - from_y + 1), kx likewise) where
      the tile's box is all finite, else the full K_y x K_x walk with the
      select and the clamps; each walked sample adds val * w to its colour's
      sum and w to its count, and nothing to the others. It equals the
      plain version `rotate_resample_cfa_plain` exactly (atol 0, NaN at the
      same places) and the JAX package's jitted `_transform_impl` in CFA
      mode within 2e-6 (atol, rtol 0) with the same NaN and zero pattern,
      as tests/test_torch_rotate_cfa.py holds the plain version: RGGB and
      X-Trans rotated 0.05, 0.1 and 45 degrees as rotatecrop gives them, an
      odd-width source, a x2 rotated downscale; and NaN/+-Inf planted where
      only the full walk reads them (weight 0 outside every window), inside
      windows with a positive weight, and inside windows whose every weight
      is 0;
  (c) routes: staged for the three 24 MP geometries, the 5999 x 3999 stage
      and a x2 rotated downscale; direct for the outputs 1 wide and 1 high
      (non-finite tables) and a x8 and a x12 rotated downscale (a staged
      block over STAGE_SMEM_BYTES even at 8-row tiles);
  (d) the CPU wrapper takes the plain version and counts no launch;
  (e) the direct form's rule that a pixel whose centre cy or cx is NaN
      writes zeros without a walk: every pixel of an output 1 wide or high
      has one (chip_smoke.py phase 2f's launch among them), no pixel of a
      staged geometry has one, and on such outputs the plain version and
      the JAX package's `_transform_impl` give +0 everywhere, NaN and
      +-Inf in the source or not (exact: atol 0, no -0).

The `cuda`-marked cases hold the kernel to its plain version on the card,
bit for bit, in both forms, at source widths 301, 302 and 304, and the
stores probe to writing every output.
"""

import dataclasses


import numpy as np
import pytest
import torch

from imagepipe_tpu_torch import scaling as tscaling
from imagepipe_tpu_torch.kernels import rotate as krot
from imagepipe_tpu_torch.raw import CFA, PATTERN_TILE
from imagepipe_tpu_torch.scaling import rotated_geometry, sat_floor_np
from test_torch_rotate import _corners
from test_torch_rotate_cfa import XTRANS, _gather, _plane
from test_torch_rotate_tiled import _assert_bit_equal, _read_positions, _rotatecrop

torch.set_num_threads(1)

ATOL = 2e-6
BAYER = (6000, 4000)

# name: (cfa, width, height, topleft, topright, bottomleft, nwidth, nheight)
def _rc_case(cfa, rotation, crop_left, w, h, down=1):
    tl, tr, bl, nw, nh = _rotatecrop(rotation, crop_left, w, h)
    return (cfa, w, h, tl, tr, bl, nw // down, nh // down)


CASES = {
    "rggb 0.05 crop 0.05": _rc_case("RGGB", 0.05, 0.05, 200, 140),
    "rggb 0.1 crop 0.05": _rc_case("RGGB", 0.1, 0.05, 200, 140),
    "rggb 45 deg": _rc_case("RGGB", 0.5, 0.0, 120, 120),
    "x-trans 0.05 crop 0.05": _rc_case(XTRANS, 0.05, 0.05, 192, 144),
    "x-trans 0.1 crop 0.05": _rc_case(XTRANS, 0.1, 0.05, 192, 144),
    "x-trans 45 deg": _rc_case(XTRANS, 0.5, 0.0, 120, 120),
    "rggb odd width": _rc_case("RGGB", 0.05, 0.05, 201, 139),
    "x-trans x2 rotated downscale": _rc_case(XTRANS, 0.05, 0.05, 240, 160, down=2),
}


def _geometry(case):
    _, w, h, tl, tr, bl, nw, nh = case
    return rotated_geometry(w, h, tl, tr, bl, nw, nh)


# -- (a) tile boxes and shared memory ------------------------------------------

def _check_boxes_any_layout(g, h, w, plan, tile_cols=krot.CFA_TILE_COLS):
    """Each tile's box and empty flag from the band tables against the
    per-pixel window indices over its pixels (tile_h rows by tile_cols
    columns): bit-equal min and max, so every index the plain version reads
    lies inside."""
    nh, nw = g.rows.shape[1], g.cols.shape[1]
    with np.errstate(over="ignore"):
        def px(i, maxv):
            return sat_floor_np(g.rows[i][:, None] + g.cols[i][None, :], maxv, np.int32)
        fy, ty, fx, tx = px(0, h - 1), px(1, h - 1), px(2, w - 1), px(3, w - 1)
    (y0, y1, x0, x1), empty = krot.tile_boxes(plan, g, h, w)
    for tr in range(-(-nh // plan.tile_h)):
        rows = slice(tr * plan.tile_h, (tr + 1) * plan.tile_h)
        assert plan.col_bands.shape[1] == -(-nw // tile_cols)
        for tc in range(plan.col_bands.shape[1]):
            t = (rows, slice(tc * tile_cols, (tc + 1) * tile_cols))
            assert y0[tr, tc] == fy[t].min() and x0[tr, tc] == fx[t].min()
            assert y1[tr, tc] == min(fy[t].max() + g.k_y - 1, h - 1)
            assert x1[tr, tc] == min(fx[t].max() + g.k_x - 1, w - 1)
            assert empty[tr, tc] == ((ty[t].max() < fy[t].min()) | (tx[t].max() < fx[t].min()))


@pytest.mark.parametrize("name", ["rggb 0.05 crop 0.05", "x-trans 45 deg", "rggb odd width",
                                  "x-trans x2 rotated downscale"])
def test_tile_boxes_equal_per_pixel_min_max(name):
    case = CASES[name]
    _, w, h, *_ = case
    g = _geometry(case)
    for tile_h in (8, 32):
        plan = krot.rotate_tile_plan(g, 1, h, w, tile_h, cfa=True)
        assert plan.route == "staged", plan.reason
        _check_boxes_any_layout(g, h, w, plan)


def test_plan_tiles_and_shared_memory():
    """The CFA plan at the 24 MP geometries: tiles of CFA_TILE_COLS columns
    by TILE_H rows, each column band the min and max of cols[0..3] over
    its columns, and a block of two buffers of terms and one box plus the
    pattern tile, within STAGE_SMEM_BYTES."""
    w, h = BAYER
    for rotation, crop in ((0.05, 0.05), (0.1, 0.05), (0.5, 0.0)):
        tl, tr, bl, nw, nh = _rotatecrop(rotation, crop, w, h)
        g = rotated_geometry(w, h, tl, tr, bl, nw, nh)
        plan = krot.rotate_tile_plan(g, 1, h, w, cfa=True)
        tc = krot.CFA_TILE_COLS
        assert plan.route == "staged" and plan.tile_h == krot.TILE_H
        assert plan.col_bands.shape == (8, -(-nw // tc))
        for j in (0, 1, plan.col_bands.shape[1] - 1):
            part = g.cols[:4, j * tc:(j + 1) * tc]
            np.testing.assert_array_equal(plan.col_bands[:, j],
                                          np.concatenate([part.min(1), part.max(1)]))
        assert plan.box_floats == -(-plan.box_bound[0] * (plan.box_bound[1] + 6) // 4) * 4
        assert plan.smem_bytes == (4 * 2 * (6 * (plan.tile_h + tc) + plan.box_floats)
                                   + PATTERN_TILE * PATTERN_TILE) <= krot.STAGE_SMEM_BYTES
        # The per-channel route keeps its 32-column tiles.
        assert krot.rotate_tile_plan(g, 4, h, w).col_bands.shape == (8, -(-nw // krot.TILE_W))


# -- (b) the kernel's schedule ---------------------------------------------------

def _emulate(src, case, tile_h):
    """The staged CFA form in vectorised torch; returns (out [4, nh, nw],
    finite flag per tile). `src` [1, H, W] is taken as 16-byte aligned, so
    a width that is a multiple of 4 takes the 16-byte copies."""
    name, w, h, tl, tr, bl, nw, nh = case
    f = torch.float32
    g = _geometry(case)
    plan = krot.rotate_tile_plan(g, 1, h, w, tile_h, cfa=True)
    assert plan.route == "staged", plan.reason
    rows, cols = torch.from_numpy(g.rows), torch.from_numpy(g.cols)

    def pixel(i):
        return rows[i][:, None] + cols[i][None, :]

    fy, ty = tscaling._sat_idx(pixel(0), h - 1), tscaling._sat_idx(pixel(1), h - 1)
    fx, tx = tscaling._sat_idx(pixel(2), w - 1), tscaling._sat_idx(pixel(3), w - 1)
    cy, cx = pixel(4), pixel(5)
    sxx, syy = torch.tensor(float(g.sxx)), torch.tensor(float(g.syy))

    boxes, empty_tiles = krot.tile_boxes(plan, g, h, w)
    y0, y1, x0, x1 = (torch.from_numpy(a) for a in boxes)
    vec4 = w % 4 == 0
    xa = x0 & ~3 if vec4 else x0
    bw = ((x1 + 4 - xa) & ~3) if vec4 else x1 + 1 - x0
    bh = y1 - y0 + 1
    # The block-uniform flag over the staged box, widened columns included.
    bad = (~torch.isfinite(src[0])).to(torch.int64)
    s = torch.zeros((h + 1, w + 1), dtype=torch.int64)
    s[1:, 1:] = bad.cumsum(0).cumsum(1)
    xe = torch.clamp(xa + bw, max=w)
    finite_tile = (s[y1 + 1, xe] - s[y0, xe] - s[y1 + 1, xa] + s[y0, xa]) == 0
    empty_tiles = torch.from_numpy(empty_tiles)

    rt = torch.arange(nh) // plan.tile_h
    ct = torch.arange(nw) // krot.CFA_TILE_COLS

    def at(a):
        return a[rt][:, ct]

    pattern = torch.from_numpy(CFA(name).pattern_tile().astype(np.int64))
    nt = pattern.shape[0]
    finite, empty = at(finite_tile), at(empty_tiles)
    py0, pxa, pbh, pbw = at(y0), at(xa), at(bh), at(bw)
    ny = torch.where(finite, torch.clamp(torch.minimum(ty - fy + 1, torch.tensor(g.k_y)), min=0),
                     g.k_y)
    nx = torch.where(finite, torch.clamp(torch.minimum(tx - fx + 1, torch.tensor(g.k_x)), min=0),
                     g.k_x)

    flat = src.reshape(-1)
    sums = torch.zeros((4, nh, nw), dtype=f)
    counts = torch.zeros((4, nh, nw), dtype=f)
    for ky in range(g.k_y):
        y = fy + ky
        yc = torch.clamp(y, max=h - 1)
        dy = (y.to(f) - cy) / syy
        dy2 = dy * dy
        for kx in range(g.k_x):
            x = fx + kx
            xc = torch.clamp(x, max=w - 1)
            dx = (x.to(f) - cx) / sxx
            wgt = (1.0 - dx * dx) - dy2
            wgt = torch.where(wgt < 0.0, 0.0, wgt)
            wgt = torch.where((y <= ty) & (x <= tx), wgt, 0.0)
            val = flat[yc * w + xc] * wgt
            walked = (ky < ny) & (kx < nx) & ~empty
            # The sample's box index, and its colour at the box origin's
            # pattern row and column plus that offset.
            yy, xx = yc - py0, xc - pxa
            assert ((yy >= 0) & (yy < pbh) & (xx >= 0) & (xx < pbw))[walked].all()
            colour = pattern[(py0 % nt + yy) % nt, (pxa % nt + xx) % nt]
            for c in range(4):
                add = walked & (colour == c)
                sums[c] = torch.where(add, sums[c] + val, sums[c])
                counts[c] = torch.where(add, counts[c] + wgt, counts[c])
    return torch.where(counts > 0.0, sums / counts, 0.0), finite_tile


def _run(data, case):
    """(emulation at tile heights 8 and 32, the plain version) on plane `data`."""
    name, w, h, tl, tr, bl, nw, nh = case
    src = torch.from_numpy(data)[None]
    want = krot.rotate_resample_cfa_plain(src, w, h, tl, tr, bl, nw, nh, CFA(name))
    return [_emulate(src, case, th) for th in (8, 32)], want


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_equals_plain_and_jax(name):
    case = CASES[name]
    data = _plane(len(name), case[2], case[1])
    runs, want = _run(data, case)
    for got, finite in runs:
        assert finite.all()
        _assert_bit_equal(got, want)
    jax_out = _gather(data, case)
    got = np.moveaxis(runs[-1][0].numpy(), 0, -1)
    assert got.shape == jax_out.shape == (case[7], case[6], 4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jax_out))
    np.testing.assert_array_equal(got == 0, jax_out == 0)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=ATOL)


# Geometries with samples of every kind (tests/test_torch_rotate_tiled.py's
# NONFINITE_CASES): half the 45-degree output lies outside the source.
NONFINITE = {"rggb 45 deg, corners outside": ("RGGB", 130, 130, *_corners(45, 130, 130, 180, 180),
                                              180, 180),
             "x-trans 27 deg": (XTRANS, 160, 140, *_corners(27, 160, 140, 150, 130), 150, 130)}


@pytest.mark.parametrize("kind", ["skipped", "window", "zero weight"])
@pytest.mark.parametrize("name", list(NONFINITE))
def test_schedule_equals_plain_on_nonfinite_sources(name, kind):
    """NaN, +Inf and -Inf where the full walk reads them with weight 0 only
    (outside every window: the tight walk never reads them, so the flag
    must send their tiles to the full walk), inside windows with a positive
    weight, and inside windows whose every weight is 0."""
    case = NONFINITE[name]
    _, w, h, tl, tr, bl, nw, nh = case
    positions = _read_positions(w, h, tl, tr, bl, nw, nh)[kind]
    assert positions.numel() >= 3, kind
    rng = np.random.default_rng(len(kind) + len(name))
    data = _plane(9, h, w)
    chosen = positions[torch.from_numpy(rng.choice(positions.numel(), 3, replace=False))]
    for value, pos in zip((np.nan, np.inf, -np.inf), chosen.tolist()):
        data.reshape(-1)[pos] = value
    runs, want = _run(data, case)
    assert torch.isnan(want).any()
    for got, finite in runs:
        assert not finite.all()
        _assert_bit_equal(got, want)
    jax_out = _gather(data, case)
    got = np.moveaxis(runs[-1][0].numpy(), 0, -1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jax_out))
    np.testing.assert_array_equal(got == 0, jax_out == 0)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=ATOL)


# -- (c) routes --------------------------------------------------------------------

def _route_case(name):
    w, h = BAYER
    if name == "5999x3999 0.05 crop 0.05":
        return ("RGGB", w - 1, h - 1, *_rotatecrop(0.05, 0.05, w - 1, h - 1))
    if name.startswith("x") and "downscale" in name:
        factor = int(name[1:name.index(" ")])
        return _rc_case("RGGB", 0.05, 0.05, w, h, down=factor)
    if name == "output 1 wide":
        return ("RGGB", 100, 100, (0, 0), (99, 10), (-10, 99), 1, 50)
    if name == "output 1 high":
        return (XTRANS, 100, 100, (0, 0), (99, 10), (-10, 99), 50, 1)
    rotation, crop = {"0.05 crop 0.05": (0.05, 0.05), "0.1 crop 0.05": (0.1, 0.05),
                      "45 deg": (0.5, 0.0)}[name]
    return _rc_case("RGGB", rotation, crop, w, h)


ROUTES = {"0.05 crop 0.05": "staged", "0.1 crop 0.05": "staged", "45 deg": "staged",
          "5999x3999 0.05 crop 0.05": "staged", "x2 rotated downscale": "staged",
          "x8 rotated downscale": "direct", "x12 rotated downscale": "direct",
          "output 1 wide": "direct", "output 1 high": "direct"}


@pytest.mark.parametrize("name", list(ROUTES))
def test_plan_route(name):
    case = _route_case(name)
    _, w, h, *_ = case
    g = _geometry(case)
    plan = krot.rotate_tile_plan(g, 1, h, w, cfa=True)
    assert plan.route == ROUTES[name], plan.reason
    finite = np.isfinite(g.rows).all() and np.isfinite(g.cols).all()
    if plan.route == "staged":
        assert 0 < plan.smem_bytes <= krot.STAGE_SMEM_BYTES
        boxes = krot.tile_boxes(plan, g, h, w)[0]
        widest = int((boxes[3] - boxes[2] + 1).max())
        assert plan.box_floats >= (boxes[1] - boxes[0] + 1).max() * (widest + 6)
    elif finite:
        assert plan.tile_h == 8 and plan.smem_bytes > krot.STAGE_SMEM_BYTES
    else:
        assert plan.row_bands is None and "non-finite" in plan.reason


# -- (d) the CPU wrapper -----------------------------------------------------------

def test_cpu_wrapper_counts_no_launch():
    name, w, h, tl, tr, bl, nw, nh = CASES["x-trans 45 deg"]
    src = torch.from_numpy(_plane(4, h, w))[None]
    before = (krot.CFA_LAUNCHES, krot.CFA_DIRECT_LAUNCHES, krot.LAUNCHES)
    got = krot.rotate_resample_cfa(src, w, h, tl, tr, bl, nw, nh, CFA(name))
    assert (krot.CFA_LAUNCHES, krot.CFA_DIRECT_LAUNCHES, krot.LAUNCHES) == before
    _assert_bit_equal(got, krot.rotate_resample_cfa_plain(src, w, h, tl, tr, bl, nw, nh,
                                                          CFA(name)))


# -- (e) the direct form's NaN-centre rule -----------------------------------------

def _strip_case(name, w, h, nh):
    """A staged scaled demosaic to an output 1 wide: phase 2f's geometry."""
    return (name, w, h, (0, 0), (w - 1, 0), (0, h - 1), 1, nh)


ONE_PX = {
    "1 wide": ("RGGB", 60, 90, (0, 0), (59, 0), (0, 89), 1, 30),
    "1 high": (XTRANS, 90, 60, (0, 0), (89, 0), (0, 59), 30, 1),
    "1 wide, rotated": ("RGGB", 100, 100, (0, 0), (99, 10), (-10, 99), 1, 50),
    "1 high, rotated": (XTRANS, 100, 100, (0, 0), (99, 10), (-10, 99), 50, 1),
    "1 wide, zero extent": ("RGGB", 70, 80, (5, 0), (5, 0), (0, 79), 1, 20),
    "strip, phase 2f's launch": _strip_case("RGGB", 1500, 16000, 10),
}


def _centres(g):
    return g.rows[4][:, None] + g.cols[4][None, :], g.rows[5][:, None] + g.cols[5][None, :]


@pytest.mark.parametrize("name", list(ONE_PX))
def test_every_pixel_of_a_one_pixel_output_has_a_nan_centre(name):
    """Outputs 1 wide or high: every pixel's cy or cx is NaN (the skip is
    inf or NaN, and skip * 0 is NaN), and the plan takes the direct form."""
    case = ONE_PX[name]
    _, w, h, *_ = case
    g = _geometry(case)
    with np.errstate(invalid="ignore"):
        cy, cx = _centres(g)
    assert (np.isnan(cy) | np.isnan(cx)).all()
    assert krot.rotate_tile_plan(g, 1, h, w, cfa=True).route == "direct"


@pytest.mark.parametrize("name", list(CASES))
def test_no_pixel_of_a_staged_geometry_has_a_nan_centre(name):
    g = _geometry(CASES[name])
    cy, cx = _centres(g)
    assert np.isfinite(cy).all() and np.isfinite(cx).all()


@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nan-inf"])
@pytest.mark.parametrize("cfa", ["RGGB", XTRANS], ids=["rggb", "x-trans"])
@pytest.mark.parametrize("name", ["1 wide, rotated", "1 high, rotated", "strip"])
def test_nan_centre_outputs_are_positive_zero(name, cfa, nonfinite):
    """What the direct form writes for a NaN-centre pixel, +0 in every
    colour, is the plain version's output bit for bit and the JAX
    package's, with NaN and +-Inf in the source or not (exact)."""
    case = _strip_case(cfa, 150, 1600, 10) if name == "strip" else (cfa, *ONE_PX[name][1:])
    _, w, h, tl, tr, bl, nw, nh = case
    data = _plane(len(name) + nonfinite, h, w, nonfinite)
    if nonfinite:       # where every window's first row reads
        data[0, :3] = (np.nan, np.inf, -np.inf)
    want = krot.rotate_resample_cfa_plain(torch.from_numpy(data)[None], w, h, tl, tr, bl, nw, nh,
                                          CFA(cfa))
    assert want.shape == (4, nh, nw)
    zeros = torch.zeros_like(want)
    assert torch.equal(want, zeros) and not torch.signbit(want).any()
    jax_out = _gather(data, case)
    np.testing.assert_array_equal(jax_out, np.zeros_like(jax_out))


# -- (f) on the card -------------------------------------------------------------

def _card_compare(data, case, want_direct):
    name, w, h, tl, tr, bl, nw, nh = case
    src = torch.from_numpy(data)[None].cuda()
    before, direct = krot.CFA_LAUNCHES, krot.CFA_DIRECT_LAUNCHES
    got = krot.rotate_resample_cfa(src, w, h, tl, tr, bl, nw, nh, CFA(name))
    torch.cuda.synchronize()
    assert krot.CFA_LAUNCHES == before + 1
    assert krot.CFA_DIRECT_LAUNCHES == direct + want_direct
    want = krot.rotate_resample_cfa_plain(src, w, h, tl, tr, bl, nw, nh, CFA(name))
    assert got.shape == want.shape == (4, nh, nw)
    _assert_bit_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [301, 302, 304])
def test_kernel_bit_equal_at_any_row_alignment(width):
    """Widths not a multiple of 4 take the 4-byte copies, 304 the 16-byte
    copies; NaN and +-Inf planted, so some tiles take the full walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    h, nw, nh = 203, 311, 230
    case = (XTRANS, width, h, *_corners(7, width, h, nw, nh), nw, nh)
    data = _plane(width, h, width, nonfinite=True)
    _card_compare(data, case, want_direct=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_bit_equal_on_staged_form(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    case = CASES[name]
    _card_compare(_plane(len(name), case[2], case[1], nonfinite=True), case, want_direct=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["output 1 wide", "output 1 high", "strip"])
def test_kernel_bit_equal_on_direct_form(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    case = _strip_case("RGGB", 150, 1600, 10) if name == "strip" else _route_case(name)
    _card_compare(_plane(3, case[2], case[1], nonfinite=True), case, want_direct=1)


@pytest.mark.cuda
def test_stores_probe_writes_zeros_and_counts_a_launch():
    """`cfa_launch` on route "stores", the timing script's probe of the
    staged schedule's stores: every output written, as zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    name, w, h, tl, tr, bl, nw, nh = CASES["rggb odd width"]
    src = torch.from_numpy(_plane(5, h, w))[None].cuda()
    g = rotated_geometry(w, h, tl, tr, bl, nw, nh)
    plan = krot.rotate_tile_plan(g, 1, h, w, cfa=True)
    # A freed block of NaN for the output to reuse (torch's caching
    # allocator): an output the probe did not write keeps NaN.
    stale = torch.full((4, nh, nw), float("nan"), device="cuda")
    del stale
    before = krot.CFA_LAUNCHES
    out = krot.cfa_launch(src, g, dataclasses.replace(plan, route="stores"), CFA(name))
    torch.cuda.synchronize()
    assert krot.CFA_LAUNCHES == before + 1 and out.shape == (4, nh, nw)
    assert torch.equal(out, torch.zeros_like(out))
