"""The frozen roofline arithmetic against hand-computed values."""

import numpy as np
import pytest

from portbench import bounds
from portbench.reference import develop as rdev

RGGB = np.array([[0, 1], [1, 2]])
XTRANS = np.array(["RGB".index(c) for c in "GBGGRGRGRBGBGBGGRGGRGGBGBGBRGRGRGGBG"]).reshape(6, 6)


def test_bayer_demosaic_ops_are_the_timing_scripts():
    # R and B: 4 + 4 other-colour neighbours; G: 2 + 2 (OPS_DEMOSAIC_BAYER).
    assert bounds.demosaic_ops(RGGB) == 6.0


def test_xtrans_demosaic_ops_count_each_cells_neighbours():
    # Every X-Trans cell has 8 neighbours; a G cell has 4 or 5 G neighbours
    # around it (the 2x2 G blocks and the diagonals), an R or B cell only G,
    # R or B of the other kind.
    ops = bounds.demosaic_ops(XTRANS)
    assert 4.0 < ops < 8.0


def test_develop_bound_by_hand():
    # 24 MP: bytes 2 + 3 per pixel over 3.35 TB/s = 0.0358 ms; operations
    # (3 + 6 + 154) per pixel over 67 TFLOP/s = 0.0584 ms: operations bound.
    px = 6000 * 4000
    assert bounds.develop_s(6000, 4000, RGGB) == pytest.approx(px * 163 / 67e12)
    assert px * 163 / 67e12 * 1e3 == pytest.approx(0.05839, rel=1e-3)


def test_scaled_bound_by_hand():
    # A 4x4 plane to 2x2: every window is 3 wide (from 0/1 to 2/3, shared
    # edges), so 6 x 6 samples; src 16 px, out 4 px.
    axes = rdev.aligned_axes(4, 4, (0, 0), (3, 0), (0, 3), 2, 2)
    samples = int((axes.to_x - axes.from_x + 1).sum()) * int((axes.to_y - axes.from_y + 1).sum())
    ops = 16 * 3 + samples * 5 + 4 * (4 + 154)
    assert bounds.scaled_s(4, 4, axes) == pytest.approx(max(ops / 67e12, (32 + 12) / 3.35e12))


def test_rotate_and_suffix_bounds_by_hand():
    assert bounds.rotate_s(6000, 4000, 5981, 4458) == pytest.approx(
        (16 * 6000 * 4000 + 16 * 5981 * 4458) / 3.35e12)
    # An exposure edit's segment: 3 planes in, three stage outputs kept and
    # the 8-bit output: 12 + 3 * 12 + 3 bytes a pixel; 12 + 2 + 36 + 12 + 9
    # operations a pixel.
    px = 6000 * 4000
    assert bounds.suffix_s(6000, 4000, ["basecurve", "from_lab", "gamma"], 3) == pytest.approx(
        max(px * (12 + 36 + 3) / 3.35e12, px * (12 + 2 + 36 + 12 + 9) / 67e12))
