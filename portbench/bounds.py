"""The kernels' rooflines: the least time the card could take for the work a
launch does, from the work's shapes alone.

A frozen copy of the bound arithmetic of `scripts/time_develop_kernels.py`
(its `roofline`, `develop_bound`, `scaled_bound`, `suffix_bound` and the
`OPS_*` counts, from NVIDIA's H100 SXM data sheet at its 700 W limit), with
two changes: the 3x3 demosaic's operations are counted from the CFA pattern
(for RGGB this is that file's OPS_DEMOSAIC_BAYER, 6), and the rotate
kernel's bound is its bytes alone, which is at most what the file's bound
gives. Each input byte counts once, each output byte once.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

OPS_LEVELS = 3
OPS_FINISH = 154
OPS_WINDOW_SAMPLE = 5
OPS_SCALED_PIXEL = 4
OPS_SUFFIX = {"to_lab": 54, "basecurve": 12, "from_lab": 36, "gamma": 12}
OPS_QUANT_8 = 9


def roofline_s(read_bytes: float, write_bytes: float, ops: float) -> float:
    """Seconds: the larger of the bytes over the memory rate and the float32
    operations over the float32 rate."""
    return max((read_bytes + write_bytes) / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def demosaic_ops(grid: np.ndarray) -> float:
    """Float32 operations per pixel of the 3x3 neighbour-average demosaic,
    averaged over the pattern: for each other colour among a pixel's 8
    neighbours, n - 1 adds and a division."""
    ph, pw = grid.shape
    total = 0
    for r in range(ph):
        for c in range(pw):
            own = grid[r, c]
            seen = [grid[(r + dy) % ph, (c + dx) % pw]
                    for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
            total += sum(seen.count(k) for k in set(seen) if k != own)
    return total / (ph * pw)


def develop_s(width: int, height: int, grid: np.ndarray, out_bytes: int = 1) -> float:
    """A full-size develop of a u16 plane (`csrc/develop.cu`) to samples of
    `out_bytes` (1: 8-bit, 2: 16-bit)."""
    px = width * height
    ops = px * (OPS_LEVELS + demosaic_ops(grid) + OPS_FINISH)
    return roofline_s(2 * px, 3 * out_bytes * px, ops)


def scaled_s(width: int, height: int, axes, out_bytes: int = 1) -> float:
    """A thumbnail develop (`csrc/develop_scaled.cu`) along the aligned
    `axes` (reference.develop.Axes): the window samples it has, levels once
    per source sample."""
    samples = int((axes.to_x - axes.from_x + 1).sum()) * int((axes.to_y - axes.from_y + 1).sum())
    src, out = width * height, len(axes.from_x) * len(axes.from_y)
    return roofline_s(2 * src, 3 * out_bytes * out, src * OPS_LEVELS + samples * OPS_WINDOW_SAMPLE
                      + out * (OPS_SCALED_PIXEL + OPS_FINISH))


def rotate_s(width: int, height: int, nwidth: int, nheight: int, channels: int = 4) -> float:
    """A rotated resample of `channels` float32 planes (`csrc/rotate.cu`):
    the source read once, the output written once."""
    return roofline_s(4 * channels * width * height, 4 * channels * nwidth * nheight, 0)


def suffix_s(width: int, height: int, stages, n_knots: int) -> float:
    """A fused suffix (`csrc/suffix.cu`) over `stages`, every stage output
    kept and the 8-bit output written."""
    px = width * height
    ops = sum(OPS_SUFFIX[s] for s in stages) + OPS_QUANT_8
    if "basecurve" in stages:
        ops += n_knots - 1
    planes_in = 4 if stages[0] == "to_lab" else 3
    written = 3 * px * (4 * len(stages) + 1)
    return roofline_s(planes_in * px * 4, written, px * ops)
