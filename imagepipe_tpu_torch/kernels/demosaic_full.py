"""Full-resolution CFA demosaic as a 3x3 stencil on tensors.

Counterpart of `imagepipe_tpu/kernels/demosaic_full.py` (the reference's
`full()`, demosaic.rs:67-119). The same [48,48,9] neighbour-colour table
drives nine shifted whole-image accumulations in the reference's offset
order, so the sums are formed term for term as in the JAX package. This is
the plain form; the CUDA develop kernel (kernels/develop.py) computes the
same rule per pixel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..raw import CFA, PATTERN_TILE

__all__ = ["OFFSETS_3X3", "neighbor_color_lookup", "stencil_demosaic_planes"]

# 3x3 neighbourhood offsets in the reference's order (demosaic.rs:70-74).
OFFSETS_3X3 = [(-1, -1), (-1, 0), (-1, 1),
               (0, -1), (0, 0), (0, 1),
               (1, -1), (1, 0), (1, 1)]


@lru_cache(maxsize=64)
def _lookup_cached(cfa_name: str) -> np.ndarray:
    cfa = CFA(cfa_name)
    t = PATTERN_TILE
    lut = np.zeros((t, t, 9), dtype=np.uint8)
    for row in range(t):
        for col in range(t):
            pixcolor = cfa.color_at(row, col)
            for i, (dy, dx) in enumerate(OFFSETS_3X3):
                ocolor = cfa.color_at(row + t + dy, col + t + dx)
                # Same-colour neighbours (other than the centre itself) are
                # tagged 4 = discard so the centre keeps its own measured
                # value (demosaic.rs:87).
                if ocolor != pixcolor or (dx == 0 and dy == 0):
                    lut[row, col, i] = ocolor
                else:
                    lut[row, col, i] = 4
    return lut


def neighbor_color_lookup(cfa) -> np.ndarray:
    """[48,48,9] neighbour-colour table, exactly demosaic.rs:76-90."""
    return _lookup_cached(cfa.name)


def stencil_demosaic_planes(plane: torch.Tensor, cfa_name: str, height: int,
                            width: int) -> list[torch.Tensor]:
    """[H,W] f32 levels plane -> four [H,W] RGBE planes. Each colour averages
    its valid neighbours (edges: out-of-image neighbours do not count); the
    centre's own colour takes the centre sample; no neighbour gives 0."""
    dev = plane.device
    f = torch.float32
    padded = F.pad(plane, (1, 1, 1, 1))
    vmask = F.pad(torch.ones((height, width), dtype=f, device=dev), (1, 1, 1, 1))
    lut = _lookup_cached(cfa_name)
    lut_t = torch.from_numpy(lut).to(dev)
    rows = (torch.arange(height, device=dev) % PATTERN_TILE)[:, None]
    cols = (torch.arange(width, device=dev) % PATTERN_TILE)[None, :]
    sums = [torch.zeros((height, width), dtype=f, device=dev) for _ in range(4)]
    counts = [torch.zeros((height, width), dtype=f, device=dev) for _ in range(4)]
    for i, (dy, dx) in enumerate(OFFSETS_3X3):
        val = padded[1 + dy:1 + dy + height, 1 + dx:1 + dx + width]
        valid = vmask[1 + dy:1 + dy + height, 1 + dx:1 + dx + width]
        color = lut_t[:, :, i][rows, cols]
        present = set(np.unique(lut[:, :, i]))
        for c in range(4):
            if c not in present:
                continue
            sel = torch.where(color == c, valid, 0.0)
            sums[c] = sums[c] + val * sel
            counts[c] = counts[c] + sel
    return [torch.where(counts[c] > 0.0, sums[c] / counts[c], 0.0)
            for c in range(4)]
