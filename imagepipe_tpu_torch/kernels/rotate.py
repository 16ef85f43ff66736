"""The rotated resample kernel: CUDA C++ for Hopper, and its plain version.

Counterpart of `imagepipe_tpu/kernels/rotate_pallas.py`.
`rotate_resample_planar(src, width, height, topleft, topright, bottomleft,
nwidth, nheight, components)` resamples a planar float32 [C, H, W] source
through the affine geometry given by the source images of the output's
top-left, top-right and bottom-left pixels into [C, nh, nw]: the rotated
branch of the resampler behind rotatecrop (scaling.rs:51-130), in one
launch of csrc/rotate.cu, which replaces the Pallas `_rotate_kernel`.

* A source on the CPU goes to the plain version, `rotate_resample_plain`
  (scaling._transform_rotated, the JAX package's `_transform_impl` as an
  eager windowed gather). A source on a CUDA device launches the kernel, or
  the wrapper raises; nothing falls back.
* The kernel takes every geometry, C <= 8: there is no `rotate_plan` that
  can refuse one. Its geometry is `scaling.rotated_geometry`: 6 row terms
  per output row and 6 column terms per output column (a few KB), copied
  to the card pinned and without blocking, plus the skips and the window
  bounds K_x, K_y of `_transform_impl`.
* `LAUNCHES` counts the kernel's launches. The library is built and bound
  by kernels/develop.py, with the develop kernels.

Numerics: every operation of the kernel is an explicit round-to-nearest
intrinsic in the plain version's order, so the two agree bit for bit
(chip_smoke.py holds them within MAX_ABS_DIFF and to the same NaN and zero
pattern).
"""

from __future__ import annotations

import torch

from ..scaling import _transform_rotated, rotated_geometry
from . import develop as kdev

__all__ = ["rotate_resample_planar", "rotate_resample_plain", "check_source",
           "LAUNCHES", "MAX_COMPONENTS", "MAX_ABS_DIFF"]

# Kernel launches by `rotate_resample_planar` since import (or since a caller
# reset it to 0).
LAUNCHES = 0

# Largest channel count the kernel takes (the Pallas kernel's limit).
MAX_COMPONENTS = 8

# Largest |kernel - plain version| accepted on the card (the JAX package's
# own Pallas-vs-gather tolerance, tests/test_rotate_pallas.py); 0 expected.
MAX_ABS_DIFF = 2e-6


def check_source(src: torch.Tensor, width: int, height: int, nwidth: int,
                 nheight: int, components: int) -> None:
    """Raise unless `src` is what the kernel takes: a contiguous float32
    [components, height, width] tensor, 1 <= components <= MAX_COMPONENTS,
    and an output of at least 1x1."""
    if src.dtype != torch.float32:
        raise TypeError(f"rotate kernel: source dtype {src.dtype}, want float32")
    if not 1 <= components <= MAX_COMPONENTS:
        raise ValueError(f"rotate kernel: {components} components, want 1..{MAX_COMPONENTS}")
    if tuple(src.shape) != (components, height, width) or not src.is_contiguous():
        raise ValueError(f"rotate kernel: source must be a contiguous [{components}, {height}, "
                         f"{width}] tensor, got {tuple(src.shape)}")
    if nwidth < 1 or nheight < 1:
        raise ValueError(f"rotate kernel: output {nwidth}x{nheight}")


def rotate_resample_plain(src: torch.Tensor, width, height, topleft, topright,
                          bottomleft, nwidth, nheight, components) -> torch.Tensor:
    """The kernel's computation in plain PyTorch, on the source's device."""
    return _transform_rotated(src, width, height, topleft, topright, bottomleft,
                              nwidth, nheight, components)


def rotate_resample_planar(src: torch.Tensor, width, height, topleft, topright,
                           bottomleft, nwidth, nheight, components) -> torch.Tensor:
    """Rotated resample of a planar [C, H, W] float32 source, C =
    components -> [C, nheight, nwidth] float32 on the source's device."""
    width, height, nwidth, nheight, components = (
        int(v) for v in (width, height, nwidth, nheight, components))
    check_source(src, width, height, nwidth, nheight, components)
    if src.device.type == "cpu":
        return rotate_resample_plain(src, width, height, topleft, topright, bottomleft,
                                     nwidth, nheight, components)
    if src.device.type != "cuda":
        raise ValueError(f"rotate kernel: unsupported device {src.device}")
    g = rotated_geometry(width, height, topleft, topright, bottomleft, nwidth, nheight)
    rows, cols = kdev.upload(g.rows, src.device), kdev.upload(g.cols, src.device)
    out = torch.empty((components, nheight, nwidth), dtype=torch.float32, device=src.device)
    lib = kdev._library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        rc = lib.rotate_resample_launch(
            src.data_ptr(), components, height, width, rows.data_ptr(), cols.data_ptr(),
            nheight, nwidth, float(g.sxx), float(g.syy), g.k_x, g.k_y, out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"rotate kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
