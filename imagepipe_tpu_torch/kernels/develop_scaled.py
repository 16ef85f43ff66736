"""The thumbnail develop kernel: CUDA C++ for Hopper, and its plain version.

Counterpart of `imagepipe_tpu/kernels/develop_scaled.py`. `develop_scaled(
plan, plane)` develops a 'scaled' plan (a cfa plan whose maxwidth /
maxheight asks for at least the CFA's minimum downscale) in one kernel
launch: the CFA-aware paraboloid-weighted downscale fused with the develop
back end (csrc/develop_scaled.cu, which replaces the Pallas
`_scaled_kernel` and `_scaled_kernel_chunked`). No full-resolution
intermediate exists. EXIF flips run afterwards as torch ops.

* A plane on the CPU goes to `develop_scaled_plain`: the eager engine's
  'scaled' path (crop -> levels -> scaling.scale_down_planar with the CFA
  -> finish_planes) in 'direct' numerics. A plane on a CUDA device launches
  the kernel, or the wrapper raises; nothing falls back.
* The kernel takes every window size: the Pallas envelope (window <= 16,
  chunked <= 40) was VMEM's.
* Its geometry is a few KB of separable host tables (`scaled_geometry`):
  window bounds per output row and column and the squared distances dy^2
  per (ky, row) and dx^2 per (kx, col), float32 as the reference rounds
  them. They replace the Pallas kernel's ~H*W*5 bytes of per-offset
  weight, colour and count tables.
* `LAUNCHES` counts kernel launches. The library is built and bound by
  kernels/develop.py, with the full-size kernel.

Numerics: the RGBE sums equal the plain version's term for term (same
order, rounded products and adds); the back end's FMA contractions leave
the cross-path contract of kernels/develop.py: max |diff| <= 1 LSB on
fewer than 2% of values.
"""

from __future__ import annotations

import numpy as np
import torch

from .._host import CFA
from ..engine import _develop_one
from ..scaling import aligned_axes
from . import develop as kdev

__all__ = ["develop_scaled", "develop_scaled_plain", "scaled_supported",
           "scaled_geometry", "LAUNCHES"]

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

_f32 = np.float32


def scaled_supported(plan) -> bool:
    """cfa plans on the 'scaled' path with an output of at least 2x2 and a
    CFA period the kernel takes (kernels/develop.py MAX_PATTERN)."""
    if plan.mode != "cfa" or plan.dem_path != "scaled":
        return False
    if plan.dem_h <= 1 or plan.dem_w <= 1:
        return False
    cfa = CFA(plan.cfa_name)
    return cfa.is_valid() and max(cfa.height, cfa.width) <= kdev.MAX_PATTERN


def scaled_geometry(plan, device="cpu") -> dict:
    """{from_x, to_x [nw], from_y, to_y [nh] int32; dx2 [K_x, nw], dy2
    [K_y, nh] float32}: the separable host tables of the plan's downscale,
    computed as the JAX package's `_transform_aligned_impl` computes them
    (:229-242), as tensors on `device`. Memoized on the plan: repeated
    develops of one plan build and upload them once."""
    device = torch.device(device)
    hit = getattr(plan, "_scaled_geometry", None)
    if hit is not None and hit[0] == device:
        return hit[1]
    H, W = plan.height, plan.width
    g = aligned_axes(W, H, (0, 0), (W - 1, 0), (0, H - 1), plan.dem_w, plan.dem_h)
    x = np.minimum(g.from_x[None, :] + np.arange(g.k_x)[:, None], W - 1)
    y = np.minimum(g.from_y[None, :] + np.arange(g.k_y)[:, None], H - 1)
    dx = (x.astype(_f32) - g.cx[None, :]) / g.sxx
    dy = (y.astype(_f32) - g.cy[None, :]) / g.syy
    tables = dict(from_x=g.from_x, to_x=g.to_x, from_y=g.from_y, to_y=g.to_y,
                  dx2=(dx * dx).astype(_f32), dy2=(dy * dy).astype(_f32))
    tables = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
              for k, v in tables.items()}
    plan._scaled_geometry = (device, tables)
    return tables


def develop_scaled_plain(plan, plane: torch.Tensor) -> torch.Tensor:
    """The kernel's computation in plain PyTorch, on the plane's device."""
    return _develop_one(plan, plane, "direct")


def develop_scaled(plan, plane: torch.Tensor) -> torch.Tensor:
    """Develop the uncropped sensor plane [H0, W0] (u16 or f32) of a
    'scaled' cfa plan -> quantized planar [3, dem_h, dem_w] u8/u16, flipped
    to the plan's orientation."""
    if plane.device.type == "cpu":
        return develop_scaled_plain(plan, plane)
    if plane.device.type != "cuda":
        raise ValueError(f"develop_scaled kernel: unsupported device {plane.device}")
    if not scaled_supported(plan):
        raise ValueError(f"develop_scaled kernel: unsupported plan (mode {plan.mode!r}, "
                         f"dem_path {plan.dem_path!r}, {plan.dem_w}x{plan.dem_h}, "
                         f"cfa {plan.cfa_name!r})")
    kdev.check_plane(plan, plane, "develop_scaled kernel")
    scal, spline, pattern, n_knots = kdev._device_tables(plan, plane.device)
    g = scaled_geometry(plan, plane.device)
    out = torch.empty((3, plan.dem_h, plan.dem_w), device=plane.device,
                      dtype=torch.uint8 if plan.out_bits == 8 else torch.uint16)
    lib = kdev._library()
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    with torch.cuda.device(plane.device):
        rc = lib.develop_scaled_launch(
            plane.data_ptr(), int(plane.dtype == torch.float32), plane.stride(0),
            plan.crop_x, plan.crop_y, plan.dem_h, plan.dem_w,
            g["from_x"].data_ptr(), g["to_x"].data_ptr(),
            g["from_y"].data_ptr(), g["to_y"].data_ptr(),
            g["dx2"].data_ptr(), g["dy2"].data_ptr(),
            scal.data_ptr(), spline.data_ptr(), spline.shape[1], n_knots,
            pattern.data_ptr(), pattern.shape[0], pattern.shape[1],
            int(plan.linear), plan.out_bits, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"develop_scaled kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return kdev.apply_flips(out, plan.orientation_flips)
