"""Size planning (scaling.rs:8-32) and the axis-aligned resampler
(scaling.rs:51-130) on tensors.

Counterpart of `imagepipe_tpu/scaling.py`, whose file imports JAX at the
top. Size planning is the reference's float32 arithmetic on the host. The
resampler is the axis-aligned part of the JAX package's
`_transform_aligned_impl`: each output pixel is the paraboloid-weighted
mean `max(0, (1 - dx^2) - dy^2)` over its source window, per colour of the
CFA (the fused demosaic-downscale) or per channel. It runs eagerly on the
input's device as a direct windowed gather: a row gather by window row,
then a column gather by window column, accumulated ky outer, kx inner, as
the reference's scalar loop. The one-hot column matmul, banding and static
unroll of the JAX file are TPU workarounds and are not ported.

The window indices and centres are host numpy float32 with two roundings
(`aligned_axes`): a device `base + skip * index` may be contracted into one
FMA whose single rounding floors to another source pixel.

Rotated geometry (rotatecrop) is not ported: ROADMAP A9.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["calculate_scaling_total", "scaling_size", "calculate_scale",
           "sat_floor_np", "AlignedAxes", "aligned_axes", "transform_buffer",
           "scale_down_planar", "scale_down_srgb", "scale_down_srgb16"]

_f32 = np.float32


def calculate_scaling_total(width: int, height: int, maxwidth: int, maxheight: int):
    """(scale, width, height) of the fit; all arithmetic float32 so planned
    sizes agree with the reference bit for bit."""
    if maxwidth == 0 and maxheight == 0:
        return (1.0, width, height)
    xscale = _f32(1.0) if maxwidth == 0 else _f32(_f32(width) / _f32(maxwidth))
    yscale = _f32(1.0) if maxheight == 0 else _f32(_f32(height) / _f32(maxheight))
    if yscale <= 1.0 and xscale <= 1.0:
        return (1.0, width, height)
    elif yscale > xscale:
        return (float(yscale), int(_f32(width) / yscale), maxheight)
    else:
        return (float(xscale), maxwidth, int(_f32(height) / xscale))


def scaling_size(width: int, height: int, maxwidth: int, maxheight: int):
    _, w, h = calculate_scaling_total(width, height, maxwidth, maxheight)
    return (w, h)


def calculate_scale(width: int, height: int, maxwidth: int, maxheight: int) -> float:
    return calculate_scaling_total(width, height, maxwidth, maxheight)[0]


def sat_floor_np(v, maxv, dtype=np.int64):
    """floor -> NaN->0 -> clip[0, maxv]: Rust's saturating `floor() as
    usize` then `min(maxv, .)`, on host float32 values."""
    v = np.floor(v)
    v = np.where(np.isnan(v), 0.0, v)
    return np.clip(v, 0.0, maxv).astype(dtype)


@dataclass(frozen=True)
class AlignedAxes:
    """Host window geometry of an axis-aligned resample: per output column
    the inclusive source window [from_x, to_x] and centre cx, per output
    row likewise, the per-axis skips, and the largest window span K."""
    from_x: np.ndarray   # [nw] int32
    to_x: np.ndarray
    cx: np.ndarray       # [nw] float32
    from_y: np.ndarray   # [nh] int32
    to_y: np.ndarray
    cy: np.ndarray       # [nh] float32
    sxx: np.float32
    syy: np.float32
    k_x: int
    k_y: int


def aligned_axes(width, height, topleft, topright, bottomleft, nwidth,
                 nheight) -> AlignedAxes:
    """The index math of scaling.rs:69-89 for an axis-aligned geometry, in
    the reference's float32 order (`_transform_aligned_impl` :216-242 of
    the JAX package)."""
    tl0, tl1 = _f32(topleft[0]), _f32(topleft[1])
    tr0, bl1 = _f32(topright[0]), _f32(bottomleft[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        sxx = _f32((tr0 - tl0) / _f32(nwidth - 1))
        syy = _f32((bl1 - tl1) / _f32(nheight - 1))
    rows = np.arange(nheight, dtype=_f32)
    cols = np.arange(nwidth, dtype=_f32)
    with np.errstate(invalid="ignore"):
        from_x = sat_floor_np(tl0 + sxx * cols, width - 1, np.int32)
        to_x = sat_floor_np(tl0 + sxx * (cols + _f32(1.0)), width - 1, np.int32)
        from_y = sat_floor_np(tl1 + syy * rows, height - 1, np.int32)
        to_y = sat_floor_np(tl1 + syy * (rows + _f32(1.0)), height - 1, np.int32)
        # ((tl0 - 0.5) + sxx*col) + sxx/2, and (tl1 + syy*row + syy/2) - 0.5
        # (scaling.rs:81,88).
        cx = (((tl0 - _f32(0.5)) + sxx * cols) + (sxx / _f32(2.0))).astype(_f32)
        cy = ((tl1 + syy * rows + (syy / _f32(2.0))) - _f32(0.5)).astype(_f32)
    k_x = max(1, int((to_x - from_x).max()) + 1)
    k_y = max(1, int((to_y - from_y).max()) + 1)
    return AlignedAxes(from_x, to_x, cx, from_y, to_y, cy, sxx, syy, k_x, k_y)


def _scalar(v, device) -> torch.Tensor:
    # Division by a 0-d tensor stays IEEE on CUDA (see color._div).
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _transform_aligned(planes: torch.Tensor, width, height, topleft, topright,
                       bottomleft, nwidth, nheight, components, cfa=None):
    """planes [C, H, W] float32 (C=1 with `cfa`) -> [C', nh, nw] float32,
    C' = 4 with a CFA, else `components`."""
    dev = planes.device
    g = aligned_axes(width, height, topleft, topright, bottomleft, nwidth, nheight)
    from_x, to_x, from_y, to_y = (torch.from_numpy(a.astype(np.int64)).to(dev)
                                  for a in (g.from_x, g.to_x, g.from_y, g.to_y))
    cx, cy = (torch.from_numpy(a).to(dev) for a in (g.cx, g.cy))
    sxx, syy = _scalar(g.sxx, dev), _scalar(g.syy, dev)
    f = torch.float32

    if cfa is not None:
        ph, pw = cfa.pattern.shape
        pattern = torch.from_numpy(cfa.pattern.astype(np.int64)).to(dev)
        channels = torch.arange(4, device=dev)[:, None, None]
        nsum = 4
    else:
        nsum = planes.shape[0]
    sums = torch.zeros((nsum, nheight, nwidth), dtype=f, device=dev)
    counts = torch.zeros((nsum if cfa is not None else 1, nheight, nwidth),
                         dtype=f, device=dev)

    for ky in range(g.k_y):
        y = torch.clamp(from_y + ky, max=height - 1)
        valid_y = (from_y + ky) <= to_y
        dy = (y.to(f) - cy) / syy
        dy2 = dy * dy                                        # [nh]
        rows = planes[:, y, :]                               # [C, nh, W]
        for kx in range(g.k_x):
            x = torch.clamp(from_x + kx, max=width - 1)
            valid_x = (from_x + kx) <= to_x
            dx = (x.to(f) - cx) / sxx
            # factor = (1 - dx^2) - dy^2 in the reference's order.
            factor = (1.0 - dx * dx)[None, :] - dy2[:, None]
            factor = torch.where(factor < 0.0, 0.0, factor)
            w = torch.where(valid_y[:, None] & valid_x[None, :], factor, 0.0)
            sel = rows[:, :, x]                              # [C, nh, nw]
            if cfa is None:
                sums = sums + sel * w
                counts = counts + w
                continue
            color = pattern[(y % ph)[:, None], (x % pw)[None, :]]   # [nh, nw]
            mask = (color[None] == channels).to(f)           # [4, nh, nw]
            sums = sums + (sel[0] * w)[None] * mask
            counts = counts + w[None] * mask
    out = torch.where(counts > 0.0, sums / counts, 0.0)
    return out if cfa is not None else out[:components]


def transform_buffer(src: torch.Tensor, width, height, topleft, topright,
                     bottomleft, nwidth, nheight, components, cfa=None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """The resampler (scaling.rs:51-130) on an interleaved [H, W, C] tensor
    -> [nh, nw, C']; integer outputs truncate and saturate like Rust `as`.
    Axis-aligned geometry only."""
    aligned = (int(topright[1]) == int(topleft[1])
               and int(bottomleft[0]) == int(topleft[0])
               and nwidth > 1 and nheight > 1)
    if not aligned:
        raise NotImplementedError("rotated resample (rotatecrop): ROADMAP A9")
    src = src if src.dim() == 3 else src[..., None]
    out = _transform_aligned(src.to(torch.float32).permute(2, 0, 1), int(width),
                             int(height), topleft, topright, bottomleft,
                             int(nwidth), int(nheight), int(components), cfa)
    out = out.permute(1, 2, 0)
    if out_dtype == torch.float32:
        return out
    hi = 255.0 if out_dtype == torch.uint8 else 65535.0
    return torch.clamp(torch.trunc(out), 0.0, hi).to(out_dtype)


def scale_down_planar(src_chw: torch.Tensor, nwidth: int, nheight: int,
                      components: int, cfa=None) -> torch.Tensor:
    """Planar [C, H, W] -> [C', nh, nw] float32 scale-down of the whole
    image (C=1 with `cfa`: the fused demosaic-downscale)."""
    _, height, width = src_chw.shape
    return _transform_aligned(src_chw.to(torch.float32), int(width), int(height),
                              (0, 0), (int(width) - 1, 0), (0, int(height) - 1),
                              int(nwidth), int(nheight), int(components), cfa)


def _scale_down_srgb(data: torch.Tensor, nwidth, nheight, out_dtype):
    h, w, _ = data.shape
    return transform_buffer(data, w, h, (0, 0), (w - 1, 0), (0, h - 1),
                            nwidth, nheight, 3, out_dtype=out_dtype)


def scale_down_srgb(data: torch.Tensor, nwidth: int, nheight: int) -> torch.Tensor:
    """u8 interleaved sRGB [H, W, 3] downscale (scaling.rs:162-171)."""
    return _scale_down_srgb(data, nwidth, nheight, torch.uint8)


def scale_down_srgb16(data: torch.Tensor, nwidth: int, nheight: int) -> torch.Tensor:
    """u16 interleaved sRGB [H, W, 3] downscale (scaling.rs:173-182)."""
    return _scale_down_srgb(data, nwidth, nheight, torch.uint16)
