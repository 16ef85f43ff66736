"""Size planning (scaling.rs:8-32) and the resampler (scaling.rs:51-130)
on tensors.

Counterpart of `imagepipe_tpu/scaling.py`, whose file imports JAX at the
top. Size planning is the reference's float32 arithmetic on the host. The
resampler maps each output pixel back to a source window bounded by the
float32 affine images of the pixel's cell corners and takes the
paraboloid-weighted mean `max(0, (1 - dx^2) - dy^2)` over it, per colour of
the CFA (the fused demosaic-downscale) or per channel. An empty or inverted
window gives 0.

* Axis-aligned geometry (every scale-down and pure crop) is the JAX
  package's `_transform_aligned_impl`, run eagerly on the input's device as
  a direct windowed gather: a row gather by window row, then a column
  gather by window column, accumulated ky outer, kx inner, as the
  reference's scalar loop (`resample_aligned`). It takes a range of output
  columns and a source holding only the columns they read
  (`source_span`), so the eager engine's width shards resample their own
  columns with the whole geometry's windows. The one-hot column matmul,
  banding and static unroll of the JAX file are TPU workarounds and are
  not ported.
* Rotated geometry (rotatecrop) is `_transform_impl`: the window bounds
  vary along both axes, so each (ky, kx) step gathers one sample per output
  pixel. On CUDA it is the rotate kernel (kernels/rotate.py,
  csrc/rotate.cu): `rotate_resample_planar` per channel, and
  `rotate_resample_cfa`, the kernel's CFA route, for the CFA-aware form.
  That form is reached by a staged scaled demosaic to an output 1 pixel
  wide or high (an extent of 1 is not axis-aligned) and by
  `transform_buffer(..., cfa=...)` with a rotated geometry.
  `_transform_rotated` is the plain version of both and the CPU's
  executor.

Every window index and centre is host numpy float32 with two roundings
(`aligned_axes`, `rotated_geometry`); a rotated geometry leaves one device
add of a row term and a column term before each floor(). A device
`base + skip * index` may be contracted into one FMA whose single rounding
floors to another source pixel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .buffer import OpBuffer

__all__ = ["calculate_scaling_total", "scaling_size", "calculate_scale",
           "sat_floor_np", "AlignedAxes", "aligned_axes", "scale_down_axes", "source_span",
           "resample_aligned", "RotatedGeometry",
           "rotated_geometry", "transform_buffer", "transform_buffer_planar",
           "scale_down_planar", "scaled_demosaic", "scale_down_opbuf",
           "scale_down_srgb", "scale_down_srgb16"]

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


@lru_cache(maxsize=64)
def scale_down_axes(width: int, height: int, nwidth: int, nheight: int) -> AlignedAxes:
    """The aligned axes of a scale-down of a whole `width` x `height` image
    (corners (0, 0), (W - 1, 0), (0, H - 1)), computed once per geometry:
    its arrays are shared and never written."""
    return aligned_axes(width, height, (0, 0), (width - 1, 0), (0, height - 1), nwidth,
                        nheight)


def source_span(g: AlignedAxes, o0: int, o1: int, width: int) -> tuple[int, int]:
    """[xs, xe): the source columns that output columns o0 .. o1 - 1 of `g`
    read, in weight or not: each column walks from_x .. from_x + k_x - 1,
    clamped to the image (`resample_aligned`)."""
    from_x = g.from_x[o0:o1]
    return int(from_x.min()), min(int(from_x.max()) + g.k_x, width)


def resample_aligned(planes: torch.Tensor, g: AlignedAxes, width, height, components,
                     cfa=None, cols=None, x0: int = 0) -> torch.Tensor:
    """The axis-aligned resample of `g` over a source `width` x `height`,
    for output columns cols = (o0, o1) (default all): planes [C, H, w]
    float32 (C=1 with `cfa`) hold source columns x0 .. x0 + w - 1, which
    must cover `source_span(g, o0, o1, width)` -> [C', nh, o1 - o0]
    float32, C' = 4 with a CFA, else `components`. Window indices, centres
    and CFA colours are the whole geometry's, so every output value is the
    same sequence of float32 operations whatever the column range."""
    dev = planes.device
    o0, o1 = (0, len(g.from_x)) if cols is None else cols
    nheight, nwidth = len(g.from_y), o1 - o0
    from_x, to_x = (torch.from_numpy(a[o0:o1].astype(np.int64)).to(dev)
                    for a in (g.from_x, g.to_x))
    from_y, to_y = (torch.from_numpy(a.astype(np.int64)).to(dev) for a in (g.from_y, g.to_y))
    cx, cy = torch.from_numpy(g.cx[o0:o1]).to(dev), torch.from_numpy(g.cy).to(dev)
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
        rows = planes[:, y, :]                               # [C, nh, w]
        for kx in range(g.k_x):
            x = torch.clamp(from_x + kx, max=width - 1)
            valid_x = (from_x + kx) <= to_x
            dx = (x.to(f) - cx) / sxx
            # factor = (1 - dx^2) - dy^2 in the reference's order.
            factor = (1.0 - dx * dx)[None, :] - dy2[:, None]
            factor = torch.where(factor < 0.0, 0.0, factor)
            w = torch.where(valid_y[:, None] & valid_x[None, :], factor, 0.0)
            sel = rows[:, :, x - x0]                         # [C, nh, nw]
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


@dataclass(frozen=True)
class RotatedGeometry:
    """Host window geometry of a rotated resample, separable into a row
    term and a column term per quantity: rows [6, nh] and cols [6, nw]
    float32, in the order from_y, to_y, from_x, to_x, centre_y, centre_x.
    The source window of
    output pixel (r, c) is [floor(rows[0, r] + cols[0, c]), floor(rows[1,
    r] + cols[1, c])] in y (saturated to [0, H-1]) and likewise 2/3 in x;
    its centre is rows[4/5, r] + cols[4/5, c]. sxx and syy divide dx and
    dy; k_x, k_y bound the window loop."""
    rows: np.ndarray
    cols: np.ndarray
    sxx: np.float32
    syy: np.float32
    k_x: int
    k_y: int


def _bound(a, b, width, height) -> int:
    """The static window bound of `_transform_impl` (scaling.py:136-142 of
    the JAX package): non-finite skips count 0."""
    s = (0.0 if not math.isfinite(float(a)) else abs(float(a))) + (
        0.0 if not math.isfinite(float(b)) else abs(float(b)))
    return max(1, min(int(math.ceil(s)) + 2, max(width, height)))


def rotated_geometry(width, height, topleft, topright, bottomleft, nwidth,
                     nheight) -> RotatedGeometry:
    """The index math of scaling.rs:69-89 for any affine geometry, in the
    reference's float32 order (`_transform_impl` :88-142 of the JAX
    package): per-axis skips by f32 division (inf or NaN when an output
    extent is 1), products rounded before each add."""
    tl0, tl1 = _f32(topleft[0]), _f32(topleft[1])
    tr0, tr1 = _f32(topright[0]), _f32(topright[1])
    bl0, bl1 = _f32(bottomleft[0]), _f32(bottomleft[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        sxx = _f32((tr0 - tl0) / _f32(nwidth - 1))
        sxy = _f32((tr1 - tl1) / _f32(nwidth - 1))
        syx = _f32((bl0 - tl0) / _f32(nheight - 1))
        syy = _f32((bl1 - tl1) / _f32(nheight - 1))
    r = np.arange(nheight, dtype=_f32)
    c = np.arange(nwidth, dtype=_f32)
    one, half, two = _f32(1.0), _f32(0.5), _f32(2.0)
    with np.errstate(invalid="ignore", over="ignore"):
        rows = np.stack([
            tl1 + syy * r, tl1 + syy * (r + one),
            tl0 + syx * r, tl0 + syx * (r + one),
            tl1 + syy * r + (syy / two) - half,
            tl0 + syx * r + (syx / two) - half]).astype(_f32)
        cols = np.stack([
            sxy * c, sxy * (c + one),
            sxx * c, sxx * (c + one),
            sxy * c + (sxy / two),
            sxx * c + (sxx / two)]).astype(_f32)
    return RotatedGeometry(rows, cols, sxx, syy, _bound(sxx, syx, width, height),
                           _bound(sxy, syy, width, height))


def _sat_idx(v: torch.Tensor, maxv: int) -> torch.Tensor:
    """NaN -> 0, floor, clip to [0, maxv] (Rust's saturating `as usize`)."""
    v = torch.where(torch.isnan(v), 0.0, v)
    return torch.clamp(torch.floor(v), 0.0, float(maxv)).to(torch.int64)


def _transform_rotated(planes: torch.Tensor, width, height, topleft, topright,
                       bottomleft, nwidth, nheight, components, cfa=None):
    """planes [C, H, W] float32 (C=1 with `cfa`) -> [C', nh, nw] float32,
    C' = 4 with a CFA, else `components`: `_transform_impl` of the JAX
    package as an eager windowed gather. Every output pixel walks the same
    K_y x K_x window offsets (ky outer, kx inner); a sample counts where
    from + k <= to on both axes."""
    dev = planes.device
    f = torch.float32
    g = rotated_geometry(width, height, topleft, topright, bottomleft, nwidth, nheight)
    rows, cols = torch.from_numpy(g.rows).to(dev), torch.from_numpy(g.cols).to(dev)

    def pixel(i):     # the one device add of a row and a column term
        return rows[i][:, None] + cols[i][None, :]

    from_y, to_y = _sat_idx(pixel(0), height - 1), _sat_idx(pixel(1), height - 1)
    from_x, to_x = _sat_idx(pixel(2), width - 1), _sat_idx(pixel(3), width - 1)
    centre_y, centre_x = pixel(4), pixel(5)
    sxx, syy = _scalar(g.sxx, dev), _scalar(g.syy, dev)

    flat = planes.reshape(planes.shape[0], -1)
    if cfa is not None:
        tile = torch.from_numpy(cfa.pattern_tile().astype(np.int64)).to(dev)
        nt = tile.shape[0]
        channels = torch.arange(4, device=dev)[:, None, None]
        nsum = 4
    else:
        nsum = planes.shape[0]
    sums = torch.zeros((nsum, nheight, nwidth), dtype=f, device=dev)
    counts = torch.zeros((nsum if cfa is not None else 1, nheight, nwidth),
                         dtype=f, device=dev)

    for ky in range(g.k_y):
        y = from_y + ky
        valid_y = y <= to_y
        yc = torch.clamp(y, max=height - 1)
        dy = (y.to(f) - centre_y) / syy
        dy2 = dy * dy
        for kx in range(g.k_x):
            x = from_x + kx
            xc = torch.clamp(x, max=width - 1)
            dx = (x.to(f) - centre_x) / sxx
            # factor = (1 - dx^2) - dy^2; where(f < 0) keeps a NaN.
            factor = (1.0 - dx * dx) - dy2
            factor = torch.where(factor < 0.0, 0.0, factor)
            w = torch.where(valid_y & (x <= to_x), factor, 0.0)
            val = flat[:, yc * width + xc]                     # [C, nh, nw]
            if cfa is None:
                sums = sums + val * w
                counts = counts + w
                continue
            onehot = tile[yc % nt, xc % nt][None] == channels  # [4, nh, nw]
            sums = sums + torch.where(onehot, (val[0] * w)[None], 0.0)
            counts = counts + torch.where(onehot, w[None], 0.0)
    out = torch.where(counts > 0.0, sums / counts, 0.0)
    return out if cfa is not None else out[:components]


def _is_aligned(topleft, topright, bottomleft, nwidth, nheight) -> bool:
    return (int(topright[1]) == int(topleft[1])
            and int(bottomleft[0]) == int(topleft[0])
            and nwidth > 1 and nheight > 1)


def transform_buffer_planar(src_chw: torch.Tensor, width, height, topleft,
                            topright, bottomleft, nwidth, nheight, components,
                            cfa=None) -> torch.Tensor:
    """The resampler on a planar [C, H, W] tensor -> [C', nh, nw] float32
    (C' = 4 with `cfa`, else `components`). Axis-aligned geometry runs the
    eager aligned resampler; a rotated one goes to kernels/rotate.py (the
    CUDA kernel for a CUDA tensor, its plain version on the CPU): its CFA
    route with `cfa`, else the per-channel resample. An output with no
    pixels is an empty tensor on the source's device, and nothing is
    launched (the JAX package's resample returns the empty array)."""
    width, height, nwidth, nheight, components = (
        int(v) for v in (width, height, nwidth, nheight, components))
    if nwidth == 0 or nheight == 0:
        return torch.empty((4 if cfa is not None else components, nheight, nwidth),
                           dtype=torch.float32, device=src_chw.device)
    src_chw = src_chw.to(torch.float32)
    if _is_aligned(topleft, topright, bottomleft, nwidth, nheight):
        g = aligned_axes(width, height, topleft, topright, bottomleft, nwidth, nheight)
        return resample_aligned(src_chw, g, width, height, components, cfa)
    from .kernels import rotate as krot

    if cfa is not None:
        return krot.rotate_resample_cfa(src_chw[:1].contiguous(), width, height, topleft,
                                        topright, bottomleft, nwidth, nheight, cfa)
    return krot.rotate_resample_planar(
        src_chw[:components].contiguous(), width, height, topleft, topright,
        bottomleft, nwidth, nheight, components)


def transform_buffer(src: torch.Tensor, width, height, topleft, topright,
                     bottomleft, nwidth, nheight, components, cfa=None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """The resampler (scaling.rs:51-130) on an interleaved [H, W, C] tensor
    -> [nh, nw, C']; integer outputs truncate and saturate like Rust `as`."""
    src = src if src.dim() == 3 else src[..., None]
    out = transform_buffer_planar(src.to(torch.float32).permute(2, 0, 1), width,
                                  height, topleft, topright, bottomleft, nwidth,
                                  nheight, components, cfa)
    out = out.permute(1, 2, 0)
    if out_dtype == torch.float32:
        return out
    hi = 255.0 if out_dtype == torch.uint8 else 65535.0
    return torch.clamp(torch.trunc(out), 0.0, hi).to(out_dtype)


def scale_down_planar(src_chw: torch.Tensor, nwidth: int, nheight: int,
                      components: int, cfa=None) -> torch.Tensor:
    """Planar [C, H, W] -> [C', nh, nw] float32 scale-down of the whole
    image (C=1 with `cfa`: the fused demosaic-downscale)."""
    _, height, width = (int(v) for v in src_chw.shape)
    g = scale_down_axes(width, height, int(nwidth), int(nheight))
    return resample_aligned(src_chw.to(torch.float32), g, width, height, int(components), cfa)


def scaled_demosaic(cfa, buf: OpBuffer, nwidth: int, nheight: int) -> OpBuffer:
    """Demosaic fused with downscale in one pass (scaling.rs:132-145): each
    output pixel averages its CFA-aware source window."""
    assert buf.colors == 1
    data = transform_buffer_planar(
        buf.data, buf.width, buf.height, (0, 0), (buf.width - 1, 0),
        (0, buf.height - 1), nwidth, nheight, 4, cfa)
    return OpBuffer(nwidth, nheight, 4, buf.monochrome, data)


def scale_down_opbuf(buf: OpBuffer, nwidth: int, nheight: int) -> OpBuffer:
    """Plain 4-channel downscale (scaling.rs:147-160)."""
    assert buf.colors == 4
    data = transform_buffer_planar(
        buf.data, buf.width, buf.height, (0, 0), (buf.width - 1, 0),
        (0, buf.height - 1), nwidth, nheight, 4)
    return OpBuffer(nwidth, nheight, 4, buf.monochrome, data)


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
