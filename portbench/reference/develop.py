"""The plain reference's develop of one RAW frame: levels, the 3x3
neighbour-average demosaic or the CFA-aware demosaic fused with a downscale,
the colour back end, the EXIF flips, 8-bit output.

A frozen copy of the arithmetic of the program's source project
(`demosaic.rs:67-119`, `scaling.rs:8-145`, `gofloat.rs:74-127`), written as
whole-image tensor operations. It is the plain form of what the program's
fused path (`Pipeline.output_8bit(None)`) and its batch engine compute.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import color

_f32 = np.float32

# The 3x3 neighbourhood in the reference's order (demosaic.rs:70-74).
OFFSETS_3X3 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]


def levels(plane: torch.Tensor, black: float, white: float, dtype) -> torch.Tensor:
    """(v - black) / (white - black), clamped above at 1 (not below at 0)."""
    v = plane.to(torch.float32).to(dtype)
    rng = torch.full((), float(white - black), dtype=dtype, device=v.device)
    return torch.clamp((v - float(black)) / rng, max=1.0)


def cfa_colors(grid: np.ndarray, height: int, width: int, device) -> torch.Tensor:
    g = torch.from_numpy(grid).to(device)
    return g[(torch.arange(height, device=device) % g.shape[0])[:, None],
             (torch.arange(width, device=device) % g.shape[1])[None, :]]


def demosaic(v: torch.Tensor, grid: np.ndarray) -> list[torch.Tensor]:
    """[H, W] levels -> four [H, W] planes (R, G, B, E). Each colour is the
    mean of the pixel's 3x3 neighbours of that colour inside the image; the
    pixel's own colour is its own sample; a colour with no neighbour is 0."""
    h, w = v.shape
    colors = cfa_colors(grid, h, w, v.device)
    vp = F.pad(v, (1, 1, 1, 1))
    cp = F.pad(colors, (1, 1, 1, 1), value=-1)
    sums = [torch.zeros_like(v) for _ in range(4)]
    counts = [torch.zeros_like(v) for _ in range(4)]
    for dy, dx in OFFSETS_3X3:
        nv = vp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        nc = cp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        use = (nc >= 0) & ((nc != colors) | (dy == 0 and dx == 0))
        for c in range(3):
            sel = (use & (nc == c)).to(v.dtype)
            sums[c] = sums[c] + nv * sel
            counts[c] = counts[c] + sel
    return [torch.where(counts[c] > 0.0, sums[c] / counts[c], 0.0) for c in range(4)]


# -- size planning and the axis-aligned resample ----------------------------


def scaling_total(width, height, maxwidth, maxheight):
    """(scale, width, height) of fitting inside maxwidth x maxheight (0: no
    limit), float32 arithmetic (scaling.rs:8-32)."""
    if maxwidth == 0 and maxheight == 0:
        return 1.0, width, height
    xs = _f32(1.0) if maxwidth == 0 else _f32(_f32(width) / _f32(maxwidth))
    ys = _f32(1.0) if maxheight == 0 else _f32(_f32(height) / _f32(maxheight))
    if ys <= 1.0 and xs <= 1.0:
        return 1.0, width, height
    if ys > xs:
        return float(ys), int(_f32(width) / ys), maxheight
    return float(xs), maxwidth, int(_f32(height) / xs)


def min_scale(cfa_width: int) -> float:
    """Least downscale at which a window covers every CFA colour."""
    return {2: 2.0, 6: 3.0, 8: 2.0, 12: 12.0}.get(cfa_width, 2.0)


def _sat_floor(v, maxv):
    v = np.floor(v)
    v = np.where(np.isnan(v), 0.0, v)
    return np.clip(v, 0.0, maxv).astype(np.int64)


@dataclass
class Axes:
    from_x: np.ndarray
    to_x: np.ndarray
    cx: np.ndarray
    from_y: np.ndarray
    to_y: np.ndarray
    cy: np.ndarray
    sxx: float
    syy: float
    k_x: int
    k_y: int


def aligned_axes(width, height, topleft, topright, bottomleft, nwidth, nheight) -> Axes:
    """Each output column's source window [from_x, to_x] and centre, each
    row's likewise, in float32 (scaling.rs:69-89)."""
    tl0, tl1 = _f32(topleft[0]), _f32(topleft[1])
    tr0, bl1 = _f32(topright[0]), _f32(bottomleft[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        sxx = _f32((tr0 - tl0) / _f32(nwidth - 1))
        syy = _f32((bl1 - tl1) / _f32(nheight - 1))
        rows, cols = np.arange(nheight, dtype=_f32), np.arange(nwidth, dtype=_f32)
        from_x = _sat_floor(tl0 + sxx * cols, width - 1)
        to_x = _sat_floor(tl0 + sxx * (cols + _f32(1.0)), width - 1)
        from_y = _sat_floor(tl1 + syy * rows, height - 1)
        to_y = _sat_floor(tl1 + syy * (rows + _f32(1.0)), height - 1)
        cx = (((tl0 - _f32(0.5)) + sxx * cols) + (sxx / _f32(2.0))).astype(_f32)
        cy = ((tl1 + syy * rows + (syy / _f32(2.0))) - _f32(0.5)).astype(_f32)
    return Axes(from_x, to_x, cx, from_y, to_y, cy, float(sxx), float(syy),
                max(1, int((to_x - from_x).max()) + 1), max(1, int((to_y - from_y).max()) + 1))


def resample_aligned(planes: torch.Tensor, g: Axes, width, height, grid=None) -> torch.Tensor:
    """Windowed mean with weights max(0, (1 - dx^2) - dy^2) over each output
    pixel's window, per channel of [C, H, W], or with `grid` per CFA colour of
    the single plane [1, H, W] -> [4, nh, nw] (scaling.rs:51-130)."""
    dev, dt = planes.device, planes.dtype
    from_x, to_x = (torch.from_numpy(a).to(dev) for a in (g.from_x, g.to_x))
    from_y, to_y = (torch.from_numpy(a).to(dev) for a in (g.from_y, g.to_y))
    cx = torch.from_numpy(g.cx).to(dev, dt)
    cy = torch.from_numpy(g.cy).to(dev, dt)
    sxx = torch.full((), g.sxx, dtype=dt, device=dev)
    syy = torch.full((), g.syy, dtype=dt, device=dev)
    nh, nw = len(g.from_y), len(g.from_x)
    n = 4 if grid is not None else planes.shape[0]
    sums = torch.zeros((n, nh, nw), dtype=dt, device=dev)
    counts = torch.zeros((n if grid is not None else 1, nh, nw), dtype=dt, device=dev)
    if grid is not None:
        pattern = torch.from_numpy(grid).to(dev)
        channels = torch.arange(4, device=dev)[:, None, None]
    for ky in range(g.k_y):
        y = torch.clamp(from_y + ky, max=height - 1)
        valid_y = (from_y + ky) <= to_y
        dy = (y.to(dt) - cy) / syy
        dy2 = dy * dy
        rows = planes[:, y, :]
        for kx in range(g.k_x):
            x = torch.clamp(from_x + kx, max=width - 1)
            valid_x = (from_x + kx) <= to_x
            dx = (x.to(dt) - cx) / sxx
            factor = (1.0 - dx * dx)[None, :] - dy2[:, None]
            factor = torch.where(factor < 0.0, 0.0, factor)
            w = torch.where(valid_y[:, None] & valid_x[None, :], factor, 0.0)
            sel = rows[:, :, x]
            if grid is None:
                sums = sums + sel * w
                counts = counts + w
                continue
            col = pattern[(y % grid.shape[0])[:, None], (x % grid.shape[1])[None, :]]
            mask = (col[None] == channels).to(dt)
            sums = sums + (sel[0] * w)[None] * mask
            counts = counts + w[None] * mask
    return torch.where(counts > 0.0, sums / counts, 0.0)


def scale_down(planes: torch.Tensor, nwidth, nheight, grid=None) -> torch.Tensor:
    _, h, w = planes.shape
    g = aligned_axes(w, h, (0, 0), (w - 1, 0), (0, h - 1), nwidth, nheight)
    return resample_aligned(planes, g, w, h, grid)


# -- the fused develop --------------------------------------------------------


@dataclass
class Plan:
    """What the develop of one file needs, worked out from its metadata and
    the settings: levels, WB, camera matrix, spline, orientation and the
    demosaic path and size."""
    black: float
    white: float
    grid: np.ndarray
    mul: list
    cmatrix: np.ndarray
    spline: color.Spline
    flips: tuple
    path: str            # 'full' | 'scaled' | 'fulldown'
    dem_w: int
    dem_h: int
    bits: int = 8        # 8: sRGB; 16: linear


def make_plan(meta: dict, exposure: float = 0.0, maxwidth: int = 0, maxheight: int = 0,
              bits: int = 8) -> Plan:
    """meta: the frame's DNG metadata (`synth.Frame` fields: width, height,
    cfa, cfa_dims, black, white, color_matrix, neutral, orientation) with
    `den`, the rationals' denominator, and `exif`, the orientation tag."""
    w, h = meta["width"], meta["height"]
    flips = color.EXIF_FLIPS[meta["exif"]]
    path, dem_w, dem_h = "full", w, h
    if maxwidth or maxheight:
        fw, fh = (h, w) if flips[0] else (w, h)
        _, fw, fh = scaling_total(fw, fh, maxwidth, maxheight)
        dem_w, dem_h = (fh, fw) if flips[0] else (fw, fh)
        scale = scaling_total(w, h, dem_w, dem_h)[0]
        if scale > 1.0:
            path = "scaled" if scale >= min_scale(meta["cfa_dims"][1]) else "fulldown"
    grid = np.array(["RGB".index(c) for c in meta["cfa"]], np.int64).reshape(meta["cfa_dims"])
    return Plan(black=float(meta["black"]), white=float(meta["white"]), grid=grid,
                mul=color.wb_multipliers(meta["neutral"], meta["den"]),
                cmatrix=color.camera_matrix(meta["color_matrix"], meta["den"]),
                spline=color.tone_spline(exposure), flips=flips, path=path,
                dem_w=dem_w, dem_h=dem_h, bits=bits)


def develop(plane: torch.Tensor, plan: Plan, dtype=torch.float32) -> torch.Tensor:
    """Sensor counts [H, W] (u16 or int) -> [H', W', 3] on the plane's device:
    8-bit sRGB, or 16-bit linear where `plan.bits` is 16."""
    v = levels(plane, plan.black, plan.white, dtype)
    if plan.path == "scaled":
        rgbe = list(scale_down(v[None], plan.dem_w, plan.dem_h, plan.grid))
    else:
        rgbe = demosaic(v, plan.grid)
        if plan.path == "fulldown":
            rgbe = list(scale_down(torch.stack(rgbe), plan.dem_w, plan.dem_h))
    return color.finish(rgbe, plan.mul, plan.cmatrix, plan.spline, plan.flips, plan.bits)
