"""The plain reference's staged render of one frame under an edit's settings:
size planning through the eight stages, the demosaic stage at the planned
size, rotatecrop's crop and free rotation, then the colour back end.

A frozen copy of the arithmetic of the program's source project
(`pipeline.rs:311-338`, `rotatecrop.rs:39-163`, `scaling.rs:51-130`):
sizes, corners and window indices in float32 host arithmetic, pixels as
whole-image tensor operations. It is the plain form of what
`RenderService.edit` computes, whatever its stage cache holds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import color
from .develop import (aligned_axes, demosaic, levels, make_plan, min_scale, resample_aligned,
                      scale_down, scaling_total)

_f32 = np.float32
EPSILON = 1.0 / 1000000.0
_HALF_PI = _f32(np.pi / 2.0)


class RotateCrop:
    """Fractional crop and free rotation (a quarter turn per unit of
    `rotation`), with the stage's size negotiation (rotatecrop.rs)."""

    def __init__(self, rotation=0.0, crop_left=0.0, crop_top=0.0, crop_right=0.0,
                 crop_bottom=0.0):
        self.rotation, self.crop_left, self.crop_top = rotation, crop_left, crop_top
        self.crop_right, self.crop_bottom = crop_right, crop_bottom
        self.input_ratio = 1.0

    def noop(self) -> bool:
        return all(abs(v) < EPSILON for v in (self.rotation, self.crop_top, self.crop_right,
                                               self.crop_bottom, self.crop_left))

    @staticmethod
    def _round(v):
        v = _f32(v)
        return _f32(np.trunc(v + (_f32(0.5) if v >= 0 else _f32(-0.5))))

    def _angle(self):
        return _f32(_HALF_PI * (_f32(1.0) if self.rotation > 1.0 else _f32(self.rotation)))

    def size(self, owidth, oheight, reverse):
        if self.noop():
            return owidth, oheight
        width, height = _f32(owidth), _f32(oheight)
        if not (reverse or self.rotation < EPSILON):
            a = self._angle()
            sin, cos = _f32(np.sin(a)), _f32(np.cos(a))
            width, height = _f32(width * cos + height * sin), _f32(width * sin + height * cos)
        ratio = _f32(_f32(1.0) - _f32(self.crop_left) - _f32(self.crop_right))
        nwidth = _f32(self._round(width / ratio) if reverse else self._round(width * ratio))
        if ratio < EPSILON or nwidth < 1.0:
            return owidth, oheight
        ratio = _f32(_f32(1.0) - _f32(self.crop_top) - _f32(self.crop_bottom))
        nheight = _f32(self._round(height / ratio) if reverse else self._round(height * ratio))
        if ratio < EPSILON or nheight < 1.0:
            return owidth, oheight
        if reverse and not (self.rotation < EPSILON):
            a = self._angle()
            sin, cos = _f32(np.sin(a)), _f32(np.cos(a))
            ir = _f32(self.input_ratio)
            nwidth = _f32(self._round(nheight / _f32(sin + cos / ir)))
            nheight = _f32(self._round(nwidth / ir))
        return int(nwidth), int(nheight)

    def _reverse_point(self, x, y, width, height, swidth, sheight):
        if self.rotation < EPSILON:
            return int(x), int(y)
        a = self._angle()
        sin, cos = _f32(np.sin(a)), _f32(np.cos(a))
        tx = _f32(_f32(x) - _f32(width) / _f32(2.0))
        ty = _f32(_f32(y) - _f32(height) / _f32(2.0))
        return (int(_f32(tx * cos + ty * sin + _f32(swidth) / _f32(2.0))),
                int(_f32(-tx * sin + ty * cos + _f32(sheight) / _f32(2.0))))

    def geometry(self, width, height):
        """(topleft, topright, bottomleft, nwidth, nheight) of the resample of
        a width x height stage, or None where the stage passes its input."""
        if self.noop():
            return None
        sw, sh = _f32(width), _f32(height)
        nwidth, nheight = self.size(width, height, reverse=False)
        fw, fh = _f32(nwidth), _f32(nheight)
        x = float(np.floor(_f32(sw * _f32(self.crop_left))))
        y = float(np.floor(_f32(sh * _f32(self.crop_top))))
        if x < 0.0 or x > sw or y < 0.0 or y > sh:
            return None
        tl = self._reverse_point(x, y, fw, fh, sw, sh)
        tr = self._reverse_point(_f32(_f32(x) + fw - _f32(1.0)), y, fw, fh, sw, sh)
        bl = self._reverse_point(x, _f32(_f32(y) + fh - _f32(1.0)), fw, fh, sw, sh)
        return tl, tr, bl, nwidth, nheight


def demosaic_size(width, height, rc: RotateCrop, flips, maxwidth=0, maxheight=0):
    """The demosaic stage's size: forward through crop and rotation and the
    orientation, fit into the limits, back again (pipeline.rs:317-338)."""
    rc.input_ratio = float(_f32(_f32(width) / _f32(height)))
    w, h = rc.size(width, height, reverse=False)
    if flips[0]:
        w, h = h, w
    _, w, h = scaling_total(w, h, maxwidth, maxheight)
    if flips[0]:
        w, h = h, w
    return rc.size(w, h, reverse=True)


def _bound(a, b, width, height) -> int:
    s = sum(0.0 if not math.isfinite(float(v)) else abs(float(v)) for v in (a, b))
    return max(1, min(int(math.ceil(s)) + 2, max(width, height)))


def _sat_idx(v: torch.Tensor, maxv: int) -> torch.Tensor:
    v = torch.where(torch.isnan(v), 0.0, v)
    return torch.clamp(torch.floor(v), 0.0, float(maxv)).to(torch.int64)


def resample_rotated(planes: torch.Tensor, width, height, tl, tr, bl, nwidth, nheight):
    """The windowed-mean resample of [C, H, W] along a rotated geometry: each
    output pixel's window is bounded by the float32 images of its cell's
    corners (scaling.rs:51-130) -> [C, nh, nw]."""
    dev, dt = planes.device, planes.dtype
    tl0, tl1, tr0, tr1 = (_f32(v) for v in (tl[0], tl[1], tr[0], tr[1]))
    bl0, bl1 = _f32(bl[0]), _f32(bl[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        sxx = _f32((tr0 - tl0) / _f32(nwidth - 1))
        sxy = _f32((tr1 - tl1) / _f32(nwidth - 1))
        syx = _f32((bl0 - tl0) / _f32(nheight - 1))
        syy = _f32((bl1 - tl1) / _f32(nheight - 1))
    r = np.arange(nheight, dtype=_f32)
    c = np.arange(nwidth, dtype=_f32)
    one, half, two = _f32(1.0), _f32(0.5), _f32(2.0)
    with np.errstate(invalid="ignore", over="ignore"):
        rows = np.stack([tl1 + syy * r, tl1 + syy * (r + one), tl0 + syx * r,
                         tl0 + syx * (r + one), tl1 + syy * r + (syy / two) - half,
                         tl0 + syx * r + (syx / two) - half]).astype(_f32)
        cols = np.stack([sxy * c, sxy * (c + one), sxx * c, sxx * (c + one),
                         sxy * c + (sxy / two), sxx * c + (sxx / two)]).astype(_f32)
    k_x, k_y = _bound(sxx, syx, width, height), _bound(sxy, syy, width, height)
    rows_t, cols_t = torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)

    def pixel(i):
        return rows_t[i][:, None] + cols_t[i][None, :]

    from_y, to_y = _sat_idx(pixel(0), height - 1), _sat_idx(pixel(1), height - 1)
    from_x, to_x = _sat_idx(pixel(2), width - 1), _sat_idx(pixel(3), width - 1)
    centre_y, centre_x = pixel(4).to(dt), pixel(5).to(dt)
    sxx_t = torch.full((), float(sxx), dtype=dt, device=dev)
    syy_t = torch.full((), float(syy), dtype=dt, device=dev)
    flat = planes.reshape(planes.shape[0], -1)
    sums = torch.zeros((planes.shape[0], nheight, nwidth), dtype=dt, device=dev)
    counts = torch.zeros((1, nheight, nwidth), dtype=dt, device=dev)
    for ky in range(k_y):
        y = from_y + ky
        valid_y = y <= to_y
        yc = torch.clamp(y, max=height - 1)
        dy = (y.to(dt) - centre_y) / syy_t
        dy2 = dy * dy
        for kx in range(k_x):
            x = from_x + kx
            xc = torch.clamp(x, max=width - 1)
            dx = (x.to(dt) - centre_x) / sxx_t
            factor = (1.0 - dx * dx) - dy2
            factor = torch.where(factor < 0.0, 0.0, factor)
            w = torch.where(valid_y & (x <= to_x), factor, 0.0)
            sums = sums + flat[:, yc * width + xc] * w
            counts = counts + w
    return torch.where(counts > 0.0, sums / counts, 0.0)


def render(plane: torch.Tensor, meta: dict, settings: dict, dtype=torch.float32,
           bits: int = 8) -> torch.Tensor:
    """Sensor counts [H, W] -> the staged render's [H', W', 3] under `settings`
    ({"exposure", "rotation", "crop_left", ...}, defaults 0): 8-bit sRGB, or
    16-bit linear where `bits` is 16."""
    plan = make_plan(meta, exposure=settings.get("exposure", 0.0), bits=bits)
    rc = RotateCrop(**{k: settings.get(k, 0.0) for k in
                       ("rotation", "crop_left", "crop_top", "crop_right", "crop_bottom")})
    width, height = meta["width"], meta["height"]
    dem_w, dem_h = demosaic_size(width, height, rc, plan.flips)
    v = levels(plane, plan.black, plan.white, dtype)
    scale = scaling_total(width, height, dem_w, dem_h)[0]
    if scale >= min_scale(plan.grid.shape[1]):
        stage = scale_down(v[None], dem_w, dem_h, plan.grid)
    else:
        stage = torch.stack(demosaic(v, plan.grid))
        if scale > 1.0:
            stage = scale_down(stage, dem_w, dem_h)
    del v
    sh, sw = stage.shape[1:]
    g = rc.geometry(sw, sh)
    if g is not None:
        tl, tr, bl, nw, nh = g
        if int(tr[1]) == int(tl[1]) and int(bl[0]) == int(tl[0]) and nw > 1 and nh > 1:
            stage = resample_aligned(stage, aligned_axes(sw, sh, tl, tr, bl, nw, nh), sw, sh)
        else:
            stage = resample_rotated(stage, sw, sh, tl, tr, bl, nw, nh)
    return color.finish(list(stage), plan.mul, plan.cmatrix, plan.spline, plan.flips, plan.bits)
