"""The plain reference's colour math and its plan.

A frozen copy of the develop chain's arithmetic as the program's source
project defines it (the reference's `color_conversions.rs`, `curves.rs`,
`colorspaces.rs` and rawloader's matrix pseudo-inverse): white balance
clipped at 1, the camera matrix as left-to-right multiply-adds, XYZ -> Lab
with cbrt, the tone spline on L, Lab -> XYZ -> linear sRGB, the sRGB gamma
and the 8-bit quantize. Every transcendental takes its textbook form (cbrt in
float64 rounded once, `pow`), not the program's exp/log form.

The plan (levels, WB multipliers, camera matrix, spline, output size) is
worked out here from what the DNG file states and the edit's settings.
Nothing here reads the program.

`dtype` sets the precision of the pixel math: float32 is the reference,
bfloat16 the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_f32 = np.float32

SRGB_D65_33 = np.array([[0.4124564, 0.3575761, 0.1804375],
                        [0.2126729, 0.7151522, 0.0721750],
                        [0.0193339, 0.1191920, 0.9503041]], _f32)
XW, YW, ZW = 0.95047, 1.0, 1.08883
LAB_E = float(_f32(_f32(216.0) / _f32(24389.0)))
LAB_K = float(_f32(_f32(24389.0) / _f32(27.0)))
LAB_KE = float(_f32(_f32(LAB_K) * _f32(LAB_E)))
XW, YW, ZW = (float(_f32(v)) for v in (XW, YW, ZW))
GAMMA_EXP = float(_f32(1.0) / _f32(2.4))
# The tone curve's default control point for a RAW (curves.rs:14-19).
BASECURVE_POINTS = ((0.50, 0.60),)


def inverse33(m: np.ndarray) -> np.ndarray:
    """3x3 inverse by adjugate in float32."""
    a = m.astype(_f32)
    invdet = _f32(1.0) / (a[0, 0] * (a[1, 1] * a[2, 2] - a[2, 1] * a[1, 2])
                          - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
                          + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]))
    out = np.zeros((3, 3), _f32)
    out[0, 0] = (a[1, 1] * a[2, 2] - a[2, 1] * a[1, 2]) * invdet
    out[0, 1] = -(a[0, 1] * a[2, 2] - a[0, 2] * a[2, 1]) * invdet
    out[0, 2] = (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) * invdet
    out[1, 0] = -(a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0]) * invdet
    out[1, 1] = (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) * invdet
    out[1, 2] = -(a[0, 0] * a[1, 2] - a[1, 0] * a[0, 2]) * invdet
    out[2, 0] = (a[1, 0] * a[2, 1] - a[2, 0] * a[1, 1]) * invdet
    out[2, 1] = -(a[0, 0] * a[2, 1] - a[2, 0] * a[0, 1]) * invdet
    out[2, 2] = (a[0, 0] * a[1, 1] - a[1, 0] * a[0, 1]) * invdet
    return out


XYZ_D65_33 = inverse33(SRGB_D65_33)


def pseudoinverse(inm: np.ndarray) -> np.ndarray:
    """rawloader's 4x3 -> 3x4 pseudo-inverse, float32."""
    inm = inm.astype(_f32)
    temp = np.zeros((3, 6), _f32)
    for i in range(3):
        temp[i, i + 3] = _f32(1.0)
        for j in range(3):
            for k in range(4):
                temp[i, j] += inm[k, i] * inm[k, j]
    for i in range(3):
        temp[i, :] /= temp[i, i].copy()
        for k in range(3):
            if k != i:
                temp[k, :] -= temp[i, :] * temp[k, i].copy()
    out = np.zeros((3, 4), _f32)
    for i in range(4):
        for j in range(3):
            out[j, i] = np.dot(temp[j, 3:6], inm[i, :3]).astype(_f32)
    return out


def camera_matrix(color_matrix_num, den) -> np.ndarray:
    """cam -> XYZ [3, 4] from ColorMatrix1 (XYZ -> cam, 3x3 rationals): its
    rows normalized to sum 1, a zero 4th row, the pseudo-inverse."""
    m = np.zeros((4, 3), _f32)
    m[:3] = np.array([v / den for v in color_matrix_num], _f32).reshape(3, 3)
    for i in range(4):
        s = _f32(m[i, 0] + m[i, 1] + m[i, 2])
        m[i, :] = m[i, :] / s if s != 0.0 else 0.0
    return pseudoinverse(m)


def wb_multipliers(neutral_num, den) -> list[float]:
    """WB multipliers from AsShotNeutral (1 / neutral), normalized to green 1
    in float32; the 4th (absent) is 1."""
    wb = [1.0 / (v / den) for v in neutral_num] + [float("nan")]
    unity = _f32(wb[1])
    out = []
    for v in wb:
        if not math.isfinite(v) or v == 0.0 or abs(v) < 1.1754944e-38:
            out.append(1.0)
        else:
            out.append(float(_f32(_f32(v) / unity)))
    return out


class Spline:
    """Monotone cubic (Fritsch-Carlson) through the control points with
    (0, 0) and (1, 1) anchored, coefficients in float32 (curves.rs:59-116)."""

    def __init__(self, points):
        p = [(float(x), float(y)) for x, y in points]
        pts = []
        if not p or (p[0][0] > 0.0 and p[0][1] > 0.0):
            pts.append((0.0, 0.0))
        pts.extend(p)
        if not p or (p[-1][0] < 1.0 and p[-1][1] < 1.0):
            pts.append((1.0, 1.0))
        xs = np.array([q[0] for q in pts], _f32)
        ys = np.array([q[1] for q in pts], _f32)
        dxs, dys = xs[1:] - xs[:-1], ys[1:] - ys[:-1]
        slopes = dys / dxs
        c1 = [slopes[0]]
        for i in range(len(dxs) - 1):
            m, nxt = slopes[i], slopes[i + 1]
            if m * nxt <= 0.0:
                c1.append(_f32(0.0))
            else:
                common = dxs[i] + dxs[i + 1]
                c1.append(_f32(3.0) * common
                          / ((common + dxs[i + 1]) / m + (common + dxs[i]) / nxt))
        c1.append(slopes[-1])
        c1 = np.array(c1, _f32)
        invdx = _f32(1.0) / dxs
        common = c1[:-1] + c1[1:] - slopes - slopes
        self.xs, self.ys, self.c1 = xs, ys, c1
        self.c2 = ((slopes - c1[:-1] - common) * invdx).astype(_f32)
        self.c3 = (common * invdx * invdx).astype(_f32)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        n = len(self.xs)
        tab = {k: torch.from_numpy(getattr(self, k)[:n - 1].copy()).to(v.device, v.dtype)
               for k in ("xs", "ys", "c1", "c2", "c3")}
        idx = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
        for j in range(1, n):
            idx = idx + (v >= float(self.xs[j])).long()
        idx = idx.clamp(0, n - 2)
        d = v - tab["xs"][idx]
        y = (tab["ys"][idx] + tab["c1"][idx] * d + tab["c2"][idx] * d * d
             + tab["c3"][idx] * d * d * d)
        y = torch.where(v >= float(self.xs[-1]), float(self.ys[-1]), y)
        return torch.where(v <= float(self.xs[0]), float(self.ys[0]), y)


def tone_spline(exposure: float) -> Spline:
    """The base curve with each point's y scaled by 2^exposure."""
    scale = math.pow(2.0, exposure)
    return Spline([(x, y * scale) for x, y in BASECURVE_POINTS])


def _div(v: torch.Tensor, c: float) -> torch.Tensor:
    return v / torch.full((), c, dtype=v.dtype, device=v.device)


def _lab_f(v: torch.Tensor) -> torch.Tensor:
    cb = v.double().clamp(min=0.0).pow(1.0 / 3.0).to(v.dtype)
    return torch.where(v > LAB_E, cb, _div(v * LAB_K + 16.0, 116.0))


def camera_to_lab(planes, mul, cmatrix):
    """RGBE planes -> (L, a, b) in [0, 1] ranges."""
    wb = [torch.clamp(planes[c] * float(mul[c]), max=1.0) for c in range(4)]
    m = [[float(v) for v in row] for row in cmatrix]
    x = ((wb[0] * m[0][0] + wb[1] * m[0][1]) + wb[2] * m[0][2]) + wb[3] * m[0][3]
    y = ((wb[0] * m[1][0] + wb[1] * m[1][1]) + wb[2] * m[1][2]) + wb[3] * m[1][3]
    z = ((wb[0] * m[2][0] + wb[1] * m[2][1]) + wb[2] * m[2][2]) + wb[3] * m[2][3]
    fx, fy, fz = _lab_f(_div(x, XW)), _lab_f(_div(y, YW)), _lab_f(_div(z, ZW))
    return (_div(fy * 116.0 - 16.0, 100.0), _div((fx - fy) * 500.0 + 127.0, 255.0),
            _div((fy - fz) * 200.0 + 127.0, 255.0))


def lab_to_rgb(L, a, b):
    cl, ca, cb = L * 100.0, a * 255.0 - 127.0, b * 255.0 - 127.0
    fy = _div(cl + 16.0, 116.0)
    fx = _div(ca, 500.0) + fy
    fz = fy - _div(cb, 200.0)
    fx3, fz3 = fx * fx * fx, fz * fz * fz
    xr = torch.where(fx3 > LAB_E, fx3, _div(fx * 116.0 - 16.0, LAB_K))
    yr = torch.where(cl > LAB_KE, fy * fy * fy, _div(cl, LAB_K))
    zr = torch.where(fz3 > LAB_E, fz3, _div(fz * 116.0 - 16.0, LAB_K))
    x, y, z = xr * XW, yr * YW, zr * ZW
    m = [[float(v) for v in row] for row in XYZ_D65_33]
    return [(x * m[i][0] + y * m[i][1]) + z * m[i][2] for i in range(3)]


def srgb_gamma(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, 0.0, 1.0)
    hi = torch.pow(v, GAMMA_EXP) * 1.055 - 0.055
    return torch.where(v < 0.0031308, v * 12.92, hi)


def quantize8(v: torch.Tensor) -> torch.Tensor:
    """Truncate v * 256 into [0, 255]."""
    return torch.clamp(v.float() * 256.0, 0.0, 255.0).to(torch.uint8)


def quantize16(v: torch.Tensor) -> torch.Tensor:
    """Round v * 65535 half away from zero into [0, 65535]."""
    scaled = v.float() * 65535.0
    rounded = torch.trunc(scaled + torch.where(scaled >= 0.0, 0.5, -0.5))
    return torch.clamp(rounded, 0.0, 65535.0).to(torch.uint16)


def finish(rgbe, mul, cmatrix, spline: Spline, flips, bits: int = 8) -> torch.Tensor:
    """RGBE planes -> Lab -> spline on L -> Lab^-1 -> gamma -> EXIF flips ->
    8-bit [H', W', 3]; with `bits` 16, linear (no gamma) 16-bit."""
    L, a, b = camera_to_lab(rgbe, mul, cmatrix)
    L = spline(L)
    rgb = lab_to_rgb(L, a, b)
    if bits == 16:
        out = torch.stack([quantize16(c) for c in rgb], dim=-1)
    else:
        out = torch.stack([quantize8(srgb_gamma(c)) for c in rgb], dim=-1)
    return orient(out, flips)


# EXIF orientation -> (transpose, flip_x, flip_y), rawloader's decomposition.
EXIF_FLIPS = {1: (False, False, False), 6: (True, False, True)}


def orient(hwc: torch.Tensor, flips) -> torch.Tensor:
    """Flip x, flip y, then transpose an [H, W, C] image."""
    transpose, flip_x, flip_y = flips
    if flip_x:
        hwc = hwc.flip(1)
    if flip_y:
        hwc = hwc.flip(0)
    return hwc.transpose(0, 1) if transpose else hwc
