"""Colour math in PyTorch: matrices, LUT-or-direct transforms, quantizers.

Counterpart of `imagepipe_tpu/color.py`. The constants are the same numpy
float32 arrays (that file imports JAX at the top, so they are rebuilt here
by the same code). Every transform is a plain function on float32 tensors
of any shape; the numerics mode is an explicit argument:

  * "lut"    -- the reference's 8193-entry linearly interpolated tables,
                exact function outside [0, 1] (the CPU default);
  * "direct" -- cbrt and pow as exp(log(x) * k) with the same guards as
                the develop kernel (the CUDA default). The kernel and this
                eager form must compute identical transcendental shapes:
                mismatched forms exceed 10 LSB at 16-bit output.

The staged ops resolve 'auto' through `resolve_numerics`: the process-wide
override of `set_numerics_mode` / `numerics_mode` when one is set, else
the buffer's device. The fused develop and the batch engine resolve
through `device_numerics`, by device alone, as the JAX package's plans
resolve by backend.

Divisions by constants go through `_div`: CUDA turns `tensor / python
float` into a multiply by the reciprocal, which is not IEEE division.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SRGB_D65_33", "SRGB_D65_XYZ_WHITE", "XYZ_D65_33", "XYZ_D65_34",
    "SRGB_D65_43", "TransformLUT", "set_numerics_mode", "get_numerics_mode",
    "numerics_mode", "device_numerics", "resolve_numerics", "expand_srgb_gamma",
    "apply_srgb_gamma", "xyz_to_lab", "lab_to_xyz", "camera_to_lab_planar",
    "lab_to_rgb_planar", "camera_to_lab", "lab_to_rgb", "temp_tint_to_rgb",
    "input8bit", "input16bit", "output8bit", "output16bit",
]

_f32 = np.float32


def _inverse33(m: np.ndarray) -> np.ndarray:
    """3x3 inverse by adjugate in float32 (color_conversions.rs:20-39), so
    the derived XYZ->RGB matrix is bit-identical to the JAX package's."""
    m = m.astype(_f32)
    invdet = _f32(1.0) / (
        m[0, 0] * (m[1, 1] * m[2, 2] - m[2, 1] * m[1, 2])
        - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
        + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0])
    )
    out = np.zeros((3, 3), dtype=_f32)
    out[0, 0] = (m[1, 1] * m[2, 2] - m[2, 1] * m[1, 2]) * invdet
    out[0, 1] = -(m[0, 1] * m[2, 2] - m[0, 2] * m[2, 1]) * invdet
    out[0, 2] = (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * invdet
    out[1, 0] = -(m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0]) * invdet
    out[1, 1] = (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * invdet
    out[1, 2] = -(m[0, 0] * m[1, 2] - m[1, 0] * m[0, 2]) * invdet
    out[2, 0] = (m[1, 0] * m[2, 1] - m[2, 0] * m[1, 1]) * invdet
    out[2, 1] = -(m[0, 0] * m[2, 1] - m[2, 0] * m[0, 1]) * invdet
    out[2, 2] = (m[0, 0] * m[1, 1] - m[1, 0] * m[0, 1]) * invdet
    return out


# Constant matrices (color_conversions.rs:1-17).
SRGB_D65_33 = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=_f32,
)
SRGB_D65_XYZ_WHITE = (_f32(0.95047), _f32(1.000), _f32(1.08883))
XYZ_D65_33 = _inverse33(SRGB_D65_33)
XYZ_D65_34 = np.concatenate([XYZ_D65_33, np.zeros((1, 3), dtype=_f32)], axis=0)
SRGB_D65_43 = np.concatenate([SRGB_D65_33, np.zeros((3, 1), dtype=_f32)], axis=1)

# CIE Lab constants (color_conversions.rs:121-123, 181-182).
_LAB_E = _f32(_f32(216.0) / _f32(24389.0))
_LAB_K = _f32(_f32(24389.0) / _f32(27.0))

# Python floats holding the float32 values: torch casts a Python scalar to
# the tensor's float32 exactly, while numpy scalars must stay off tensors.
LAB_E = float(_LAB_E)
LAB_K = float(_LAB_K)
LAB_KE = float(_f32(_LAB_K * _LAB_E))
XW, YW, ZW = (float(v) for v in SRGB_D65_XYZ_WHITE)

_MAXBITS = 13
_LUT_MAX = (1 << _MAXBITS) - 1  # 8191


# The process-wide numerics override (None: unset). The JAX package
# resolves its unset mode once, from the backend; here an unset mode
# resolves per device, so the override stays None until a caller sets it.
_NUMERICS_MODE: str | None = None


def set_numerics_mode(mode: str) -> None:
    """Override 'auto' numerics for the staged ops and fused segments of
    this process: 'lut' or 'direct'."""
    global _NUMERICS_MODE
    if mode not in ("lut", "direct"):
        raise ValueError(f"unknown numerics mode {mode!r}")
    _NUMERICS_MODE = mode


def get_numerics_mode(device=None) -> str:
    """The override when one is set, else what 'auto' resolves to on
    `device` (None: 'cuda' when torch sees a CUDA device, else 'cpu', the
    JAX package's default backend)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return resolve_numerics("auto", device)


class numerics_mode:
    """Context manager setting the numerics override, restoring the
    previous OVERRIDE on exit, "unset" included. The JAX package restores
    its previous resolved mode ("never restore None"), harmless there
    because its unset mode resolves to one backend value; here the unset
    mode resolves per device, so restoring a resolved value would pin every
    later 'auto' of the other device kind."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        global _NUMERICS_MODE
        self._prev = _NUMERICS_MODE
        set_numerics_mode(self.mode)
        return self

    def __exit__(self, *exc):
        global _NUMERICS_MODE
        _NUMERICS_MODE = self._prev
        return False


def device_numerics(numerics: str, device) -> str:
    """'auto' -> 'lut' on the CPU (reference-faithful tables) and 'direct'
    on CUDA (the kernels' form); 'lut' and 'direct' pass. The override is
    not consulted: the fused develop plan and the batch engine resolve
    here, as the JAX package's plans resolve by backend."""
    if numerics == "auto":
        return "lut" if torch.device(device).type == "cpu" else "direct"
    if numerics not in ("lut", "direct"):
        raise ValueError(f"unknown numerics mode {numerics!r}")
    return numerics


def resolve_numerics(numerics: str, device) -> str:
    """'auto' -> the override when one is set, else `device_numerics`;
    'lut' and 'direct' pass. The staged ops and fused segments resolve
    here, where the JAX package consults `get_numerics_mode()`."""
    if numerics == "auto" and _NUMERICS_MODE is not None:
        return _NUMERICS_MODE
    return device_numerics(numerics, device)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as IEEE division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


class TransformLUT:
    """A [0,1]->f32 transform backed by an 8193-entry table with linear
    interpolation inside [0,1] and the exact function outside
    (TransformLookup, color_conversions.rs:80-115). Entry i holds
    transform(i / 8191), computed in float32 by numpy."""

    def __init__(self, np_transform, direct, reference):
        idx = np.arange(_LUT_MAX + 2, dtype=np.int64)
        v = idx.astype(_f32) / _f32(_LUT_MAX)
        self.table_np = np_transform(v).astype(_f32)
        self._direct = direct
        # lut mode's out-of-range fallback keeps the reference's own forms
        # (cbrt / powf); only direct mode sees the exp/log rewrite.
        self._reference = reference
        self._tables: dict[torch.device, torch.Tensor] = {}

    def _table(self, device: torch.device) -> torch.Tensor:
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.from_numpy(self.table_np).to(device)
        return t

    def __call__(self, val: torch.Tensor, numerics: str) -> torch.Tensor:
        if numerics == "direct":
            return self._direct(val)
        # lookup(): pos = val*8191, key = trunc(pos), lerp table[key..key+1].
        pos = val * float(_LUT_MAX)
        base = torch.trunc(pos)
        key = base.clamp(0, _LUT_MAX).nan_to_num(0.0).long()
        a = pos - base
        table = self._table(val.device)
        v1 = table[key]
        v2 = table[key + 1]
        lerp = v1 + a * (v2 - v1)
        in_range = (val >= 0.0) & (val <= 1.0)
        return torch.where(in_range, lerp, self._reference(val))


def _np_xyz_lab_f(v):
    v = v.astype(_f32)
    cb = np.cbrt(v).astype(_f32)
    lin = ((_LAB_K * v + _f32(16.0)) / _f32(116.0)).astype(_f32)
    return np.where(v > _LAB_E, cb, lin)


def _lab_linear(v):
    return _div(v * LAB_K + 16.0, 116.0)


def _xyz_lab_f_ref(v):
    # cbrt evaluated in float64 and rounded once: torch has no cbrt, and a
    # float32 pow(x, 1/3) is off by the rounding of the exponent.
    cb = v.double().clamp(min=0.0).pow(1.0 / 3.0).to(v.dtype)
    return torch.where(v > LAB_E, cb, _lab_linear(v))


def _xyz_lab_f(v):
    cb = torch.exp(torch.log(torch.clamp(v, min=1e-30)) * (1.0 / 3.0))
    return torch.where(v > LAB_E, cb, _lab_linear(v))


def _np_srgb_expand(v):
    v = v.astype(_f32)
    lo = (v / _f32(12.92)).astype(_f32)
    hi = np.power((v + _f32(0.055)) / _f32(1.055), _f32(2.4)).astype(_f32)
    return np.where(v < _f32(0.04045), lo, hi)


_GAMMA_EXP = float(_f32(2.4))


def _srgb_expand_ref(v):
    safe = torch.clamp(v, min=-0.054)
    hi = torch.pow(_div(safe + 0.055, 1.055), _GAMMA_EXP)
    return torch.where(v < 0.04045, _div(v, 12.92), hi)


def _srgb_expand(v):
    # Guard against non-positive bases (the branch selects hi only for
    # v >= 0.04045); the exp/log form of the other direct transforms.
    safe = torch.clamp(v, min=-0.054)
    hi = torch.exp(torch.log(torch.clamp(_div(safe + 0.055, 1.055), min=1e-30)) * _GAMMA_EXP)
    return torch.where(v < 0.04045, _div(v, 12.92), hi)


def _np_srgb_apply(v):
    v = v.astype(_f32)
    lo = (v * _f32(12.92)).astype(_f32)
    hi = (_f32(1.055) * np.power(np.maximum(v, _f32(0.0)), _f32(1.0) / _f32(2.4)) - _f32(0.055)).astype(_f32)
    return np.where(v < _f32(0.0031308), lo, hi)


def _srgb_apply_ref(v):
    hi = torch.pow(torch.clamp(v, min=0.0), float(_f32(1.0) / _f32(2.4))) * 1.055 - 0.055
    return torch.where(v < 0.0031308, v * 12.92, hi)


def _srgb_apply(v):
    hi = torch.exp(torch.log(torch.clamp(v, min=1e-30)) * (1.0 / 2.4)) * 1.055 - 0.055
    return torch.where(v < 0.0031308, v * 12.92, hi)


XYZ_LAB_TRANSFORM = TransformLUT(_np_xyz_lab_f, _xyz_lab_f, _xyz_lab_f_ref)
SRGB_GAMMA_REVERSE = TransformLUT(_np_srgb_expand, _srgb_expand, _srgb_expand_ref)
SRGB_GAMMA_TRANSFORM = TransformLUT(_np_srgb_apply, _srgb_apply, _srgb_apply_ref)


def expand_srgb_gamma(v: torch.Tensor, numerics: str) -> torch.Tensor:
    """Remove sRGB gamma (color_conversions.rs:144-147)."""
    return SRGB_GAMMA_REVERSE(v, numerics)


def apply_srgb_gamma(v: torch.Tensor, numerics: str) -> torch.Tensor:
    """Apply sRGB gamma (color_conversions.rs:149-153)."""
    return SRGB_GAMMA_TRANSFORM(v, numerics)


# XYZ <-> Lab (color_conversions.rs:155-191). Lab components are re-ranged
# into [0,1]: L/100, (a+127)/255, (b+127)/255.

def xyz_to_lab(x, y, z, numerics: str):
    fx = XYZ_LAB_TRANSFORM(_div(x, XW), numerics)
    fy = XYZ_LAB_TRANSFORM(_div(y, YW), numerics)
    fz = XYZ_LAB_TRANSFORM(_div(z, ZW), numerics)
    l = fy * 116.0 - 16.0
    a = (fx - fy) * 500.0
    b = (fy - fz) * 200.0
    return _div(l, 100.0), _div(a + 127.0, 255.0), _div(b + 127.0, 255.0)


def lab_to_xyz(l, a, b):
    cl = l * 100.0
    ca = (a * 255.0) - 127.0
    cb = (b * 255.0) - 127.0

    fy = _div(cl + 16.0, 116.0)
    fx = _div(ca, 500.0) + fy
    fz = fy - _div(cb, 200.0)

    fx3 = fx * fx * fx
    xr = torch.where(fx3 > LAB_E, fx3, _div(fx * 116.0 - 16.0, LAB_K))
    yr = torch.where(cl > LAB_KE, fy * fy * fy, _div(cl, LAB_K))
    fz3 = fz * fz * fz
    zr = torch.where(fz3 > LAB_E, fz3, _div(fz * 116.0 - 16.0, LAB_K))
    return xr * XW, yr * YW, zr * ZW


def _matrix(m, device) -> torch.Tensor:
    if torch.is_tensor(m):
        return m.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(m, _f32), device=device)


def camera_to_lab_planar(mul, cmatrix, planes, numerics: str):
    """WB multiply (clipped to 1.0), 3x4 camera matrix, XYZ->Lab on planes
    (r, g, b, e) -> (L, a, b). The products are per-channel multiply-adds
    in the reference's left-to-right order (color_conversions.rs:50-52),
    never a matmul."""
    dev = planes[0].device
    mul = _matrix(mul, dev)
    m = _matrix(cmatrix, dev)
    wb = [torch.clamp(planes[c] * mul[c], max=1.0) for c in range(4)]
    x = ((wb[0] * m[0, 0] + wb[1] * m[0, 1]) + wb[2] * m[0, 2]) + wb[3] * m[0, 3]
    y = ((wb[0] * m[1, 0] + wb[1] * m[1, 1]) + wb[2] * m[1, 2]) + wb[3] * m[1, 3]
    z = ((wb[0] * m[2, 0] + wb[1] * m[2, 1]) + wb[2] * m[2, 2]) + wb[3] * m[2, 3]
    return xyz_to_lab(x, y, z, numerics)


def lab_to_rgb_planar(rgbmatrix, lab_planes):
    """(L, a, b) -> Lab^-1 -> 3x3 -> linear (r, g, b)."""
    m = _matrix(rgbmatrix, lab_planes[0].device)
    x, y, z = lab_to_xyz(lab_planes[0], lab_planes[1], lab_planes[2])
    r = (x * m[0, 0] + y * m[0, 1]) + z * m[0, 2]
    g = (x * m[1, 0] + y * m[1, 1]) + z * m[1, 2]
    b = (x * m[2, 0] + y * m[2, 1]) + z * m[2, 2]
    return r, g, b


def camera_to_lab(mul, cmatrix, pix: torch.Tensor, numerics: str) -> torch.Tensor:
    """`camera_to_lab_planar` on pixels [..., 4] -> [..., 3]
    (color_conversions.rs:41-56)."""
    lab = camera_to_lab_planar(mul, cmatrix, pix.unbind(-1), numerics)
    return torch.stack(lab, dim=-1)


def lab_to_rgb(rgbmatrix, pix: torch.Tensor) -> torch.Tensor:
    """`lab_to_rgb_planar` on pixels [..., 3] -> [..., 3]
    (color_conversions.rs:58-65)."""
    return torch.stack(lab_to_rgb_planar(rgbmatrix, pix.unbind(-1)), dim=-1)


def temp_tint_to_rgb(temp: float, tint: float) -> tuple[float, float, float]:
    """The linear RGB of a colour temperature and tint, a host-side preview
    colour (color_conversions.rs:67-77)."""
    from .cct import temp_to_xyz

    xyz = temp_to_xyz(temp)
    x, y, z = xyz[0], xyz[1] / tint, xyz[2]
    m = XYZ_D65_33
    r = x * m[0, 0] + y * m[0, 1] + z * m[0, 2]
    g = x * m[1, 0] + y * m[1, 1] + z * m[1, 2]
    b = x * m[2, 0] + y * m[2, 1] + z * m[2, 2]
    return float(r), float(g), float(b)


# Quantizers (color_conversions.rs:312-330): input8bit and input16bit scale
# to [0, 1], output8bit truncates v*256, output16bit rounds half away from
# zero.

def input8bit(v: torch.Tensor) -> torch.Tensor:
    return _div(v.float(), 255.0)


def input16bit(v: torch.Tensor) -> torch.Tensor:
    return _div(v.float(), 65535.0)


def output8bit(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v * 256.0, 0.0, 255.0).to(torch.uint8)


def output16bit(v: torch.Tensor) -> torch.Tensor:
    scaled = v * 65535.0
    half = torch.where(scaled >= 0.0, 0.5, -0.5)
    rounded = torch.trunc(scaled + half)
    return torch.clamp(rounded, 0.0, 65535.0).to(torch.uint16)
