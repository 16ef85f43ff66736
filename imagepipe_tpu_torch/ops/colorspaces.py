"""Stages 4 and 6: camera RGBE -> Lab and Lab -> linear sRGB.

Counterpart of `imagepipe_tpu/ops/colorspaces.py` (colorspaces.rs): camera
matrices, white-balance normalization and the interactive white balance
over the Planckian locus (host float math); each stage's transform is one
eager elementwise pass of color.py on the buffer's device, or a stage of a
fused segment (`device_chain`, kernels/suffix.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import ImageOp
from .. import hasher
from ..buffer import OpBuffer
from ..cct import temp_to_xyz, xyz_to_temp
from .. import color as cc

__all__ = ["OpToLab", "OpFromLab", "normalize_wbs"]

_f32 = np.float32


def normalize_wbs(vals):
    """Normalize WB multipliers so green is 1.0; non-finite/zero/subnormal
    entries become 1.0 (colorspaces.rs:12-27)."""
    unity = float(vals[1])
    out = []
    for v in vals:
        v = float(v)
        if not math.isfinite(v) or v == 0.0 or abs(v) < 1.1754944e-38:
            out.append(1.0)
        else:
            out.append(float(_f32(_f32(v) / _f32(unity))))
    return out


def _is_normal(v: float) -> bool:
    return math.isfinite(v) and v != 0.0 and abs(v) >= 1.1754944e-38


class OpToLab(ImageOp):
    NAME = "to_lab"

    def __init__(self, img):
        if img.is_raw:
            raw = img.raw
            wb = [float(v) for v in raw.wb_coeffs]
            if not (_is_normal(wb[0]) and _is_normal(wb[1]) and _is_normal(wb[2])):
                coeffs = normalize_wbs(raw.neutralwb())
            else:
                coeffs = normalize_wbs(wb)
            self.cam_to_xyz = np.asarray(raw.cam_to_xyz(), _f32)
            self.cam_to_xyz_normalized = np.asarray(raw.cam_to_xyz_normalized(), _f32)
            self.xyz_to_cam = np.asarray(raw.xyz_to_cam, _f32)
            self.wb_coeffs = coeffs
        else:
            self.cam_to_xyz = cc.SRGB_D65_43.copy()
            self.cam_to_xyz_normalized = cc.SRGB_D65_43.copy()
            self.xyz_to_cam = cc.XYZ_D65_34.copy()
            self.wb_coeffs = [1.0, 1.0, 1.0, 0.0]

    def serialize_binary(self) -> bytes:
        return (hasher.pack_f32s(self.cam_to_xyz)
                + hasher.pack_f32s(self.cam_to_xyz_normalized)
                + hasher.pack_f32s(self.xyz_to_cam)
                + hasher.pack_f32s(self.wb_coeffs))

    def to_settings_dict(self) -> dict:
        return {
            "cam_to_xyz": [[float(v) for v in row] for row in self.cam_to_xyz],
            "cam_to_xyz_normalized": [[float(v) for v in row] for row in self.cam_to_xyz_normalized],
            "xyz_to_cam": [[float(v) for v in row] for row in self.xyz_to_cam],
            "wb_coeffs": [float(v) for v in self.wb_coeffs],
        }

    def load_settings_dict(self, d: dict) -> None:
        self.cam_to_xyz = np.asarray(d["cam_to_xyz"], _f32)
        self.cam_to_xyz_normalized = np.asarray(d["cam_to_xyz_normalized"], _f32)
        self.xyz_to_cam = np.asarray(d["xyz_to_cam"], _f32)
        self.wb_coeffs = [float(v) for v in d["wb_coeffs"]]

    # Interactive white balance (colorspaces.rs:59-84).

    def set_temp(self, temp: float, tint: float) -> None:
        xyz = temp_to_xyz(temp)
        xyz = [float(xyz[0]), float(xyz[1]) / tint, float(xyz[2])]
        coeffs = []
        for i in range(4):
            acc = _f32(0.0)
            for j in range(3):
                acc = _f32(acc + _f32(self.xyz_to_cam[i][j]) * _f32(xyz[j]))
            coeffs.append(float(_f32(1.0) / acc) if acc != 0 else float("inf"))
        self.wb_coeffs = normalize_wbs(coeffs)

    def get_temp(self) -> tuple[float, float]:
        xyz = [0.0, 0.0, 0.0]
        for i in range(3):
            for j in range(4):
                mul = self.wb_coeffs[j]
                if mul > 0.0:
                    xyz[i] += float(self.cam_to_xyz[i][j]) / mul
        return xyz_to_temp(xyz)

    def _calibration(self, monochrome: bool):
        """(WB multipliers, camera matrix): a monochrome buffer's camera is
        D65 sRGB with unity WB (colorspaces.rs:90-101)."""
        if monochrome:
            return [1.0, 1.0, 1.0, 1.0], cc.SRGB_D65_43
        return normalize_wbs(self.wb_coeffs), self.cam_to_xyz_normalized

    def device_chain(self, globals_, meta):
        w, h, colors, mono = meta
        if colors != 4:
            return None
        mul, cmatrix = self._calibration(mono)
        params = (np.asarray(mul, np.float32), np.asarray(cmatrix, np.float32))
        return (("to_lab", mono), "to_lab", params, (w, h, 3, mono))

    def run(self, globals_, buf: OpBuffer) -> OpBuffer:
        mul, cmatrix = self._calibration(buf.monochrome)
        numerics = cc.resolve_numerics("auto", buf.data.device)
        lab = cc.camera_to_lab_planar(mul, cmatrix, [buf.data[c] for c in range(4)], numerics)
        return OpBuffer(buf.width, buf.height, 3, buf.monochrome, torch.stack(lab))


class OpFromLab(ImageOp):
    NAME = "from_lab"

    def __init__(self, img=None):
        pass

    def serialize_binary(self) -> bytes:
        return b""

    def to_settings_dict(self) -> dict:
        return {}

    def load_settings_dict(self, d: dict) -> None:
        pass

    def device_chain(self, globals_, meta):
        if meta[2] != 3:
            return None
        return (("from_lab",), "from_lab", (cc.XYZ_D65_33,), meta)

    def run(self, globals_, buf: OpBuffer) -> OpBuffer:
        rgb = cc.lab_to_rgb_planar(cc.XYZ_D65_33, (buf.data[0], buf.data[1], buf.data[2]))
        return OpBuffer(buf.width, buf.height, 3, buf.monochrome, torch.stack(rgb))
