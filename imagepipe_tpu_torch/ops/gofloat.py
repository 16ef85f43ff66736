"""Stage 1: ingest to f32 [0,1] with sensor crop and level normalization.

Counterpart of `imagepipe_tpu/ops/gofloat.py` (gofloat.rs). This is the
host->device boundary of the staged pipeline: the sensor plane (or the
raster's planes) is uploaded once per source and device (`sensor_plane`,
`raster_planes`), cropped on the device and normalized in one pass. The
fused develop reads the same crop and levels (engine.py, kernels/).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ImageOp
from .. import color as cc
from .. import hasher
from ..buffer import OpBuffer

__all__ = ["OpGoFloat", "sensor_plane", "raster_planes", "levels"]


def sensor_plane(raw, device) -> torch.Tensor:
    """The RAW's sensor data on `device`, uploaded once per RawImage and
    device. Cached under its own attribute: the JAX package keeps its
    arrays in `_device_plane` / `_pallas_staged`."""
    device = torch.device(device)
    hit = getattr(raw, "_torch_plane", None)
    if hit is not None and hit[0] == device:
        return hit[1]
    plane = torch.from_numpy(np.ascontiguousarray(raw.data)).to(device)
    raw._torch_plane = (device, plane)
    return plane


def raster_planes(raster, bits: int, device) -> torch.Tensor:
    """The raster as planar [3, H, W] u8 (bits 8) or u16 (bits 16) on
    `device`, uploaded once per raster, depth and device."""
    device = torch.device(device)
    key = f"_torch_planes_{bits}"
    hit = getattr(raster, key, None)
    if hit is not None and hit[0] == device:
        return hit[1]
    rgb = raster.to_rgb8() if bits == 8 else raster.to_rgb16()
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(rgb, -1, 0))).to(device)
    setattr(raster, key, (device, planes))
    return planes


def levels(v: torch.Tensor, mins: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """(v - black) / range, clamped to <= 1.0 but not >= 0.0
    (gofloat.rs:101-107,125-127); the fused develop's levels too."""
    return torch.clamp((v - mins) / ranges, max=1.0)


class OpGoFloat(ImageOp):
    NAME = "gofloat"
    FIELDS = ("crop_top", "crop_right", "crop_bottom", "crop_left",
              "is_cfa", "blacklevels", "whitelevels")

    def __init__(self, img):
        if img.is_raw:
            raw = img.raw
            self.crop_top, self.crop_right, self.crop_bottom, self.crop_left = (
                int(c) for c in raw.crops)
            self.is_cfa = raw.cfa.is_valid()
            self.blacklevels = [float(b) for b in raw.blacklevels]
            self.whitelevels = [float(w) for w in raw.whitelevels]
        else:
            self.crop_top = self.crop_right = self.crop_bottom = self.crop_left = 0
            self.is_cfa = False
            self.blacklevels = [0.0] * 4
            self.whitelevels = [0.0] * 4

    def serialize_binary(self) -> bytes:
        return (hasher.pack_u64(self.crop_top) + hasher.pack_u64(self.crop_right)
                + hasher.pack_u64(self.crop_bottom) + hasher.pack_u64(self.crop_left)
                + hasher.pack_bool(self.is_cfa)
                + hasher.pack_f32s(self.blacklevels)
                + hasher.pack_f32s(self.whitelevels))

    def to_settings_dict(self) -> dict:
        return {
            "crop_top": self.crop_top, "crop_right": self.crop_right,
            "crop_bottom": self.crop_bottom, "crop_left": self.crop_left,
            "is_cfa": self.is_cfa,
            "blacklevels": list(self.blacklevels),
            "whitelevels": list(self.whitelevels),
        }

    def load_settings_dict(self, d: dict) -> None:
        for k in ("crop_top", "crop_right", "crop_bottom", "crop_left"):
            setattr(self, k, int(d[k]))
        self.is_cfa = bool(d["is_cfa"])
        self.blacklevels = [float(v) for v in d["blacklevels"]]
        self.whitelevels = [float(v) for v in d["whitelevels"]]

    def transform_forward(self, width, height):
        _, _, w, h = self._size_image(width, height)
        return (w, h)

    # No transform_reverse: sizing is relative to the demosaic scale
    # (gofloat.rs:69-71).

    def _size_image(self, owidth, oheight):
        """Crop clamped so at least a 10x10 image survives (gofloat.rs:74-82)."""
        x = min(self.crop_left, owidth - 10)
        y = min(self.crop_top, oheight - 10)
        width = owidth - min(self.crop_left + self.crop_right, owidth - 10)
        height = oheight - min(self.crop_top + self.crop_bottom, oheight - 10)
        return (x, y, width, height)

    def run(self, globals_, buf: OpBuffer) -> OpBuffer:
        img = globals_.image
        if img.is_raw:
            return self._run_raw(img.raw, globals_.device)
        return self._run_other(img.other, globals_.device)

    def _run_raw(self, raw, device) -> OpBuffer:
        owidth, oheight = raw.width, raw.height
        x, y, width, height = self._size_image(owidth, oheight)
        table = torch.tensor([self.blacklevels, [w - b for w, b in zip(
            self.whitelevels, self.blacklevels)]], dtype=torch.float32)
        mins, ranges = table.to(device)
        data = sensor_plane(raw, device)
        if raw.cpp == 3:
            plane = data.reshape(oheight, owidth, 3)[y:y + height, x:x + width, :].float()
            chans = [levels(plane[..., c], mins[c], ranges[c]) for c in range(3)]
            return OpBuffer(width, height, 4, False,
                            torch.stack(chans + [torch.zeros_like(chans[0])]))
        plane = data.reshape(oheight, owidth)[y:y + height, x:x + width].float()
        v = levels(plane, mins[0], ranges[0])
        if not self.is_cfa:
            return OpBuffer(width, height, 4, True, torch.stack([v, v, v, torch.zeros_like(v)]))
        return OpBuffer(width, height, 1, False, v[None])

    def _run_other(self, raster, device) -> OpBuffer:
        """8-bit rasters lose their sRGB gamma (gofloat.rs:178-187); 16-bit
        ones are scaled by 1/65535 only (gofloat.rs:188-197, as-is)."""
        owidth, oheight = raster.width, raster.height
        x, y, width, height = self._size_image(owidth, oheight)
        bits = raster.bits_per_channel()
        planes = raster_planes(raster, bits, device)[:, y:y + height, x:x + width]
        if bits == 8:
            numerics = cc.resolve_numerics("auto", device)
            chans = [cc.expand_srgb_gamma(cc.input8bit(planes[c]), numerics) for c in range(3)]
        else:
            chans = [cc.input16bit(planes[c]) for c in range(3)]
        return OpBuffer(width, height, 4, False,
                        torch.stack(chans + [torch.zeros_like(chans[0])]))
