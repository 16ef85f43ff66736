"""Stage 8: orientation fix (90-degree rotations and flips).

Counterpart of `imagepipe_tpu/ops/transform.py` (transform.rs): the EXIF
orientation as a rotation plus user flips, composed into (transpose,
flip_x, flip_y). `apply_flips` applies them to a planar buffer or output:
flip copies, then a transposed view. The staged run, the eager engine and
the kernels' wrappers all flip with it.
"""

from __future__ import annotations

import enum

import torch

from .base import ImageOp
from .. import hasher
from ..buffer import OpBuffer
from ..raw import Orientation

__all__ = ["Rotation", "OpTransform", "rotate_buffer", "apply_flips"]


class Rotation(enum.Enum):
    Normal = "Normal"
    Rotate90 = "Rotate90"
    Rotate180 = "Rotate180"
    Rotate270 = "Rotate270"


_ROT_TO_ORIENT = {
    Rotation.Normal: Orientation.Normal,
    Rotation.Rotate90: Orientation.Rotate90,
    Rotation.Rotate180: Orientation.Rotate180,
    Rotation.Rotate270: Orientation.Rotate270,
}
_ROT_INDEX = {r: i for i, r in enumerate(Rotation)}

# EXIF orientation -> rotation + flips (transform.rs:24-41).
_FROM_EXIF = {
    Orientation.Normal: (Rotation.Normal, False, False),
    Orientation.Unknown: (Rotation.Normal, False, False),
    Orientation.VerticalFlip: (Rotation.Normal, False, True),
    Orientation.HorizontalFlip: (Rotation.Normal, True, False),
    Orientation.Rotate180: (Rotation.Rotate180, False, False),
    Orientation.Transpose: (Rotation.Rotate90, False, True),
    Orientation.Rotate90: (Rotation.Rotate90, False, False),
    Orientation.Rotate270: (Rotation.Rotate270, False, False),
    Orientation.Transverse: (Rotation.Rotate270, True, False),
}


def apply_flips(out: torch.Tensor, orientation_flips) -> torch.Tensor:
    """EXIF orientation on planar [..., 3, H, W] output: flip x, flip y,
    then transpose (engine.py:243-252 of the JAX package). The flips copy
    (torch has no negative strides); u16 flips through an int16 view, as
    torch has no u16 flip."""
    transpose, flip_x, flip_y = orientation_flips
    dims = [d for d, on in ((-1, flip_x), (-2, flip_y)) if on]
    if dims:
        if out.dtype == torch.uint16:
            out = out.view(torch.int16).flip(dims).view(torch.uint16)
        else:
            out = out.flip(dims)
    if transpose:
        out = out.transpose(-1, -2)
    return out


def rotate_buffer(buf: OpBuffer, orientation: Orientation) -> OpBuffer:
    """Apply an EXIF orientation (transform.rs:87-144) to a 3-channel
    buffer: out[r, c] = in[...] with flip_x, flip_y, then the transpose."""
    assert buf.colors == 3
    if orientation in (Orientation.Normal, Orientation.Unknown):
        return buf
    transpose, flip_x, flip_y = orientation.to_flips()
    data = apply_flips(buf.data, (transpose, flip_x, flip_y))
    if transpose:
        return OpBuffer(buf.height, buf.width, 3, buf.monochrome, data)
    return OpBuffer(buf.width, buf.height, 3, buf.monochrome, data)


class OpTransform(ImageOp):
    NAME = "transform"

    def __init__(self, img):
        if img.is_raw:
            self.rotation, self.fliph, self.flipv = _FROM_EXIF[img.raw.orientation]
        else:
            self.rotation, self.fliph, self.flipv = Rotation.Normal, False, False

    def serialize_binary(self) -> bytes:
        return (hasher.pack_enum(_ROT_INDEX[self.rotation])
                + hasher.pack_bool(self.fliph) + hasher.pack_bool(self.flipv))

    def to_settings_dict(self) -> dict:
        return {"rotation": self.rotation.value,
                "fliph": self.fliph, "flipv": self.flipv}

    def load_settings_dict(self, d: dict) -> None:
        self.rotation = Rotation(d["rotation"])
        self.fliph = bool(d["fliph"])
        self.flipv = bool(d["flipv"])

    def _orientation(self) -> Orientation:
        # Compose base rotation with user flips (transform.rs:57-66).
        f1, f2, f3 = _ROT_TO_ORIENT[self.rotation].to_flips()
        return Orientation.from_flips((f1, f2 != self.fliph, f3 != self.flipv))

    def device_chain(self, globals_, meta):
        w, h, colors, mono = meta
        orientation = self._orientation()
        if orientation in (Orientation.Normal, Orientation.Unknown):
            return (("transform", None), None, (), meta)
        if colors != 3:
            return None
        flips = orientation.to_flips()
        out_meta = (h, w, 3, mono) if flips[0] else meta
        return (("transform", *flips), "transform", flips, out_meta)

    def run(self, globals_, buf: OpBuffer) -> OpBuffer:
        orientation = self._orientation()
        if orientation in (Orientation.Normal, Orientation.Unknown):
            return buf
        return rotate_buffer(buf, orientation)

    def transform_forward(self, width, height):
        if self.rotation in (Rotation.Rotate90, Rotation.Rotate270):
            return (height, width)
        return (width, height)

    def transform_reverse(self, width, height):
        return self.transform_forward(width, height)
