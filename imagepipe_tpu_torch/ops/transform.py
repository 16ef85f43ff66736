"""Stage 8: orientation fix (90-degree rotations and flips).

Counterpart of `imagepipe_tpu/ops/transform.py` (transform.rs), parameter
side: the EXIF orientation as a rotation plus user flips, composed into
the (transpose, flip_x, flip_y) the develop applies to its planar output.
"""

from __future__ import annotations

import enum

from .base import ImageOp
from .. import hasher
from ..raw import Orientation

__all__ = ["Rotation", "OpTransform"]


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

    def transform_forward(self, width, height):
        if self.rotation in (Rotation.Rotate90, Rotation.Rotate270):
            return (height, width)
        return (width, height)

    def transform_reverse(self, width, height):
        return self.transform_forward(width, height)
