"""Stage 1: ingest to f32 [0,1] with sensor crop and level normalization.

Counterpart of `imagepipe_tpu/ops/gofloat.py` (gofloat.rs), parameter side:
the crop and levels that the develop plan reads. The levels themselves run
inside the develop (engine.py, kernels/develop.py).
"""

from __future__ import annotations

from .base import ImageOp
from .. import hasher

__all__ = ["OpGoFloat"]


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
