"""Stage 5: tone curve on the L channel.

Counterpart of `imagepipe_tpu/ops/curves.py` (curves.rs:5-56), parameter
side. Exposure scales each control point's y by 2^exposure before the
spline is fitted; the develop plan fits it (engine.make_develop_plan).
"""

from __future__ import annotations

from .base import ImageOp
from .. import hasher
from ..spline import SplineFunc

__all__ = ["OpBaseCurve"]


class OpBaseCurve(ImageOp):
    NAME = "basecurve"

    def __init__(self, img):
        self.exposure = 0.0
        if img.is_raw:
            # Default slope from linear raw toward a natural look
            # (curves.rs:14-19).
            self.points = [(0.50, 0.60)]
        else:
            self.points = []

    def serialize_binary(self) -> bytes:
        return hasher.pack_f32(self.exposure) + hasher.pack_pairs(self.points)

    def to_settings_dict(self) -> dict:
        return {"exposure": float(self.exposure),
                "points": [[float(a), float(b)] for a, b in self.points]}

    def load_settings_dict(self, d: dict) -> None:
        self.exposure = float(d["exposure"])
        self.points = [(float(a), float(b)) for a, b in d["points"]]

    def get_spline(self) -> SplineFunc:
        return SplineFunc(self.points)
