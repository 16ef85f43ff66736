"""Stage 2: CFA -> RGBE.

Counterpart of `imagepipe_tpu/ops/demosaic.py` (demosaic.rs), parameter
side: the crop-anchored CFA the develop demosaics with, and the minimum
scale of the fused scaled demosaic that size planning uses.
"""

from __future__ import annotations

from .base import ImageOp
from .. import hasher

__all__ = ["OpDemosaic", "minscale_for"]


def minscale_for(cfa_width: int) -> float:
    """Minimum downscale at which every output pixel covers all CFA colours
    (demosaic.rs:33-39)."""
    return {2: 2.0, 6: 3.0, 8: 2.0, 12: 12.0}.get(cfa_width, 2.0)


class OpDemosaic(ImageOp):
    NAME = "demosaic"

    def __init__(self, img):
        if img.is_raw:
            self.cfa = str(img.raw.cropped_cfa())
        else:
            self.cfa = ""

    def serialize_binary(self) -> bytes:
        return hasher.pack_str(self.cfa)

    def to_settings_dict(self) -> dict:
        return {"cfa": self.cfa}

    def load_settings_dict(self, d: dict) -> None:
        self.cfa = str(d["cfa"] or "")
