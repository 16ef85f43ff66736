"""Stage 2: CFA -> RGBE, fused with downscale where possible.

Counterpart of `imagepipe_tpu/ops/demosaic.py` (demosaic.rs). Path
selection (demosaic.rs:41-60) is host logic: a 4-channel input passes
through or is downscaled; a CFA input at or beyond the CFA's minimum scale
takes the fused scaled demosaic (full-resolution RGB never exists), else
the full-resolution 3x3 stencil demosaic, then a downscale if asked.
"""

from __future__ import annotations

from .base import ImageOp
from .. import hasher
from .. import scaling
from ..buffer import OpBuffer
from ..kernels.demosaic_full import demosaic_full
from ..raw import CFA

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

    def run(self, globals_, buf: OpBuffer) -> OpBuffer:
        nwidth = globals_.settings.demosaic_width
        nheight = globals_.settings.demosaic_height
        scale = scaling.calculate_scale(buf.width, buf.height, nwidth, nheight)
        cfa = CFA(self.cfa)
        if scale <= 1.0 and buf.colors == 4:
            return buf
        if buf.colors == 4:
            return scaling.scale_down_opbuf(buf, nwidth, nheight)
        if scale >= minscale_for(cfa.width):
            return scaling.scaled_demosaic(cfa, buf, nwidth, nheight)
        fullsize = demosaic_full(cfa, buf)
        if scale > 1.0:
            return scaling.scale_down_opbuf(fullsize, nwidth, nheight)
        return fullsize
