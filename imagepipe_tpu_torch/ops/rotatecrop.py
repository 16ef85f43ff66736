"""Stage 3: user fractional crop + free rotation.

Counterpart of `imagepipe_tpu/ops/rotatecrop.py` (rotatecrop.rs),
parameter side: fields, the no-op test, and the stateful size negotiation
(output size committed during the reverse planning pass,
rotatecrop.rs:66-85) in float32. The resampler that applies a non-noop
crop or rotation is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import logging

import numpy as np

from .base import ImageOp
from .. import hasher

__all__ = ["OpRotateCrop"]

log = logging.getLogger(__name__)

# Sub-1-per-million crops/magnifications are no-ops (rotatecrop.rs:4-7).
EPSILON = 1.0 / 1000000.0

_f32 = np.float32
_FRAC_PI_2 = _f32(np.pi / 2.0)


class OpRotateCrop(ImageOp):
    NAME = "rotatecrop"

    def __init__(self, img=None):
        self.crop_top = 0.0
        self.crop_right = 0.0
        self.crop_bottom = 0.0
        self.crop_left = 0.0
        self.rotation = 0.0
        self.input_ratio = 1.0
        self.output_size = None

    def serialize_binary(self) -> bytes:
        return (hasher.pack_f32(self.crop_top) + hasher.pack_f32(self.crop_right)
                + hasher.pack_f32(self.crop_bottom) + hasher.pack_f32(self.crop_left)
                + hasher.pack_f32(self.rotation) + hasher.pack_f32(self.input_ratio)
                + hasher.pack_opt_size(self.output_size))

    def to_settings_dict(self) -> dict:
        return {
            "crop_top": float(self.crop_top), "crop_right": float(self.crop_right),
            "crop_bottom": float(self.crop_bottom), "crop_left": float(self.crop_left),
            "rotation": float(self.rotation),
            "input_ratio": float(self.input_ratio),
            "output_size": list(self.output_size) if self.output_size else None,
        }

    def load_settings_dict(self, d: dict) -> None:
        for k in ("crop_top", "crop_right", "crop_bottom", "crop_left", "rotation"):
            setattr(self, k, float(d[k]))
        self.input_ratio = float(d.get("input_ratio", 1.0))
        osz = d.get("output_size")
        self.output_size = (int(osz[0]), int(osz[1])) if osz else None

    # -- size negotiation (stateful; cleared by reset) ---------------------

    def transform_forward(self, width, height):
        if self.output_size is not None:
            # Going forward after reverse: committed (rotatecrop.rs:66-74).
            return self.output_size
        self.input_ratio = float(_f32(_f32(width) / _f32(height)))
        return self._calc_size(width, height, reverse=False)

    def transform_reverse(self, width, height):
        self.output_size = (width, height)
        return self._calc_size(width, height, reverse=True)

    def reset(self):
        self.input_ratio = 1.0
        self.output_size = None

    def _noop(self) -> bool:
        return (abs(self.rotation) < EPSILON and abs(self.crop_top) < EPSILON
                and abs(self.crop_right) < EPSILON and abs(self.crop_bottom) < EPSILON
                and abs(self.crop_left) < EPSILON)

    @staticmethod
    def _round(v):
        # Rust f32::round = half away from zero (np.round is half-to-even).
        v = _f32(v)
        return _f32(np.trunc(v + (_f32(0.5) if v >= 0 else _f32(-0.5))))

    def _angle(self) -> _f32:
        rot = _f32(1.0) if self.rotation > 1.0 else _f32(self.rotation)
        return _f32(_FRAC_PI_2 * rot)

    def _calc_size(self, owidth, oheight, reverse):
        """Forward/reverse output-size math incl. rotation bounding box
        (rotatecrop.rs:111-163), float32 throughout."""
        if self._noop():
            return (owidth, oheight)
        width, height = _f32(owidth), _f32(oheight)

        if not (reverse or self.rotation < EPSILON):
            a = self._angle()
            sin, cos = _f32(np.sin(a)), _f32(np.cos(a))
            width, height = _f32(width * cos + height * sin), _f32(width * sin + height * cos)

        ratio = _f32(_f32(1.0) - _f32(self.crop_left) - _f32(self.crop_right))
        nwidth = _f32(self._round(width / ratio) if reverse else self._round(width * ratio))
        if ratio < EPSILON or nwidth < 1.0:
            log.error("Trying to crop width beyond limits")
            return (owidth, oheight)

        ratio = _f32(_f32(1.0) - _f32(self.crop_top) - _f32(self.crop_bottom))
        nheight = _f32(self._round(height / ratio) if reverse else self._round(height * ratio))
        if ratio < EPSILON or nheight < 1.0:
            log.error("Trying to crop height beyond limits")
            return (owidth, oheight)

        if reverse and not (self.rotation < EPSILON):
            a = self._angle()
            sin, cos = _f32(np.sin(a)), _f32(np.cos(a))
            ir = _f32(self.input_ratio)
            nwidth = _f32(self._round(nheight / _f32(sin + cos / ir)))
            nheight = _f32(self._round(nwidth / ir))

        return (int(nwidth), int(nheight))
