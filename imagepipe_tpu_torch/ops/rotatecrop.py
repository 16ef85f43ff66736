"""Stage 3: user fractional crop + free rotation.

Counterpart of `imagepipe_tpu/ops/rotatecrop.py` (rotatecrop.rs): fields,
the no-op test, the stateful size negotiation (output size committed
during the reverse planning pass, rotatecrop.rs:66-85) and the inverse
mapping of the output's corners, all in float32 host arithmetic. The
resample is the shared resampler (scaling.transform_buffer_planar): a
pure crop is axis-aligned; a rotation runs the rotate kernel on CUDA
(kernels/rotate.py).
"""

from __future__ import annotations

import logging

import numpy as np

from .base import ImageOp
from .. import hasher
from .. import scaling
from ..buffer import OpBuffer

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

    @staticmethod
    def empty() -> "OpRotateCrop":
        return OpRotateCrop(None)

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

    def _rotate_point_reverse(self, x, y, width, height, swidth, sheight):
        """Map a dest-space point back to source space (rotatecrop.rs:97-109).
        f32 arithmetic; returns integer (isize-truncated) coordinates."""
        if self.rotation < EPSILON:
            return (int(x), int(y))
        a = self._angle()
        sin, cos = _f32(np.sin(a)), _f32(np.cos(a))
        tx = _f32(_f32(x) - _f32(width) / _f32(2.0))
        ty = _f32(_f32(y) - _f32(height) / _f32(2.0))
        nx = _f32(tx * cos + ty * sin + _f32(swidth) / _f32(2.0))
        ny = _f32(-tx * sin + ty * cos + _f32(sheight) / _f32(2.0))
        return (int(nx), int(ny))  # Rust `as isize` truncates toward zero

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

    # -- execution (rotatecrop.rs:39-64) -----------------------------------

    def geometry(self, width: int, height: int):
        """(topleft, topright, bottomleft, nwidth, nheight) of the resample
        of a width x height input: the source images of the output's
        corners (rotatecrop.rs:39-64), or None for a no-op or a crop
        outside the image (logged; the op then passes its input through)."""
        if self._noop():
            return None
        swidth, sheight = _f32(width), _f32(height)
        nwidth, nheight = self._calc_size(width, height, reverse=False)
        fnwidth, fnheight = _f32(nwidth), _f32(nheight)

        x = float(np.floor(_f32(swidth * _f32(self.crop_left))))
        if x < 0.0 or x > swidth:
            log.error("Trying to crop left outside image")
            return None
        y = float(np.floor(_f32(sheight * _f32(self.crop_top))))
        if y < 0.0 or y > sheight:
            log.error("Trying to crop top outside image")
            return None

        topleft = self._rotate_point_reverse(x, y, fnwidth, fnheight, swidth, sheight)
        topright = self._rotate_point_reverse(
            _f32(_f32(x) + fnwidth - _f32(1.0)), y, fnwidth, fnheight, swidth, sheight)
        bottomleft = self._rotate_point_reverse(
            x, _f32(_f32(y) + fnheight - _f32(1.0)), fnwidth, fnheight, swidth, sheight)
        return topleft, topright, bottomleft, nwidth, nheight

    def device_chain(self, globals_, meta):
        # Only the no-op joins a fused segment: a crop or rotation runs its
        # own resample (`run`).
        if self._noop():
            return (("rotatecrop", None), None, (), meta)
        return None

    def run(self, globals_, buf: OpBuffer) -> OpBuffer:
        g = self.geometry(buf.width, buf.height)
        if g is None:
            return buf
        topleft, topright, bottomleft, nwidth, nheight = g
        data = scaling.transform_buffer_planar(
            buf.data, buf.width, buf.height, topleft, topright, bottomleft,
            nwidth, nheight, buf.colors)
        return OpBuffer(nwidth, nheight, buf.colors, buf.monochrome, data)
