"""Stage 5: tone curve on the L channel.

Counterpart of `imagepipe_tpu/ops/curves.py` (curves.rs:5-56). Exposure
scales each control point's y by 2^exposure before the spline is fitted
on the host; the staged run evaluates it on the L plane, a fused segment
of the suffix (`device_chain`) and the fused develop
(engine.make_develop_plan) take its coefficients.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import ImageOp
from .. import hasher
from ..buffer import OpBuffer
from ..spline import SplineFunc, eval_spline_arrays

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

    def _identity(self) -> bool:
        return len(self.points) == 0 and abs(self.exposure) < 0.001

    def _final_spline(self) -> SplineFunc:
        scale = math.pow(2.0, self.exposure)
        return SplineFunc([(x, y * scale) for (x, y) in self.points])

    def device_chain(self, globals_, meta):
        if self._identity():
            return (("basecurve", None), None, (), meta)
        func = self._final_spline()
        n = len(func.xs)
        coeffs = np.zeros((5, n), np.float32)
        coeffs[0], coeffs[1], coeffs[2] = func.xs, func.ys, func.c1s
        coeffs[3, :n - 1], coeffs[4, :n - 1] = func.c2s, func.c3s
        return (("basecurve", n), "basecurve", (coeffs,), meta)

    def run(self, globals_, buf: OpBuffer) -> OpBuffer:
        if self._identity():
            return buf
        func = self._final_spline()
        tables = [torch.tensor(np.asarray(a, np.float32), device=buf.data.device)
                  for a in (func.xs, func.ys, func.c1s, func.c2s, func.c3s)]
        L = eval_spline_arrays(*tables, len(func.xs), buf.data[0])
        return buf.with_data(torch.cat([L[None], buf.data[1:]]))
