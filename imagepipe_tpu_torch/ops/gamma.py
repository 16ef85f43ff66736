"""Stage 7: sRGB gamma encode.

Counterpart of `imagepipe_tpu/ops/gamma.py` (gamma.rs). The op has no
parameters: clamp to [0,1], then the sRGB gamma on every channel, skipped
for linear 16-bit output (gamma.rs:17-18).
"""

from __future__ import annotations

import torch

from .base import ImageOp
from .. import color as cc
from ..buffer import OpBuffer

__all__ = ["OpGamma"]


class OpGamma(ImageOp):
    NAME = "gamma"

    def __init__(self, img=None):
        pass

    def serialize_binary(self) -> bytes:
        return b""

    def to_settings_dict(self) -> dict:
        return {}

    def load_settings_dict(self, d: dict) -> None:
        pass

    def device_chain(self, globals_, meta):
        if globals_.settings.linear:
            return (("gamma", "linear"), None, (), meta)
        return (("gamma",), "gamma", (), meta)

    def run(self, globals_, buf: OpBuffer) -> OpBuffer:
        if globals_.settings.linear:
            return buf
        numerics = cc.resolve_numerics("auto", buf.data.device)
        return buf.with_data(cc.apply_srgb_gamma(torch.clamp(buf.data, 0.0, 1.0), numerics))
