"""Device-resident image buffer of the staged pipeline.

Counterpart of `imagepipe_tpu/buffer.py` (OpBuffer, buffer.rs:4-114). A
buffer is channel-planar float32 [colors, height, width] on the pipeline's
device, plus its width, height, colour count and monochrome flag. Ops are
functions from buffer to buffer; a buffer is not mutated after it is made,
so a stage cache can hold it and hand it out again. The constructors put a
buffer on `device`, by default the pipeline's `default_device()` (the
first CUDA device); the CPU only when asked for (`device="cpu"`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["OpBuffer", "from_rgb_str_vec"]


def _device(device) -> torch.device:
    """`device`, or the pipeline's default device when it is None."""
    if device is None:
        from .pipeline import default_device

        return default_device()
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class OpBuffer:
    """width x height x colors f32 image plane(s) plus the monochrome flag.
    colors is in {1, 3, 4}; data is [colors, height, width] float32."""

    width: int
    height: int
    colors: int
    monochrome: bool
    data: torch.Tensor  # [colors, height, width] f32

    _DEFAULT = None

    @staticmethod
    def default() -> "OpBuffer":
        """The empty buffer a run starts from (memoized)."""
        if OpBuffer._DEFAULT is None:
            OpBuffer._DEFAULT = OpBuffer(0, 0, 0, False,
                                         torch.zeros((0, 0, 0), dtype=torch.float32))
        return OpBuffer._DEFAULT

    @staticmethod
    def new(width: int, height: int, colors: int, monochrome: bool,
            device=None) -> "OpBuffer":
        return OpBuffer(width, height, colors, monochrome,
                        torch.zeros((colors, height, width), dtype=torch.float32,
                                    device=_device(device)))

    @staticmethod
    def from_hwc(arr, monochrome: bool = False, device=None) -> "OpBuffer":
        """A buffer from an interleaved [H, W, C] array or tensor."""
        t = torch.as_tensor(arr, dtype=torch.float32, device=_device(device))
        h, w, c = t.shape
        return OpBuffer(w, h, c, monochrome, t.permute(2, 0, 1).contiguous())

    def to_hwc(self) -> np.ndarray:
        """Host [H, W, C] view of the buffer."""
        return np.moveaxis(self.to_numpy(), 0, -1)

    def with_data(self, data: torch.Tensor, colors: int | None = None,
                  width: int | None = None, height: int | None = None,
                  monochrome: bool | None = None) -> "OpBuffer":
        c, h, w = data.shape
        return OpBuffer(
            width if width is not None else w,
            height if height is not None else h,
            colors if colors is not None else c,
            self.monochrome if monochrome is None else monochrome,
            data,
        )

    def nbytes(self) -> int:
        return self.width * self.height * self.colors * 4

    def transform(self, topleft, topright, bottomleft, width, height) -> "OpBuffer":
        """Inverse-mapped affine resample (buffer.rs:62-79)."""
        from . import scaling

        data = scaling.transform_buffer_planar(
            self.data, self.width, self.height, topleft, topright, bottomleft,
            width, height, self.colors)
        return OpBuffer(width, height, self.colors, self.monochrome, data)

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def __eq__(self, other) -> bool:
        if not isinstance(other, OpBuffer):
            return NotImplemented
        return (
            self.width == other.width
            and self.height == other.height
            and self.colors == other.colors
            and self.monochrome == other.monochrome
            and bool(np.array_equal(self.to_numpy(), other.to_numpy()))
        )


def from_rgb_str_vec(rows: list[str], device=None) -> OpBuffer:
    """ASCII-art test fixture constructor (buffer.rs:82-113): 'R'/'G'/'B'/'O'
    (white) / ' ' (black) characters -> a 3-channel buffer."""
    width = len(rows[0])
    height = len(rows)
    lut = {
        "R": (1.0, 0.0, 0.0),
        "G": (0.0, 1.0, 0.0),
        "B": (0.0, 0.0, 1.0),
        "O": (1.0, 1.0, 1.0),
        " ": (0.0, 0.0, 0.0),
    }
    data = np.zeros((height, width, 3), dtype=np.float32)
    for y, row in enumerate(rows):
        assert len(row) == width, "ragged fixture rows"
        for x, ch in enumerate(row):
            data[y, x] = lut[ch]
    return OpBuffer.from_hwc(data, device=device)
