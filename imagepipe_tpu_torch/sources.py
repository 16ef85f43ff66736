"""Image sources: camera RAW or raster.

Equivalent of the ImageSource enum (the reference's src/pipeline.rs:46-66).
Raster payloads may be PIL images or numpy [H,W,3] uint8/uint16 arrays (the
reference's in-memory ImageRgb8/ImageRgb16 constructions map to the latter).
"""

from __future__ import annotations

import numpy as np

from .raw import RawImage

__all__ = ["ImageSource", "RasterImage"]


def image_content_hash(image: "ImageSource") -> bytes:
    """32-byte content hash of the source pixels, memoized on the payload.

    The reference's cache chain hashes only settings + op parameters
    (pipeline.rs:341-352), so two same-camera images with identical settings
    would collide in a shared cache; salting the chain with the image
    identity makes a multi-image cache (service.py) sound."""
    import hashlib

    payload = image.raw if image.is_raw else image.other
    h = getattr(payload, "_content_hash", None)
    if h is None:
        hasher = hashlib.blake2b(digest_size=32)
        if image.is_raw:
            hasher.update(np.ascontiguousarray(payload.data))
        elif isinstance(payload._payload, np.ndarray):
            hasher.update(np.ascontiguousarray(payload._payload))
        else:
            hasher.update(payload.to_rgb8().tobytes())
        h = hasher.digest()
        try:
            payload._content_hash = h
        except AttributeError:
            pass
    return h


class RasterImage:
    """A raster (non-RAW) image: PIL image or [H,W,3] u8/u16 array."""

    def __init__(self, payload):
        self._payload = payload

    @property
    def width(self) -> int:
        if isinstance(self._payload, np.ndarray):
            return self._payload.shape[1]
        return self._payload.width

    @property
    def height(self) -> int:
        if isinstance(self._payload, np.ndarray):
            return self._payload.shape[0]
        return self._payload.height

    def bits_per_channel(self) -> int:
        if isinstance(self._payload, np.ndarray):
            return 16 if self._payload.dtype == np.uint16 else 8
        mode = self._payload.mode
        return 16 if mode in ("I", "I;16", "I;16B", "I;16L", "I;16N") else 8

    def to_rgb8(self) -> np.ndarray:
        """[H,W,3] uint8 (image crate to_rgb8 equivalent)."""
        if isinstance(self._payload, np.ndarray):
            a = self._payload
            if a.dtype == np.uint8:
                return a
            # 16 -> 8 narrowing keeps the high byte (image crate semantics).
            return (a >> 8).astype(np.uint8)
        if self.bits_per_channel() == 16:
            # PIL convert('RGB') on 16-bit modes CLIPS to 0..255; narrow by
            # the high byte like the image crate instead.
            return (self.to_rgb16() >> 8).astype(np.uint8)
        return np.asarray(self._payload.convert("RGB"))

    def to_rgb16(self) -> np.ndarray:
        """[H,W,3] uint16; 8-bit widens via v*257 (image crate semantics)."""
        if isinstance(self._payload, np.ndarray):
            a = self._payload
            if a.dtype == np.uint16:
                return a
            return a.astype(np.uint16) * 257
        mode = self._payload.mode
        if mode in ("I", "I;16", "I;16B", "I;16L", "I;16N"):
            gray = np.asarray(self._payload, dtype=np.uint32)
            gray = np.clip(gray, 0, 65535).astype(np.uint16)
            return np.repeat(gray[..., None], 3, axis=-1)
        return np.asarray(self._payload.convert("RGB")).astype(np.uint16) * 257


class ImageSource:
    """Tagged union: RAW or raster."""

    def __init__(self, raw: RawImage | None = None, other: RasterImage | None = None):
        assert (raw is None) != (other is None)
        self.raw = raw
        self.other = other

    @staticmethod
    def from_raw(raw: RawImage) -> "ImageSource":
        return ImageSource(raw=raw)

    @staticmethod
    def from_raster(payload) -> "ImageSource":
        if isinstance(payload, RasterImage):
            return ImageSource(other=payload)
        return ImageSource(other=RasterImage(payload))

    @property
    def is_raw(self) -> bool:
        return self.raw is not None

    def width(self) -> int:
        return self.raw.width if self.is_raw else self.other.width

    def height(self) -> int:
        return self.raw.height if self.is_raw else self.other.height
