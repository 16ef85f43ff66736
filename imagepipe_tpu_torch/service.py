"""Stage-cache-aware interactive render service.

Counterpart of `imagepipe_tpu/service.py`. The reference's downstream GUI
(chimper) drives Pipeline + MultiCache in a mutate/re-render loop; this
service packages that pattern: one session per open image holding its
pipeline, one shared byte-budgeted cache of device-resident stages, edits
applied as setting patches, and renders at preview or full size. Only the
dirty stage suffix recomputes (pipeline.rs:354-372). Every session renders
staged (`use_fastpath = False`), rotated or not.

Threading contract: RenderService is safe for concurrent use across
DIFFERENT sessions: the shared MultiCache is internally locked, the session
table is guarded, and each EditSession serializes its own apply/render under
a per-session lock (edits mutate the pipeline in place). Stage-cache entries
are salted with the image content hash, so sessions never alias each
other's buffers; per-session device bytes in the shared cache are tracked
through owner tags (`session.cache_bytes()`).

A service renders on one device: `device=None` is `default_device()`, the
first CUDA device; the CPU only when asked for (`device="cpu"`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import torch

from . import profiling
from .cache import MultiCache
from .pipeline import Pipeline, default_device
from .sources import ImageSource

__all__ = ["RenderService", "EditSession"]


class _OwnedCacheView:
    """Forwards to a shared MultiCache, tagging puts with this session's
    owner key so per-session byte accounting stays exact under eviction."""

    def __init__(self, cache: MultiCache, owner: str):
        self._cache = cache
        self.owner = owner

    def get(self, key):
        return self._cache.get(key)

    def put(self, key, buf, weight):
        self._cache.put(key, buf, weight, owner=self.owner)

    put_arc = put

    def bytes(self) -> int:
        return self._cache.bytes_for(self.owner)


@dataclass
class EditSession:
    pipeline: Pipeline
    cache: _OwnedCacheView
    _lock: threading.RLock = field(default_factory=threading.RLock)

    def apply(self, patch: dict) -> None:
        """Patch op settings: {"basecurve": {"exposure": 0.3},
        "rotatecrop": {"crop_left": 0.1}, ...}; unknown keys are rejected."""
        with self._lock:
            for op_name, fields in patch.items():
                op = getattr(self.pipeline.ops, op_name, None)
                if op is None or op_name not in self.pipeline.ops.ORDER:
                    raise KeyError(f"unknown op {op_name!r}")
                current = op.to_settings_dict()
                for k in fields:
                    if k not in current:
                        raise KeyError(f"unknown setting {op_name}.{k}")
                current.update(fields)
                op.load_settings_dict(current)

    def set_temp(self, temp: float, tint: float = 1.0) -> None:
        with self._lock:
            self.pipeline.ops.tolab.set_temp(temp, tint)

    def render(self, max_size: int = 0, bits: int = 8):
        """Develop with the session cache; only dirty stages recompute."""
        with self._lock:
            s = self.pipeline.globals.settings
            s.maxwidth = max_size
            s.maxheight = max_size
            if bits == 8:
                return self.pipeline.output_8bit(self.cache)
            return self.pipeline.output_16bit(self.cache)

    def cache_bytes(self) -> int:
        """Device bytes this session currently holds in the shared cache."""
        return self.cache.bytes()

    def save_settings(self) -> str:
        with self._lock:
            return self.pipeline.to_serial()

    def load_settings(self, serial: str) -> None:
        """Replace the ops' settings with a `save_settings` serial. The
        session keeps its staged routing (`use_fastpath`, which
        `RenderService.open_source` sets): the JAX package's session drops
        it here, and a raster session then bypasses its cache."""
        with self._lock:
            old = self.pipeline
            self.pipeline = Pipeline.new_from_serial(old.globals.image, serial, old.device)
            self.pipeline.globals.settings.use_fastpath = old.globals.settings.use_fastpath


class RenderService:
    """Open images, apply edits, render, with one shared device cache. See
    the module docstring for the threading contract."""

    def __init__(self, cache_bytes: int = 4 << 30, device=None):
        self.device = torch.device(default_device() if device is None else device)
        self.cache = MultiCache(cache_bytes)
        self.sessions: dict[str, EditSession] = {}
        self._lock = threading.RLock()

    def open_file(self, key: str, path: str) -> EditSession:
        return self.open_source(key, None, path=path)

    def open_source(self, key: str, source: Optional[ImageSource], path=None) -> EditSession:
        if path is not None:
            pipeline = Pipeline.new_from_file(path, self.device)
        else:
            pipeline = Pipeline.new_from_source(source, self.device)
        # Interactive sessions use the staged cached path.
        pipeline.globals.settings.use_fastpath = False
        session = EditSession(pipeline, _OwnedCacheView(self.cache, key))
        with self._lock:
            self.sessions[key] = session
        return session

    def close(self, key: str) -> None:
        with self._lock:
            self.sessions.pop(key, None)

    def render(self, key: str, max_size: int = 0, bits: int = 8):
        with profiling.request("service.render"):
            with self._lock:
                session = self.sessions[key]
            return session.render(max_size=max_size, bits=bits)

    def edit(self, key: str, patch: dict, max_size: int = 0, bits: int = 8):
        with profiling.request("service.edit"):
            with self._lock:
                session = self.sessions[key]
            with session._lock:
                session.apply(patch)
                return session.render(max_size=max_size, bits=bits)
