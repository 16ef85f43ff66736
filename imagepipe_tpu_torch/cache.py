"""Byte-weighted stage cache holding device-resident buffers.

Counterpart of `imagepipe_tpu/cache.py` (the `multicache` crate,
pipeline.rs:43,258-260,355-370): a size-bounded map BufHash -> OpBuffer,
least recently used evicted first by byte weight. Entries keep their
tensors alive on the pipeline's device, so a cache hit resumes a re-render
from the deepest valid stage with no host<->device copy; the device memory
they hold is what `total_bytes` counts (an entry that shares its tensor with
another, as a stage that passes its input through does, counts twice).

The newest entry is always kept, even when its weight alone exceeds
max_bytes: stages are put in execution order, so the newest is the deepest
stage, and dropping it would make a small cache useless. total_bytes may
therefore exceed max_bytes only when len() == 1.

All operations take an internal lock, so one MultiCache may be shared by
concurrent render sessions (service.py). Entries can carry an `owner` tag
for per-session byte accounting (`bytes_for`), kept consistent under
eviction and key replacement.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from .buffer import OpBuffer

__all__ = ["MultiCache"]


class MultiCache:
    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._entries: OrderedDict[bytes, tuple[OpBuffer, int, object]] = OrderedDict()
        self._total = 0
        self._by_owner: dict = {}
        self._lock = threading.RLock()

    def get(self, key: bytes) -> Optional[OpBuffer]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            self._entries.move_to_end(key)
            return hit[0]

    def _account(self, owner, delta: int) -> None:
        if owner is None:
            return
        n = self._by_owner.get(owner, 0) + delta
        if n:
            self._by_owner[owner] = n
        else:
            self._by_owner.pop(owner, None)

    def put(self, key: bytes, buf: OpBuffer, weight: int, owner=None) -> None:
        with self._lock:
            if key in self._entries:
                _, old_w, old_owner = self._entries.pop(key)
                self._total -= old_w
                self._account(old_owner, -old_w)
            self._entries[key] = (buf, int(weight), owner)
            self._total += int(weight)
            self._account(owner, int(weight))
            while self._total > self.max_bytes and len(self._entries) > 1:
                _, (_, w, o) = self._entries.popitem(last=False)
                self._total -= w
                self._account(o, -w)

    # Name of the reference's call site (pipeline.rs:369).
    put_arc = put

    def bytes_for(self, owner) -> int:
        """Bytes currently held by entries tagged with this owner."""
        with self._lock:
            return self._by_owner.get(owner, 0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total
