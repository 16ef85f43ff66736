"""Content hashing for the stage cache.

Equivalent of the reference's src/hasher.rs: a 32-byte digest over a
canonical binary serialization of op settings, chained so the hash of stage i
commits to the settings of stages 0..=i (pipeline.rs:341-361). The reference
uses blake3 over bincode; here it's blake2b-256 (stdlib) over an explicit
little-endian layout -- the digest only keys the in-process HBM stage cache,
so cross-implementation byte equality is not required, but determinism and
full field sensitivity are.
"""

from __future__ import annotations

import hashlib
import struct

__all__ = ["BufHasher", "BufHash", "pack_f32", "pack_u64", "pack_bool",
           "pack_str", "pack_f32s", "pack_pairs", "pack_opt_size", "pack_enum"]

BufHash = bytes  # 32 bytes


class BufHasher:
    def __init__(self):
        self._h = hashlib.blake2b(digest_size=32)

    def write(self, data: bytes) -> None:
        self._h.update(data)

    def from_serialize(self, obj) -> None:
        """Hash an object exposing serialize_binary() (ops, settings)."""
        self._h.update(obj.serialize_binary())

    def result(self) -> BufHash:
        return self._h.digest()

    def copy(self) -> "BufHasher":
        out = BufHasher.__new__(BufHasher)
        out._h = self._h.copy()
        return out


# bincode-style little-endian packing helpers -------------------------------

def pack_f32(v) -> bytes:
    return struct.pack("<f", float(v))


def pack_u64(v) -> bytes:
    return struct.pack("<Q", int(v))


def pack_bool(v) -> bytes:
    return struct.pack("<B", 1 if v else 0)


def pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return pack_u64(len(b)) + b


def pack_f32s(vals) -> bytes:
    import numpy as np
    flat = np.asarray(vals, dtype=np.float32).ravel()
    return struct.pack(f"<{flat.size}f", *flat.tolist())


def pack_pairs(pairs) -> bytes:
    out = pack_u64(len(pairs))
    for a, b in pairs:
        out += pack_f32(a) + pack_f32(b)
    return out


def pack_opt_size(opt) -> bytes:
    if opt is None:
        return b"\x00"
    return b"\x01" + pack_u64(opt[0]) + pack_u64(opt[1])


def pack_enum(idx: int) -> bytes:
    return struct.pack("<I", idx)
