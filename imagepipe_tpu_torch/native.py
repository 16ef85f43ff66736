"""ctypes bindings for the native host library (native/host_pack.cc).

Bit-unpacking of camera RAW bitstreams is the host-side hot loop of decode
(the reference delegates it to rawloader's Rust; SURVEY.md L0). The C
library is used when built (`python -m imagepipe_tpu.native --build` or
cmake in native/); every function has a numpy fallback so the package works
without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

__all__ = ["unpack_12le", "unpack_12be", "unpack_14be", "swap_16be",
           "have_native", "build_native"]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATHS = [
    os.path.join(_REPO, "native", "build", "libimagepipe_host.so"),
]

_lib = None
for _p in _LIB_PATHS:
    if os.path.exists(_p):
        try:
            _lib = ctypes.CDLL(_p)
            break
        except OSError:
            pass

if _lib is not None:
    for _name in ("unpack_12le", "unpack_12be", "unpack_14be", "swap_16be"):
        fn = getattr(_lib, _name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                       ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64]


def have_native() -> bool:
    return _lib is not None


def build_native() -> bool:
    """Build native/ with cmake+ninja (or make); returns success."""
    build = os.path.join(_REPO, "native", "build")
    os.makedirs(build, exist_ok=True)
    try:
        subprocess.run(["cmake", "-S", os.path.join(_REPO, "native"), "-B", build,
                        "-G", "Ninja"], check=True, capture_output=True)
        subprocess.run(["cmake", "--build", build], check=True, capture_output=True)
        return True
    except Exception as e:
        print(f"native build failed: {e}", file=sys.stderr)
        return False


def _call_native(name: str, src: np.ndarray, npix: int) -> np.ndarray:
    dst = np.empty(npix, dtype=np.uint16)
    getattr(_lib, name)(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int64(npix))
    return dst


def unpack_12le(src: np.ndarray, npix: int) -> np.ndarray:
    """12-bit packed little-endian (2 px / 3 B) -> u16."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if _lib is not None:
        return _call_native("unpack_12le", src, npix)
    b = src[: (npix + 1) // 2 * 3].astype(np.uint16)
    b0, b1, b2 = b[0::3], b[1::3], b[2::3]
    out = np.empty(b0.size * 2, dtype=np.uint16)
    out[0::2] = ((b1 & 0x0F) << 8) | b0
    out[1::2][: b2.size] = (b2 << 4) | (b1[: b2.size] >> 4)
    return out[:npix]


def unpack_12be(src: np.ndarray, npix: int) -> np.ndarray:
    """12-bit packed big-endian / TIFF FillOrder=1 (2 px / 3 B) -> u16."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if _lib is not None:
        return _call_native("unpack_12be", src, npix)
    b = src[: (npix + 1) // 2 * 3].astype(np.uint16)
    b0, b1, b2 = b[0::3], b[1::3], b[2::3]
    out = np.empty(b0.size * 2, dtype=np.uint16)
    out[0::2] = (b0 << 4) | (b1 >> 4)
    out[1::2][: b2.size] = ((b1[: b2.size] & 0x0F) << 8) | b2
    return out[:npix]


def unpack_14be(src: np.ndarray, npix: int) -> np.ndarray:
    """14-bit packed big-endian (4 px / 7 B) -> u16."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if _lib is not None:
        return _call_native("unpack_14be", src, npix)
    groups = npix // 4
    b = src[: groups * 7].reshape(groups, 7).astype(np.uint64)
    v = np.zeros(groups, dtype=np.uint64)
    for k in range(7):
        v = (v << np.uint64(8)) | b[:, k]
    out = np.empty(groups * 4, dtype=np.uint16)
    out[0::4] = (v >> np.uint64(42)) & np.uint64(0x3FFF)
    out[1::4] = (v >> np.uint64(28)) & np.uint64(0x3FFF)
    out[2::4] = (v >> np.uint64(14)) & np.uint64(0x3FFF)
    out[3::4] = v & np.uint64(0x3FFF)
    if groups * 4 < npix:  # bit-exact tail
        rest = _bit_unpack(src[groups * 7:], npix - groups * 4, 14)
        out = np.concatenate([out, rest])
    return out[:npix]


def _bit_unpack(src: np.ndarray, npix: int, bits: int) -> np.ndarray:
    allbits = np.unpackbits(src)
    need = npix * bits
    allbits = allbits[:need].reshape(npix, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint32)
    return (allbits.astype(np.uint32) @ weights).astype(np.uint16)


def swap_16be(src: np.ndarray, npix: int) -> np.ndarray:
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if _lib is not None:
        return _call_native("swap_16be", src, npix)
    return src[: npix * 2].view(">u2").astype(np.uint16)


if __name__ == "__main__":
    if "--build" in sys.argv:
        ok = build_native()
        print("native build:", "ok" if ok else "FAILED")
        sys.exit(0 if ok else 1)
    print("native available:", have_native())
