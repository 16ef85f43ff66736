"""Nikon NEF compression 34713 codec (lossless + lossy-curve variants).

The default format of every modern Nikon body: a Huffman-coded predictive
stream (the reference reaches it through rawloader at
the reference's src/pipeline.rs:264). The structure is fixed and public --
this implementation follows the widely-documented dcraw `nikon_load_raw`
semantics, which rawloader's NEF decoder also mirrors:

  * maker-note tag 0x0096 carries the "linearization" metadata: version
    bytes (ver0/ver1), 2x2 initial vertical predictors, and -- for the
    lossy variants (ver0 0x44) -- a sampled tone curve plus a row `split`
    after which a second Huffman table applies. Lossless streams are
    ver0 0x46 with an identity curve.
  * six fixed Huffman tables selected by (variant, bit depth); leaf values
    are JPEG-style difference bit-lengths, with a high-nibble `shl` shift
    trick in the lossy-after-split tables.
  * the payload is a plain MSB-first bitstream (no JPEG marker stuffing):
    per pixel, decode a leaf, read `len-shl` difference bits, sign-extend,
    and integrate -- columns 0/1 against per-row-parity vertical
    predictors, the rest horizontally by column parity. Output is
    curve[clip(pred, 0, 0x3fff)].

The decoder prefers the native C++ implementation (native/nikon.cc, via
ctypes) and falls back to pure Python; the encoder (tests/DNG tooling)
emits canonical streams with the same tables so round-trips pin every
mechanism. Real-file cross-validation (tests/test_realfiles.py) is the
external check on the table constants.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import native

__all__ = ["decode_34713", "encode_34713", "parse_linearization",
           "NIKON_TREES"]

# dcraw's nikon_tree: 16 code-length counts (for lengths 1..16) then leaf
# values. Rows: 12-bit lossy, 12-bit lossy after split, 12-bit lossless,
# 14-bit lossy, 14-bit lossy after split, 14-bit lossless.
NIKON_TREES = (
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
     (5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12)),
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
     (0x39, 0x5A, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12)),
    ((0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0),
     (5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12)),
    ((0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
     (5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14)),
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0),
     (8, 0x5C, 0x4B, 0x3A, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14)),
    ((0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0),
     (7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14)),
)


def _codes(tree_idx: int):
    """Canonical Huffman codes [(code, length, leafvalue)] for a table
    (JPEG Annex C assignment: counts per length, values in order)."""
    counts, values = NIKON_TREES[tree_idx]
    codes = []
    code = 0
    vi = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            # dcraw's make_decoder pads short value lists with zero leaves
            # (tree 0 has 14 counts vs 13 values) and real streams may use
            # the padded deepest code, so emit it here too; the ENCODER
            # never picks a duplicate leaf (encode_34713's first-wins map).
            v = values[vi] if vi < len(values) else 0
            codes.append((code, length, v))
            code += 1
            vi += 1
        code <<= 1
    return codes


def _decode_lut(tree_idx: int, peek: int = 16):
    """Flat peek-LUT: top `peek` bits -> (leafvalue, codelength)."""
    lut = np.zeros((1 << peek, 2), np.int32)
    lut[:, 1] = -1
    for code, length, v in _codes(tree_idx):
        lo = code << (peek - length)
        hi = (code + 1) << (peek - length)
        lut[lo:hi, 0] = v
        lut[lo:hi, 1] = length
    return lut


def parse_linearization(meta: bytes, bits: int):
    """Parse maker-note tag 0x0096. Returns (tree, vpred[2][2], curve,
    split, white) following dcraw nikon_load_raw's meta handling."""
    if len(meta) < 12:
        raise ValueError("NEF 34713: linearization blob too short")
    ver0, ver1 = meta[0], meta[1]
    pos = 2
    if ver0 == 0x49 or ver1 == 0x58:
        pos += 2110
    tree = 0
    if ver0 == 0x46:
        tree = 2
    if bits == 14:
        tree += 3
    if pos + 10 > len(meta):
        raise ValueError("NEF 34713: truncated linearization blob")
    vpred = np.array(struct.unpack_from(">4H", meta, pos),
                     np.int32).reshape(2, 2)
    pos += 8
    vmax = (1 << bits) & 0x7FFF
    (csize,) = struct.unpack_from(">H", meta, pos)
    pos += 2
    step = vmax // (csize - 1) if csize > 1 else 0
    curve = np.arange(0x10000, dtype=np.int64)
    split = 0
    if (ver0 == 0x44 and step > 0
            and (ver1 == 0x20 or (ver1 == 0x40 and step > 3))):
        if ver1 == 0x40:
            # Lossy "type 2" (D90-era onward): the same sampled curve,
            # but sample spacing AND curve domain are quartered (dcraw's
            # `step /= 4; max /= 4`) -- predictor values live in the
            # quarter-range domain.
            step //= 4
            vmax //= 4
        if pos + 2 * csize > len(meta):
            raise ValueError("NEF 34713: truncated tone curve")
        samples = np.frombuffer(meta, ">u2", csize, pos).astype(np.int64)
        curve[: (csize - 1) * step + 1 : step] = samples
        # Linear interpolation between samples (dcraw's fill loop).
        i = np.arange(vmax)
        lo = i - i % step
        curve_l = curve.copy()
        curve[:vmax] = (curve_l[lo] * (step - i % step)
                        + curve_l[np.minimum(lo + step, 0xFFFF)] * (i % step)) // step
        if len(meta) >= 564:
            (split,) = struct.unpack_from(">H", meta, 562)
    elif ver0 == 0x44:
        # Remaining 0x44 shapes (degenerate steps, unknown ver1): dcraw
        # would fall through to the direct curve read, but we have never
        # seen such a stream to pin -- refuse rather than guess.
        raise ValueError(
            f"NEF 34713: unrecognized linearization variant "
            f"{ver0:#x}/{ver1:#x} (csize {csize}); refusing rather than "
            "guessing the curve layout")
    elif ver0 != 0x46 and csize <= 0x4001:
        if pos + 2 * csize > len(meta):
            raise ValueError("NEF 34713: truncated tone curve")
        curve[:csize] = np.frombuffer(meta, ">u2", csize, pos).astype(np.int64)
        vmax = csize
    while vmax > 2 and curve[vmax - 2] == curve[vmax - 1]:
        vmax -= 1
    white = int(curve[vmax - 1])
    return tree, vpred, curve.astype(np.uint16), int(split), white


def _decode_python(payload, width, height, tree, vpred, curve, split):
    out = np.zeros((height, width), np.uint16)
    lut = _decode_lut(tree)
    lut2 = _decode_lut(tree + 1) if split else None
    vp = vpred.copy()
    hpred = [0, 0]
    data = payload
    nbits = len(data) * 8
    pos = 0
    cur = lut
    for row in range(height):
        if split and row == split:
            cur = lut2
        for col in range(width):
            # Peek up to 16 bits (zero-padded at stream end like dcraw's
            # buffered reader).
            chunk = 0
            for k in range(16):
                p = pos + k
                bit = (data[p >> 3] >> (7 - (p & 7))) & 1 if p < nbits else 0
                chunk = (chunk << 1) | bit
            leaf, length = int(cur[chunk, 0]), int(cur[chunk, 1])
            # Strict end handling, matching the native decoder: consuming
            # any bit past the payload (even for a code completed by the
            # zero padding) rejects the stream.
            if length < 0 or pos + length > nbits:
                raise ValueError("NEF 34713: bad Huffman code / "
                                 "bitstream exhausted")
            pos += length
            lenb = leaf & 15
            shl = leaf >> 4
            nread = lenb - shl
            bitsv = 0
            for _ in range(max(nread, 0)):
                if pos >= nbits:
                    raise ValueError("NEF 34713: bitstream exhausted")
                bitsv = (bitsv << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
                pos += 1
            diff = (((bitsv << 1) + 1) << shl) >> 1
            if lenb > 0 and (diff & (1 << (lenb - 1))) == 0:
                diff -= (1 << lenb) - (0 if shl else 1)
            if col < 2:
                vp[row & 1, col] += diff
                hpred[col] = int(vp[row & 1, col])
            else:
                hpred[col & 1] += diff
            # Output clamps the predictor into the curve (dcraw's LIM);
            # corrupt streams surface as exhausted bits or bad codes above.
            out[row, col] = curve[min(max(hpred[col & 1], 0), 0x3FFF)]
    return out


def _decode_native(payload, width, height, tree, vpred, curve, split):
    lib = native._lib
    fn = lib.nikon_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int32),
                   ctypes.POINTER(ctypes.c_uint16)]
    out = np.empty((height, width), np.uint16)
    vp = np.ascontiguousarray(vpred, np.int32)
    cv = np.ascontiguousarray(curve, np.uint16)
    rc = fn(payload, len(payload),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            width, height, tree, split,
            vp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"NEF 34713: native decode failed ({rc})")
    return out


def decode_34713(payload: bytes, width: int, height: int, bits: int,
                 meta: bytes):
    """Decode a compression-34713 strip. Returns (data u16 [h, w], white)."""
    tree, vpred, curve, split, white = parse_linearization(meta, bits)
    if native.have_native() and hasattr(native._lib, "nikon_decode"):
        return _decode_native(payload, width, height, tree, vpred, curve,
                              split), white
    return _decode_python(payload, width, height, tree, vpred, curve,
                          split), white


# ---------------------------------------------------------------------------
# Encoder (tests + tooling): canonical lossless streams.
# ---------------------------------------------------------------------------


def _enc_table(tree: int) -> dict:
    """bit-length -> (code, codelen) using the tree's plain ssss leaves
    (shl leaves quantize -- a canonical encoder never emits them)."""
    enc = {}
    for code, length, v in _codes(tree):
        lenb = v & 15
        if v >> 4:
            continue
        if lenb not in enc:         # first (shortest) code per bit-length
            enc[lenb] = (code, length)
    return enc


def _encode_stream(data: np.ndarray, tree: int, vpred: np.ndarray,
                   split: int = 0) -> bytes:
    """Encode a predictor-domain plane with the given Huffman tree
    (switching to tree+1 at the split row, mirroring the decoder)."""
    height, width = data.shape
    enc = _enc_table(tree)
    vp = vpred.copy()
    hpred = [0, 0]
    outbits = bytearray()
    acc = 0
    nacc = 0

    def put(val, n):
        nonlocal acc, nacc
        acc = (acc << n) | (val & ((1 << n) - 1))
        nacc += n
        while nacc >= 8:
            outbits.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << max(nacc, 0)) - 1

    for row in range(height):
        if split and row == split:
            enc = _enc_table(tree + 1)
        for col in range(width):
            target = int(data[row, col])
            if col < 2:
                pred = int(vp[row & 1, col])
            else:
                pred = hpred[col & 1]
            diff = target - pred
            # Difference bit-length (JPEG SSSS) and payload bits.
            mag = diff if diff >= 0 else -diff
            lenb = mag.bit_length()
            if lenb not in enc:
                raise ValueError(f"NEF encode: no code for bit-length {lenb}")
            code, clen = enc[lenb]
            put(code, clen)
            if lenb:
                payload_bits = diff if diff >= 0 else diff + (1 << lenb) - 1
                put(payload_bits, lenb)
            if col < 2:
                vp[row & 1, col] += diff
                hpred[col] = int(vp[row & 1, col])
            else:
                hpred[col & 1] += diff
    if nacc:
        put(0, 8 - nacc)   # pad final byte with zeros
    return bytes(outbits)


def encode_34713(data: np.ndarray, bits: int = 14) -> tuple[bytes, bytes]:
    """Encode a sensor plane as a LOSSLESS 34713 stream (ver0 0x46 -> the
    lossless tree for `bits`, identity curve). Returns (payload, meta) where
    meta is the maker-note 0x0096 blob."""
    data = np.asarray(data)
    assert data.ndim == 2
    assert int(data.max(initial=0)) < (1 << bits)
    tree = (2 if bits != 14 else 5)
    vpred = np.array([[1 << (bits - 1)] * 2] * 2, np.int32)
    payload = _encode_stream(data, tree, vpred)
    meta = bytearray()
    meta += bytes([0x46, 0x30])                       # lossless version
    meta += struct.pack(">4H", *[int(v) for v in vpred.ravel()])
    meta += struct.pack(">H", 257)                    # csize (curve unused)
    meta += b"\0" * 16
    return bytes(payload), bytes(meta)


def encode_34713_lossy2(pred: np.ndarray, bits: int = 14,
                        samples: np.ndarray | None = None,
                        split: int = 0) -> tuple[bytes, bytes]:
    """Encode a PREDICTOR-domain plane as a lossy type-2 (ver 0x44/0x40)
    stream. The decoder outputs curve[pred]: type 2's curve covers the
    quarter domain (1 << bits) / 4, sampled every step/4. Returns
    (payload, meta); the expected decode is curve[clip(pred)] with curve
    from parse_linearization(meta, bits). split > 0 switches to the
    after-split tree at that row, as real bodies do."""
    pred = np.asarray(pred)
    assert pred.ndim == 2
    vmax4 = (1 << bits) // 4
    assert int(pred.max(initial=0)) < vmax4, "type-2 preds are quarter-range"
    if samples is None:
        # A gently-curved monotone default tone curve over the full range.
        samples = np.linspace(0, (1 << bits) - 1, 257).astype(np.uint16)
    samples = np.asarray(samples, np.uint16)
    csize = len(samples)
    if 12 + 2 * csize > 562:
        # The split word lives at FIXED blob offset 562 (dcraw seeks
        # there); samples extending past it would displace it.
        raise ValueError("type-2 curve must fit before blob offset 562 "
                         f"(csize {csize} > 275)")
    step = (1 << bits) // (csize - 1)
    if step <= 3:
        raise ValueError("type-2 needs step > 3 (csize too large)")
    tree = (0 if bits != 14 else 3)
    vpred = np.array([[1 << (bits - 3)] * 2] * 2, np.int32)
    payload = _encode_stream(pred, tree, vpred, split=split)
    meta = bytearray()
    meta += bytes([0x44, 0x40])
    meta += struct.pack(">4H", *[int(v) for v in vpred.ravel()])
    meta += struct.pack(">H", csize)
    meta += samples.astype(">u2").tobytes()
    if len(meta) < 562:
        meta += b"\0" * (562 - len(meta))
    meta += struct.pack(">H", split)
    return bytes(payload), bytes(meta)
