"""Sony SRF (DSC-F828 / DSC-V3): encrypted uncompressed 14-bit raw.

The reference reaches these bodies through rawloader at
the reference's src/pipeline.rs:264. SRF files are TIFF containers
(Make/Model in IFD0) whose raw payload is headerless at a fixed
per-model offset, XOR-encrypted with Sony's LFSR keystream (the public
dcraw `sony_decrypt` reverse engineering):

  pad[0..3]   seeded by key = key * 48828125 + 1 (mod 2^32)
  pad[3]      <<= 1 | (pad[0] ^ pad[2]) >> 31
  pad[4..126] = (pad[p-4] ^ pad[p-2]) << 1 | (pad[p-3] ^ pad[p-1]) >> 31
  pad[127]    = 0, every word then serialized BIG-endian
  stream      t[p] = t[p-127] ^ t[p-63], XORed over the data words

Key derivation is two-stage (dcraw `sony_load_raw`): at file offset
200896 a count byte n is followed by n 4-byte slots whose LAST dword
(big-endian) is key1; the 40-byte block at 164600 decrypts with key1
and bytes 25..22 of the result form key2, which decrypts the pixel
words as ONE continuous stream across rows. Pixels are big-endian u16
and must fit 14 bits.

The container magic offsets, per-model geometry (F828: 3360x2460 raw,
payload at 862144, 3288 visible, left margin 5, RGBE mosaic), and the
keystream form follow the public dcraw semantics from recall --
flagged for real-file confirmation like the other vendor codecs. The
canonical encoder writes the same layout so decode(encode(x))
round-trips pin the mechanism; DSC-V3 is recognized by name but
refuses (its raw geometry isn't reliably recalled -- guessing would
silently mis-decode)."""

from __future__ import annotations

import struct

import numpy as np

from .cameras import xyz_to_cam_for
from .raw import CFA, Orientation, RawImage
from .tiff import TiffFile

__all__ = ["read_srf", "sony_keystream", "sony_crypt", "decode_srf",
           "encode_srf", "register_srf_geometry"]

_KEY1_POS = 200896
_HEAD_POS = 164600

# Per-model geometry: raw dims, payload offset, visible width, left
# margin, CFA. The F828 is Sony's four-color RGBE sensor.
_MODELS = {
    "DSC-F828": dict(raw_width=3360, raw_height=2460, data_offset=862144,
                     width=3288, left_margin=5, cfa="REGB"),
}


def register_srf_geometry(model: str, raw_width: int, raw_height: int,
                          data_offset: int, width: int | None = None,
                          left_margin: int = 0, cfa: str = "RGGB") -> None:
    """Register raw geometry for an SRF body the built-in table refuses
    (e.g. DSC-V3) -- the growth path users confirm against a known file,
    mirroring register_orf_pattern / register_raf_pattern."""
    _MODELS[model.strip()] = dict(
        raw_width=int(raw_width), raw_height=int(raw_height),
        data_offset=int(data_offset),
        width=int(width) if width else int(raw_width) - int(left_margin),
        left_margin=int(left_margin), cfa=cfa)


def sony_keystream(key: int, nwords: int) -> np.ndarray:
    """`nwords` keystream words as the decoder XORs them over
    little-endian-viewed data (i.e. the big-endian serialization of the
    LFSR state, which the XOR-linear recurrence preserves).

    Exact dcraw ring semantics: 127 seed words s[0..126]; the pointer
    enters the stream loop at slot 127, so the FIRST output word is
    k[0] = s[0] ^ s[64] (written into the never-seeded slot 127 before
    anything reads it — there is NO zero tap), and in sequence form
    k[i] = ext[i-127] ^ ext[i-63] over ext = seeds ++ outputs."""
    pad = np.zeros(127, np.uint32)
    k = key & 0xFFFFFFFF
    for p in range(4):
        k = (k * 48828125 + 1) & 0xFFFFFFFF
        pad[p] = k
    pad[3] = (int(pad[3]) << 1 | (int(pad[0]) ^ int(pad[2])) >> 31) & 0xFFFFFFFF
    for p in range(4, 127):
        pad[p] = ((int(pad[p - 4]) ^ int(pad[p - 2])) << 1
                  | (int(pad[p - 3]) ^ int(pad[p - 1])) >> 31) & 0xFFFFFFFF
    pad = pad.byteswap()  # dcraw htonl's the seed words
    # k[i] = ext[i-127] ^ ext[i-63]: generate in <=63-wide blocks so
    # both taps are already available.
    out = np.empty(127 + nwords, np.uint32)
    out[:127] = pad
    filled = 127
    while filled < 127 + nwords:
        n = min(63, 127 + nwords - filled)
        out[filled:filled + n] = (out[filled - 127:filled - 127 + n]
                                  ^ out[filled - 63:filled - 63 + n])
        filled += n
    return out[127:]


def sony_crypt(data: bytes, key: int) -> bytes:
    """XOR a buffer (length multiple of 4) with the keystream — its own
    inverse, mirroring dcraw sony_decrypt(start=1)."""
    if len(data) % 4:
        raise ValueError("SRF: crypt length must be a multiple of 4")
    words = np.frombuffer(data, "<u4").copy()
    words ^= sony_keystream(key, len(words))
    return words.tobytes()


def _derive_keys(buf: bytes) -> tuple[int, int]:
    if len(buf) < _KEY1_POS + 1024:
        raise ValueError("SRF: file too short for the key block")
    n = buf[_KEY1_POS]
    # dcraw: fgetc (pos -> 200897) then seek n*4 - 1 forward, read a
    # BIG-endian dword at 200896 + n*4.
    (key1,) = struct.unpack_from(">I", buf, _KEY1_POS + n * 4)
    head = sony_crypt(buf[_HEAD_POS:_HEAD_POS + 40], key1)
    key2 = 0
    for i in (25, 24, 23, 22):
        key2 = (key2 << 8) | head[i]
    return key1, key2


def decode_srf(buf: bytes, geom: dict) -> np.ndarray:
    """Decrypt + byte-swap the pixel payload; values must fit 14 bits."""
    w, h, off = geom["raw_width"], geom["raw_height"], geom["data_offset"]
    if len(buf) < off + 2 * w * h:
        raise ValueError("SRF: truncated pixel payload")
    _key1, key2 = _derive_keys(buf)
    plain = sony_crypt(buf[off:off + 2 * w * h], key2)
    pix = np.frombuffer(plain, ">u2").astype(np.uint16).reshape(h, w)
    if (pix >> 14).any():
        raise ValueError("SRF: pixel above 14 bits (wrong key or corrupt "
                         "stream)")
    return pix


def encode_srf(img: np.ndarray, geom: dict, model: str = "DSC-F828",
               key1: int = 0x12345678, head_seed: bytes = b"") -> bytes:
    """Canonical test encoder: a minimal TIFF IFD0 (Make/Model), the key
    blocks at the magic offsets, and the encrypted payload at the
    model's data offset."""
    img = np.asarray(img, np.uint16)
    h, w = img.shape
    if (h, w) != (geom["raw_height"], geom["raw_width"]):
        raise ValueError("SRF encoder: image must match the model geometry")
    if (img >> 14).any():
        raise ValueError("SRF: values must fit 14 bits")
    out = bytearray(geom["data_offset"] + 2 * w * h)
    # TIFF header + IFD0 with Make (271) / Model (272).
    make, mod = b"SONY\0", model.encode() + b"\0"
    struct.pack_into("<2sHI", out, 0, b"II", 42, 8)
    ifd_pos = 8
    n = 2
    struct.pack_into("<H", out, ifd_pos, n)
    str_pos = ifd_pos + 2 + n * 12 + 4
    struct.pack_into("<HHII", out, ifd_pos + 2, 271, 2, len(make), str_pos)
    struct.pack_into("<HHII", out, ifd_pos + 14, 272, 2, len(mod),
                     str_pos + len(make))
    out[str_pos:str_pos + len(make)] = make
    out[str_pos + len(make):str_pos + len(make) + len(mod)] = mod
    # Key block 1: count byte n, then key1 big-endian at 200896 + n*4
    # (dcraw's exact cursor arithmetic).
    nslots = 3
    out[_KEY1_POS] = nslots
    struct.pack_into(">I", out, _KEY1_POS + nslots * 4, key1)
    # Head block: 40 plaintext bytes (bytes 22..25 become key2),
    # encrypted with key1.
    head = bytearray((head_seed + bytes(40))[:40])
    if not head_seed:
        head[22:26] = b"\x9a\x3c\x5e\x71"
    key2 = 0
    for i in (25, 24, 23, 22):
        key2 = (key2 << 8) | head[i]
    out[_HEAD_POS:_HEAD_POS + 40] = sony_crypt(bytes(head), key1)
    payload = img.astype(">u2").tobytes()
    out[geom["data_offset"]:] = sony_crypt(payload, key2)
    return bytes(out)


def read_srf(path: str) -> RawImage:
    """Sony SRF: TIFF container, per-model geometry, encrypted payload.
    Known models without reliably-recalled geometry refuse by name."""
    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf)
    make = (tf.find1(271) or "").strip()
    model = (tf.find1(272) or "").strip()
    geom = _MODELS.get(model)
    if geom is None:
        raise ValueError(
            f"SRF: model {model!r} has no known raw geometry (only "
            f"{sorted(_MODELS)} decode); convert to DNG")
    data = decode_srf(buf, geom)
    w, h = geom["raw_width"], geom["raw_height"]
    vis_w, left = geom["width"], geom["left_margin"]
    crops = (0, w - left - vis_w, 0, left)
    return RawImage(
        width=w, height=h, cpp=1, crops=crops,
        blacklevels=(0,) * 4, whitelevels=(0x3FFF,) * 4,
        wb_coeffs=(float("nan"),) * 4,
        xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=Orientation.Normal, cfa=CFA(geom["cfa"]),
        data=data, make=make, model=model)
