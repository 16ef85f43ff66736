"""Minimal DNG (TIFF-EP) camera RAW reader/writer: uncompressed CFA images.

The reference leans on the rawloader crate for hundreds of camera formats
(SURVEY.md section 2.4). This framework's native-format strategy: DNG is the
archival/interchange format every camera RAW converts to losslessly, so a
solid uncompressed-DNG path plus the pluggable decoder registry
(decode.register_raw_decoder) covers real camera files; 12/14-bit packed
bitstreams unpack through the native host library (native/host_pack.cc).

Reader surface: strips or tiles, Compression 1 (uncompressed), 7
(lossless JPEG), 8 (Deflate/ZIP per DNG 1.4 with TIFF Predictor
1/2/3 -- the shape Adobe tools write for compressed integer and float/HDR
DNGs), or 34892 (DNG 1.4 lossy JPEG: 8-bit baseline JFIF per chunk on
LinearRaw data -- the Lightroom "lossy DNG" shape, decoded through PIL's
stock baseline-JPEG codec), BitsPerSample 8/12/14/16 integer plus
16/24/32-bit float payloads (SampleFormat 3; fp24 is the DNG-1.4
sign/7-bit-exponent/16-bit-mantissa layout at the standard bias 63),
CFA (PhotometricInterpretation 32803), linear
gray, or demosaiced LinearRaw at SamplesPerPixel 3 (the Lightroom
"linear DNG" / HDR-merge shape — decodes to a cpp=3 RawImage that
develops through the engine's rgb mode with no demosaic, exactly as
rawloader hands 3-component raws to the reference's gofloat.rs:101-127);
pulls the DNG calibration tags the pipeline needs (ColorMatrix1 ==
xyz_to_cam, AsShotNeutral -> wb_coeffs, BlackLevel/BlackLevelRepeatDim/
WhiteLevel, LinearizationTable, ActiveArea/DefaultCrop, Orientation,
CFAPattern). Anything else is rejected with a ValueError naming the gap;
the IFD walk itself is bounds-checked and loop-guarded (tiff.py), so
malformed files error cleanly instead of crashing or hanging.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .raw import CFA, Orientation, RawImage
from .tiff import (TiffFile, exif_to_orientation,
                   T_WIDTH, T_LENGTH, T_BITS, T_COMPRESSION, T_PHOTOMETRIC,
                   T_MAKE, T_MODEL, T_STRIP_OFFSETS, T_ORIENTATION,
                   T_ROWS_PER_STRIP, T_STRIP_BYTECOUNTS, T_CFA_REPEAT,
                   T_CFA_PATTERN)
from . import native

__all__ = ["read_dng", "write_dng"]

# TIFF tag ids.
T_NEWSUBFILETYPE = 254
T_SAMPLES_PER_PIXEL = 277
T_PREDICTOR = 317
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_BYTECOUNTS = 325
T_SAMPLE_FORMAT = 339
T_DNG_VERSION = 50706
T_LINEARIZATION = 50712
T_BLACK_LEVEL_REPEAT = 50713
T_COLOR_MATRIX_1 = 50721
T_AS_SHOT_NEUTRAL = 50728
T_BLACK_LEVEL = 50714
T_WHITE_LEVEL = 50717
T_DEFAULT_CROP_ORIGIN = 50719
T_DEFAULT_CROP_SIZE = 50720
T_ACTIVE_AREA = 50829

_ORIENTATION_TO_EXIF = {exif_to_orientation(k): k for k in range(1, 9)}


def _fp24_to_f32(b3: np.ndarray) -> np.ndarray:
    """DNG 1.4 24-bit float -> float32. Layout (DNG spec 1.4, 'Floating
    Point Predictors' / BitsPerSample 24): 1 sign bit, 7 exponent bits at
    the STANDARD bias 2^(7-1)-1 = 63 (same convention as fp16's 15 and
    fp32's 127), 16 mantissa bits; `b3` is (n, 3) MSB-first bytes.
    Exact: a 16-bit mantissa always fits fp32, and ldexp scaling is
    exact, so float64 intermediate arithmetic introduces no rounding."""
    b = b3.astype(np.uint32)
    exp = (b[:, 0] & 0x7F).astype(np.int32)
    frac = ((b[:, 1] << 8) | b[:, 2]).astype(np.int64)
    # Normal: (1 + frac/2^16) * 2^(exp-63); denormal (exp 0): frac * 2^-78.
    mag = np.where(exp == 0,
                   np.ldexp(frac.astype(np.float64), -78),
                   np.ldexp((frac + 0x10000).astype(np.float64), exp - 63 - 16))
    special = exp == 0x7F
    if special.any():
        mag = np.where(special, np.where(frac == 0, np.inf, np.nan), mag)
    sign = np.where(b[:, 0] & 0x80, -1.0, 1.0)
    return (sign * mag).astype(np.float32)


def _f32_to_fp24(vals: np.ndarray) -> np.ndarray:
    """float32 -> DNG fp24 (n, 3) MSB-first bytes; mantissa truncates
    (23 -> 16 bits), out-of-range exponents saturate to +-inf / flush to
    the fp24 denormal range (to zero below it). The canonical encoder
    for round-trip tests: every fp24 value round-trips bit-exact."""
    u = np.ascontiguousarray(vals, np.float32).view(np.uint32).ravel()
    sign = (u >> 31).astype(np.uint32)
    exp32 = ((u >> 23) & 0xFF).astype(np.int32)
    frac16 = ((u & 0x7FFFFF) >> 7).astype(np.int64)
    e24 = exp32 - 127 + 63
    # Specials first; then overflow->inf, normals, denormals, underflow->0.
    is_special = exp32 == 0xFF
    nan_frac = np.where((u & 0x7FFFFF) != 0,
                        np.maximum(frac16, 1), 0)
    # Denormalize: value = 2^(e24-...) -> frac = (2^16 + frac16) >> (1 - e24)
    shift = np.clip(1 - e24, 0, 18)
    den_frac = (frac16 + 0x10000) >> shift
    exp_out = np.where(is_special, 0x7F,
                       np.where(e24 >= 0x7F, 0x7F,
                                np.where(e24 >= 1, e24, 0)))
    frac_out = np.where(is_special, nan_frac,
                        np.where(e24 >= 0x7F, 0,
                                 np.where(e24 >= 1, frac16, den_frac)))
    # f32 zero / tiny denormals (exp32 == 0) flush to fp24 zero.
    zero = exp32 == 0
    exp_out = np.where(zero, 0, exp_out)
    frac_out = np.where(zero, 0, frac_out)
    out = np.empty((u.size, 3), np.uint8)
    out[:, 0] = ((sign << 7) | exp_out.astype(np.uint32)).astype(np.uint8)
    out[:, 1] = (frac_out >> 8).astype(np.uint8)
    out[:, 2] = (frac_out & 0xFF).astype(np.uint8)
    return out


def read_dng(path: str) -> RawImage:
    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf)
    endian = tf.endian
    ifds = tf.ifds

    def get(e, tag, default=None):
        v = e.get(tag)
        return v if v is not None else default

    # Pick the RAW IFD: CFA photometric preferred, else largest main image.
    raw_ifd = None
    for e in ifds:
        pm = get(e, T_PHOTOMETRIC, [None])[0]
        if pm == 32803:
            raw_ifd = e
            break
    if raw_ifd is None:
        candidates = [e for e in ifds
                      if T_WIDTH in e and (T_STRIP_OFFSETS in e or T_TILE_OFFSETS in e)]
        if not candidates:
            raise ValueError("no raster IFD found")
        raw_ifd = max(candidates, key=lambda e: get(e, T_WIDTH, [0])[0] * get(e, T_LENGTH, [0])[0])

    e = raw_ifd
    width = get(e, T_WIDTH)[0]
    height = get(e, T_LENGTH)[0]
    bits = get(e, T_BITS, [16])[0]
    compression = get(e, T_COMPRESSION, [1])[0]
    if compression not in (1, 7, 8, 34892):
        raise ValueError(
            f"unsupported DNG compression {compression} "
            "(uncompressed=1, lossless JPEG=7, Deflate=8, lossy JPEG=34892)")
    spp = get(e, T_SAMPLES_PER_PIXEL, [1])[0]
    if spp not in (1, 3):
        raise ValueError(
            f"DNG with {spp} samples/pixel unsupported (1 = CFA/gray, "
            "3 = LinearRaw/demosaiced)")
    if spp == 3 and get(e, T_PHOTOMETRIC, [1])[0] == 32803:
        raise ValueError("CFA photometric with 3 samples/pixel is invalid")
    sample_format = get(e, T_SAMPLE_FORMAT, [1])[0]
    is_float = sample_format == 3
    if sample_format not in (1, 3):
        raise ValueError(f"unsupported DNG SampleFormat {sample_format}")
    if is_float:
        if compression not in (1, 8):
            raise ValueError(f"float DNG with compression {compression} "
                             "unsupported (uncompressed or Deflate)")
        if bits not in (16, 24, 32):
            raise ValueError(f"float DNG at {bits}-bit unsupported "
                             "(16/24/32 supported)")
    if compression == 34892:
        # DNG 1.4 lossy JPEG: standard 8-bit baseline JFIF streams per
        # strip/tile (the Lightroom "lossy DNG" shape). The payload codec
        # is stock libjpeg-compatible baseline JPEG — decoded through PIL,
        # the same library class the reference stack links (rawloader
        # defers lossy DNG to an ordinary JPEG decoder). No recalled
        # constants: the container route + spec guards are the whole
        # implementation surface. (SampleFormat 3 with 34892 is already
        # rejected by the float-compression guard above.)
        if bits != 8:
            raise ValueError(f"lossy-JPEG DNG must be 8-bit (got {bits})")
        if get(e, T_PHOTOMETRIC, [1])[0] == 32803:
            raise ValueError("lossy-JPEG DNG with CFA photometric is "
                             "invalid (DNG 1.4 allows it only on "
                             "LinearRaw data)")

    # TIFF Predictor (DNG 1.4 ships Deflate with horizontal differencing on
    # integers and the byte-planar floating-point predictor on floats; the
    # DNG-1.4 predictor codes 34892+ are refused by name).
    predictor = get(e, T_PREDICTOR, [1])[0]
    if predictor not in (1, 2, 3):
        raise ValueError(f"unsupported TIFF Predictor {predictor} "
                         "(1/2/3 supported; DNG 1.4 34892+ are not)")
    if predictor != 1 and compression != 8:
        raise ValueError(f"Predictor {predictor} with compression "
                         f"{compression} unsupported (Deflate only)")
    if predictor == 2 and (is_float or bits not in (8, 16)):
        raise ValueError("horizontal Predictor 2 supported only for "
                         f"8/16-bit integer samples (got {bits}-bit, "
                         f"SampleFormat {sample_format})")
    if predictor == 3 and not is_float:
        raise ValueError("floating-point Predictor 3 on integer DNG data")

    def decode_uncompressed(chunk, npix):
        if is_float:
            bsz = bits // 8
            if chunk.size < npix * bsz:
                raise ValueError("truncated float DNG strip/tile")
            if bits == 24:
                b3 = np.asarray(chunk[: npix * 3]).reshape(npix, 3)
                return _fp24_to_f32(b3[:, ::-1] if endian == "<" else b3)
            fmt = ("<" if endian == "<" else ">") + ("f4" if bits == 32 else "f2")
            return np.frombuffer(chunk[: npix * bsz].tobytes(), fmt).astype(np.float32)
        if bits == 16:
            if chunk.size < npix * 2:
                raise ValueError("truncated 16-bit DNG strip/tile")
            if endian == "<":
                return np.frombuffer(chunk[: npix * 2].tobytes(), "<u2").astype(np.uint16)
            return native.swap_16be(chunk, npix)
        elif bits == 12:
            # The native unpackers take no source length; check the packed
            # extent before handing the chunk over.
            if chunk.size < (npix + 1) // 2 * 3:
                raise ValueError("truncated 12-bit DNG strip/tile")
            return native.unpack_12be(chunk, npix)
        elif bits == 14:
            if chunk.size < (npix + 3) // 4 * 7:
                raise ValueError("truncated 14-bit DNG strip/tile")
            return native.unpack_14be(chunk, npix)
        elif bits == 8:
            if chunk.size < npix:
                raise ValueError("truncated 8-bit DNG strip/tile")
            return chunk[:npix].astype(np.uint16)
        raise ValueError(f"unsupported BitsPerSample {bits}")

    def decode_deflated(chunk, nrows, ncols, what):
        import zlib

        try:
            payload = zlib.decompress(chunk.tobytes())
        except zlib.error as ex:
            raise ValueError(f"corrupt Deflate stream in DNG {what}: {ex}") from ex
        if predictor == 1:
            # Plain inflate: the byte stream is the uncompressed layout
            # (any bit depth, incl. 12/14-bit packed).
            return decode_uncompressed(
                np.frombuffer(payload, np.uint8), nrows * ncols).reshape(nrows, ncols)
        bsz = bits // 8
        need = nrows * ncols * bsz
        if len(payload) < need:
            raise ValueError(f"truncated inflated DNG {what}")
        if predictor == 2:
            # Horizontal differencing per row, modulo 2^bits. TIFF 6.0:
            # each sample differences against the previous pixel's SAME
            # component, so spp=3 rows cumsum per channel.
            fmt = ("<" if endian == "<" else ">") + ("u2" if bits == 16 else "u1")
            vals = np.frombuffer(payload, fmt, nrows * ncols).reshape(nrows, -1, spp)
            vals = np.cumsum(vals.astype(np.int64), axis=1) & ((1 << bits) - 1)
            return vals.reshape(nrows, ncols).astype(np.uint16)
        # Predictor 3 (TIFF TechNote 3): each row holds MSB-first byte
        # planes of the samples, byte-differenced; undo the differencing
        # then reassemble big-endian samples (plane order is independent
        # of the file byte order).
        arr = np.frombuffer(payload, np.uint8, need).reshape(nrows, ncols * bsz)
        acc = (np.cumsum(arr, axis=1, dtype=np.int64) & 0xFF).astype(np.uint8)
        planes = acc.reshape(nrows, bsz, ncols)
        be = np.ascontiguousarray(np.moveaxis(planes, 1, 2))
        if bits == 24:
            return _fp24_to_f32(be.reshape(-1, 3)).reshape(nrows, ncols)
        fmt = ">f4" if bits == 32 else ">f2"
        vals = np.frombuffer(be.tobytes(), fmt).reshape(nrows, ncols)
        return vals.astype(np.float32)

    def decode_lossy_jpeg(chunk, nrows, ncols, what):
        from io import BytesIO

        from PIL import Image

        try:
            im = Image.open(BytesIO(chunk.tobytes()))
            im.load()
        except Exception as ex:
            raise ValueError(
                f"corrupt lossy-JPEG stream in DNG {what}: {ex}") from ex
        arr = np.asarray(im)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.dtype != np.uint8 or arr.shape[2] != spp:
            raise ValueError(
                f"lossy-JPEG DNG {what} decodes to {arr.dtype} "
                f"x{arr.shape[2]} (expected uint8 x{spp})")
        if arr.shape[0] != nrows or arr.shape[1] * spp != ncols:
            raise ValueError(
                f"lossy-JPEG DNG {what} is {arr.shape[1]}x{arr.shape[0]}, "
                f"expected {ncols // spp}x{nrows}")
        return arr.reshape(nrows, ncols).astype(np.uint16)

    def decode_chunk(chunk, nrows, ncols, what):
        if compression == 7:
            from .lj92 import decode as lj92_decode

            return lj92_decode(chunk.tobytes()).reshape(nrows, ncols)
        if compression == 8:
            return decode_deflated(chunk, nrows, ncols, what)
        if compression == 34892:
            return decode_lossy_jpeg(chunk, nrows, ncols, what)
        return decode_uncompressed(chunk, nrows * ncols).reshape(nrows, ncols)

    def decode_chunks(jobs):
        """Decode [(chunk, nrows, ncols, what)] -> list of arrays.
        Chunks are independent and the hot codecs (native lj92 via
        ctypes, zlib inflate) release the GIL, so multi-chunk payloads
        decode in a small thread pool (deterministic placement by
        index; the first error propagates)."""
        if len(jobs) <= 1 or compression == 1:
            return [decode_chunk(*j) for j in jobs]
        from concurrent.futures import ThreadPoolExecutor

        workers = min(len(jobs), os.cpu_count() or 1, 8)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(lambda j: decode_chunk(*j), jobs))

    # Samples per row scale by spp; a LinearRaw (spp=3) payload stays in
    # the flat [H, W*3] interleaved layout RawImage permits (raw.py:215 —
    # engine.normalize_plane reshapes it on the way into the develop).
    payload_dtype = np.float32 if is_float else np.uint16
    if T_TILE_OFFSETS in e:
        # Tiled layout (the common shape for Compression=7 DNGs).
        tw = get(e, T_TILE_WIDTH)[0]
        tl = get(e, T_TILE_LENGTH)[0]
        offsets = get(e, T_TILE_OFFSETS)
        counts = get(e, T_TILE_BYTECOUNTS)
        tiles_x = -(-width // tw)
        tiles_y = -(-height // tl)
        data = np.zeros((tiles_y * tl, tiles_x * tw * spp), payload_dtype)
        jobs = []
        for off, cnt in zip(offsets, counts):
            tf._check(off, cnt, "tile data")
            jobs.append((np.frombuffer(buf, np.uint8, cnt, off), tl, tw * spp,
                         "tile data"))
        for ti, tile in enumerate(decode_chunks(jobs)):
            ty, tx = divmod(ti, tiles_x)
            data[ty * tl:(ty + 1) * tl,
                 tx * tw * spp:(tx + 1) * tw * spp] = tile
        data = data[:height, :width * spp]
    else:
        offsets = get(e, T_STRIP_OFFSETS)
        counts = get(e, T_STRIP_BYTECOUNTS)
        rows_per_strip = get(e, T_ROWS_PER_STRIP, [height])[0]
        jobs = []
        for si, (off, cnt) in enumerate(zip(offsets, counts)):
            nrows = min(rows_per_strip, height - si * rows_per_strip)
            tf._check(off, cnt, "strip data")
            jobs.append((np.frombuffer(buf, np.uint8, cnt, off), nrows,
                         width * spp, "strip data"))
        data = np.concatenate(decode_chunks(jobs), axis=0)
    if data.shape != (height, width * spp):
        raise ValueError(f"DNG payload {data.shape} != {(height, width * spp)}")

    # LinearizationTable (DNG 1.0, tag 50712): u16 LUT applied to the raw
    # counts before level subtraction (rawloader applies it the same way).
    lintable = get(e, T_LINEARIZATION)
    if lintable is not None:
        if is_float:
            raise ValueError("LinearizationTable on a float DNG is invalid")
        lut = np.asarray(lintable, np.uint16)
        data = lut[np.minimum(data.astype(np.int64), len(lut) - 1)]

    # CFA pattern.
    pm = get(e, T_PHOTOMETRIC, [1])[0]
    if pm == 32803:
        ph, pw = get(e, T_CFA_REPEAT, [2, 2])
        pat = get(e, T_CFA_PATTERN, [0, 1, 1, 2])
        letters = "RGBE"
        # Honor CFARepeatPatternDim: e.g. a 16-entry pattern may be 2x8 or
        # 4x4, not the 8x2 the length-based fallback would assume.
        cfa = CFA("".join(letters[v] for v in pat[: ph * pw]),
                  height=int(ph), width=int(pw))
    else:
        cfa = CFA("")

    # Levels. BlackLevelRepeatDim (50713) gives the black pattern shape; the
    # pipeline's level model is per-CFA-cell (4 channels), so 1x1 broadcasts
    # and 2x2 maps row-major -- anything else is rejected explicitly rather
    # than silently mis-mapped.
    if is_float:
        white = int(get(e, T_WHITE_LEVEL, [1])[0])
    else:
        white = int(get(e, T_WHITE_LEVEL, [(1 << bits) - 1])[0])
    blacks = get(e, T_BLACK_LEVEL, [0])
    repeat = get(e, T_BLACK_LEVEL_REPEAT, None)
    if spp == 3:
        # LinearRaw: BlackLevel count is per SAMPLE (1 shared or spp
        # per-channel entries); a spatial repeat pattern is meaningless
        # on demosaiced data.
        if repeat is not None and (int(repeat[0]), int(repeat[1])) != (1, 1):
            raise ValueError("BlackLevelRepeatDim on a LinearRaw DNG "
                             "must be 1x1")
        if len(blacks) not in (1, 3):
            raise ValueError(f"LinearRaw BlackLevel with {len(blacks)} "
                             "entries (1 or 3 supported)")
        if len(blacks) == 3:
            blacks = list(blacks) + [0]
    elif repeat is not None:
        rr, rc = int(repeat[0]), int(repeat[1])
        if (rr, rc) not in ((1, 1), (2, 2)) or rr * rc != len(blacks):
            raise ValueError(
                f"unsupported BlackLevelRepeatDim {rr}x{rc} with "
                f"{len(blacks)} BlackLevel entries (1x1 and 2x2 supported)")
    elif len(blacks) not in (1, 4):
        raise ValueError(f"BlackLevel with {len(blacks)} entries needs "
                         "BlackLevelRepeatDim")
    if len(blacks) == 1:
        blacks = blacks * 4
    blacks = [int(round(b)) for b in blacks[:4]]

    # Crops: ActiveArea (top,left,bottom,right) then DefaultCrop within it.
    aa = get(e, T_ACTIVE_AREA, [0, 0, height, width])
    crop_origin = get(e, T_DEFAULT_CROP_ORIGIN, [0, 0])
    crop_size = get(e, T_DEFAULT_CROP_SIZE, [aa[3] - aa[1], aa[2] - aa[0]])
    top = aa[0] + int(crop_origin[1])
    left = aa[1] + int(crop_origin[0])
    cw, ch = int(crop_size[0]), int(crop_size[1])
    crops = (top, max(0, width - left - cw), max(0, height - top - ch), left)

    # Calibration: search all IFDs (usually IFD0) for DNG color tags.
    cm = neutral = orient_v = None
    for ee in ifds:
        if cm is None and T_COLOR_MATRIX_1 in ee:
            cm = get(ee, T_COLOR_MATRIX_1)
        if neutral is None and T_AS_SHOT_NEUTRAL in ee:
            neutral = get(ee, T_AS_SHOT_NEUTRAL)
        if orient_v is None and T_ORIENTATION in ee:
            orient_v = get(ee, T_ORIENTATION)[0]
    if cm is not None and len(cm) >= 9:
        xyz_to_cam = np.array(cm[:9], np.float32).reshape(3, 3)
        xyz_to_cam = np.concatenate([xyz_to_cam, np.zeros((1, 3), np.float32)], axis=0)
    else:
        xyz_to_cam = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]], np.float32)
    if neutral is not None and len(neutral) >= 3 and all(v > 0 for v in neutral[:3]):
        wb = (1.0 / neutral[0], 1.0 / neutral[1], 1.0 / neutral[2], float("nan"))
    else:
        wb = (float("nan"),) * 4
    orientation = exif_to_orientation(orient_v or 1)

    return RawImage(
        width=width, height=height, cpp=spp, crops=crops,
        blacklevels=tuple(blacks), whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam, orientation=orientation,
        cfa=cfa, data=data)


# ---------------------------------------------------------------------------
# Writer (uncompressed 16-bit CFA DNG) -- for interchange and tests.
# ---------------------------------------------------------------------------


def _float_payload(data: np.ndarray, float_bits: int) -> bytes:
    """Uncompressed little-endian float sample bytes at 32 or 24 bits."""
    if float_bits == 24:
        return _f32_to_fp24(data)[:, ::-1].tobytes()
    return data.astype("<f4").tobytes()


def write_dng(path: str, raw: RawImage, compression: int = 1,
              predictor: int | None = None, quality: int = 90,
              float_bits: int = 32) -> None:
    """compression: 1 = uncompressed, 7 = lossless JPEG (LJ92, 16-bit
    integer), 8 = Deflate (DNG 1.4), 34892 = lossy JPEG (DNG 1.4: 8-bit
    baseline JFIF on LinearRaw data — requires the raw payload to already
    be 8-bit-ranged; `quality` applies only here). Float32 payloads write
    SampleFormat 3 (the HDR-DNG shape) at `float_bits` 32 or 24 (fp24
    truncates the mantissa — values already on the fp24 grid round-trip
    bit-exact). With Deflate, predictor defaults to the shape Adobe tools
    emit: 2 (horizontal) for integers, 3 (floating-point byte-planar) for
    floats; pass predictor=1 for plain inflate."""
    assert raw.cpp in (1, 3), "writer supports CFA/gray and LinearRaw"
    assert compression in (1, 7, 8, 34892)
    assert float_bits in (24, 32)
    spp = raw.cpp
    is_float = np.asarray(raw.data).dtype == np.float32
    if is_float:
        assert compression in (1, 8), "float DNG writes uncompressed or Deflate"
        data = np.ascontiguousarray(
            np.asarray(raw.data, np.float32).reshape(raw.height,
                                                     raw.width * spp))
    else:
        data = np.ascontiguousarray(
            np.asarray(raw.data, np.uint16).reshape(raw.height,
                                                    raw.width * spp))
    if predictor is None:
        predictor = (3 if is_float else 2) if compression == 8 else 1
    assert predictor in (1, 2, 3) and (predictor == 1 or compression == 8)
    assert (predictor != 2 or not is_float) and (predictor != 3 or is_float)
    is_cfa = raw.cfa.is_valid() and spp == 1
    is_lossy = compression == 34892
    if is_lossy:
        # DNG 1.4 lossy JPEG: LinearRaw only, 8-bit payload.
        assert not is_float and not is_cfa, \
            "lossy-JPEG DNG writes LinearRaw integer data only"
        assert data.max(initial=0) <= 255 and raw.whitelevels[0] <= 255, \
            "lossy-JPEG DNG payload must be 8-bit-ranged"
        from io import BytesIO

        from PIL import Image

        arr8 = data.reshape(raw.height, raw.width, spp).astype(np.uint8)
        im = (Image.fromarray(arr8[:, :, 0], "L") if spp == 1
              else Image.fromarray(arr8, "RGB"))
        bio = BytesIO()
        im.save(bio, "JPEG", quality=int(quality), subsampling=0)
        payload = bio.getvalue()
    elif compression == 7:
        from .lj92 import encode as lj92_encode

        # Interleaved components so each predicts from its own plane:
        # 3 for LinearRaw; 2 for even-width CFA rows (like real DNG
        # encoders).
        ncomp = 3 if spp == 3 else (
            2 if (is_cfa and raw.width % 2 == 0) else 1)
        payload = lj92_encode(data, ncomp=ncomp, precision=16)
    elif compression == 8:
        import zlib

        h, w = raw.height, raw.width * spp
        if predictor == 3:
            # TIFF TechNote 3 float predictor: per row, MSB-first byte
            # planes of the big-endian samples, then byte differencing.
            bsz = float_bits // 8
            if float_bits == 24:
                be = _f32_to_fp24(data).reshape(h, w, 3)
            else:
                be = data.astype(">f4").view(np.uint8).reshape(h, w, 4)
            rowsb = np.moveaxis(be, 2, 1).reshape(h, bsz * w).astype(np.int16)
            rowsb[:, 1:] = (rowsb[:, 1:] - rowsb[:, :-1]) & 0xFF
            payload = zlib.compress(rowsb.astype(np.uint8).tobytes())
        elif predictor == 2:
            # Horizontal differencing against the previous pixel's SAME
            # component (TIFF 6.0) — stride spp.
            d = data.astype(np.int32)
            d[:, spp:] = (d[:, spp:] - d[:, :-spp]) & 0xFFFF
            payload = zlib.compress(d.astype("<u2").tobytes())
        elif is_float:
            payload = zlib.compress(_float_payload(data, float_bits))
        else:
            payload = zlib.compress(data.astype("<u2").tobytes())
    elif is_float:
        payload = _float_payload(data, float_bits)
    else:
        payload = data.astype("<u2").tobytes()

    entries = []  # (tag, type, count, values)

    def add(tag, typ, vals):
        entries.append((tag, typ, vals))

    add(T_NEWSUBFILETYPE, 4, [0])
    add(T_WIDTH, 4, [raw.width])
    add(T_LENGTH, 4, [raw.height])
    add(T_BITS, 3, [8] * spp if is_lossy
        else [float_bits if is_float else 16])
    add(T_COMPRESSION, 3, [compression])
    if is_float:
        add(T_SAMPLE_FORMAT, 3, [3])
    if predictor != 1:
        add(T_PREDICTOR, 3, [predictor])
    add(T_PHOTOMETRIC, 3, [32803 if is_cfa else 34892])
    add(T_ORIENTATION, 3, [_ORIENTATION_TO_EXIF.get(raw.orientation, 1)])
    if raw.make:
        add(T_MAKE, 2, raw.make)
    if raw.model:
        add(T_MODEL, 2, raw.model)
    add(T_SAMPLES_PER_PIXEL, 3, [spp])
    add(T_ROWS_PER_STRIP, 4, [raw.height])
    add(T_STRIP_BYTECOUNTS, 4, [len(payload)])
    if is_cfa:
        # Pattern bytes from the grid, not the name (non-canonical dims
        # carry an "HxW:" prefix in the name).
        add(T_CFA_REPEAT, 3, [raw.cfa.height, raw.cfa.width])
        add(T_CFA_PATTERN, 1, [int(v) for v in raw.cfa.pattern.ravel()])
    add(T_DNG_VERSION, 1, [1, 4, 0, 0])
    if spp == 3:
        add(T_BLACK_LEVEL, 3, [int(b) for b in raw.blacklevels[:3]])
    else:
        add(T_BLACK_LEVEL, 3, [int(b) for b in raw.blacklevels])
    add(T_WHITE_LEVEL, 3, [int(raw.whitelevels[0])])
    top, right, bottom, left = raw.crops
    add(T_DEFAULT_CROP_ORIGIN, 4, [left, top])
    add(T_DEFAULT_CROP_SIZE, 4, [raw.width - left - right, raw.height - top - bottom])
    # ColorMatrix1 as SRATIONALs with denominator 10000.
    cmvals = []
    for v in np.asarray(raw.xyz_to_cam[:3], np.float64).ravel():
        cmvals.append((int(round(v * 10000)), 10000))
    add(T_COLOR_MATRIX_1, 10, cmvals)
    wb = raw.wb_coeffs
    if all(np.isfinite(wb[i]) and wb[i] > 0 for i in range(3)):
        neut = [(int(round(1.0 / wb[i] * 10000)), 10000) for i in range(3)]
        add(T_AS_SHOT_NEUTRAL, 5, neut)

    # Layout: header(8) + IFD + ext data + strip data.
    entries.append((T_STRIP_OFFSETS, 4, [0]))  # patched below
    entries.sort(key=lambda t: t[0])

    def pack_vals(typ, vals):
        if typ == 3:
            return struct.pack(f"<{len(vals)}H", *vals)
        if typ == 4:
            return struct.pack(f"<{len(vals)}I", *vals)
        if typ == 1:
            return struct.pack(f"{len(vals)}B", *vals)
        if typ == 2:   # ASCII, nul-terminated
            return vals.encode("ascii", "replace") + b"\0"
        if typ == 5:
            flat = [x for pair in vals for x in pair]
            return struct.pack(f"<{len(flat)}I", *flat)
        if typ == 10:
            flat = [x for pair in vals for x in pair]
            return struct.pack(f"<{len(flat)}i", *flat)
        raise ValueError(typ)

    n = len(entries)
    ifd_off = 8
    ext_off = ifd_off + 2 + n * 12 + 4
    ext = bytearray()
    packed = []
    for tag, typ, vals in entries:
        count = len(vals) + 1 if typ == 2 else len(vals)  # ASCII incl. nul
        raw_bytes = pack_vals(typ, vals)
        if len(raw_bytes) <= 4:
            packed.append((tag, typ, count, raw_bytes.ljust(4, b"\0"), None))
        else:
            packed.append((tag, typ, count, None, ext_off + len(ext)))
            ext += raw_bytes
    strip_off = ext_off + len(ext)

    out = bytearray()
    out += struct.pack("<2sHI", b"II", 42, ifd_off)
    out += struct.pack("<H", n)
    for tag, typ, count, inline, off in packed:
        if tag == T_STRIP_OFFSETS:
            inline, off = struct.pack("<I", strip_off), None
        if inline is not None:
            out += struct.pack("<HHI", tag, typ, count) + inline
        else:
            out += struct.pack("<HHII", tag, typ, count, off)
    out += struct.pack("<I", 0)  # next IFD
    out += ext
    out += payload
    with open(path, "wb") as f:
        f.write(out)
