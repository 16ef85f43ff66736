"""Lossless JPEG (ITU T.81 process 14, "LJ92") codec.

DNG's Compression=7 and most camera RAW containers wrap sensor data in
lossless-JPEG scans. Decode dispatches to the native C++ decoder
(native/lj92.cc, via ctypes) with a pure-Python fallback; the encoder here
(predictor 1, fixed canonical Huffman table) serves the DNG writer and
round-trip tests.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

__all__ = ["decode", "encode"]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode(data: bytes) -> np.ndarray:
    """LJ92 stream -> [height, width*ncomp] uint16 (components interleaved
    into consecutive columns, the DNG CFA convention)."""
    if native.have_native() and hasattr(native._lib, "lj92_decode"):
        return _decode_native(data)
    return _decode_python(data)


def sof_precision(data: bytes) -> int:
    """Sample precision from the stream's SOF3 segment (the authoritative
    bit depth of a lossless-JPEG payload; vendors' data maxima are not --
    a dark 14-bit frame can stay below 4096)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            break
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:      # fill byte: only the second 0xFF advances
            pos -= 1
            continue
        # Standalone markers carry no length segment (T.81 B.1.1.3): TEM,
        # RSTn, and a repeated SOI.
        if marker == 0xD8 or marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        seglen = (data[pos] << 8) | data[pos + 1]
        if marker == 0xC3:
            if pos + 3 > len(data):
                break
            return int(data[pos + 2])
        if marker == 0xDA:
            break
        pos += seglen
    raise ValueError("no SOF3 segment in lossless-JPEG stream")


def sof_ncomp(data: bytes) -> int:
    """Component count from the SOF3 segment (2/4 = CFA interleave,
    3 = the sRAW/mRAW YCbCr flavor). Same walk as sof_precision."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            break
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:
            pos -= 1
            continue
        if marker == 0xD8 or marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        seglen = (data[pos] << 8) | data[pos + 1]
        if marker == 0xC3:
            if pos + 8 > len(data):
                break
            return int(data[pos + 7])
        if marker == 0xDA:
            break
        pos += seglen
    raise ValueError("no SOF3 segment in lossless-JPEG stream")


def _decode_native(data: bytes) -> np.ndarray:
    lib = native._lib
    fn = lib.lj92_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    w = ctypes.c_int()
    h = ctypes.c_int()
    nc = ctypes.c_int()
    prec = ctypes.c_int()
    rc = fn(data, len(data), None, 0, ctypes.byref(w), ctypes.byref(h),
            ctypes.byref(nc), ctypes.byref(prec))
    if rc != 0:
        raise ValueError(f"lj92 probe failed ({rc})")
    out = np.empty((h.value, w.value), np.uint16)
    rc = fn(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            out.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc),
            ctypes.byref(prec))
    if rc != 0:
        raise ValueError(f"lj92 decode failed ({rc})")
    return out


class _BitReader:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0
        self.bits = 0
        self.n = 0

    def get_bit(self) -> int:
        if self.n == 0:
            if self.pos >= len(self.d):
                return 0
            b = self.d[self.pos]
            self.pos += 1
            if b == 0xFF:
                if self.pos < len(self.d) and self.d[self.pos] == 0x00:
                    self.pos += 1
                else:
                    self.pos -= 1
                    return 0
            self.bits = b
            self.n = 8
        self.n -= 1
        return (self.bits >> self.n) & 1

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit()
        return v

    def reset_to_marker(self):
        self.n = 0
        d, i = self.d, self.pos
        while i < len(d) and d[i] != 0xFF:
            i += 1
        if i + 1 < len(d) and 0xD0 <= d[i + 1] <= 0xD7:
            i += 2
        self.pos = i


def _build_huff(counts, vals):
    # canonical code -> symbol map per length
    table = {}
    code = 0
    k = 0
    for l in range(1, 17):
        for _ in range(counts[l - 1]):
            table[(l, code)] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return table


def _extend(v, ssss):
    if ssss == 0:
        return 0
    if v < (1 << (ssss - 1)):
        return v - (1 << ssss) + 1
    return v


def _decode_python(data: bytes) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError("lj92: not a JPEG stream")
    pos = 2
    precision = height = width = ncomp = 0
    huffs = {}
    comp_table = [0] * 4
    predictor, pt, restart = 1, 0, 0
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError("lj92: marker desync (malformed stream)")
        marker = data[pos + 1]
        pos += 2
        seglen = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + seglen]
        if marker == 0xC3:
            precision = seg[0]
            height = (seg[1] << 8) | seg[2]
            width = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            pos += seglen
        elif marker == 0xC4:
            q = 0
            while q < len(seg):
                th = seg[q] & 0x0F
                q += 1
                counts = list(seg[q:q + 16])
                q += 16
                nvals = sum(counts)
                huffs[th] = _build_huff(counts, list(seg[q:q + nvals]))
                q += nvals
            pos += seglen
        elif marker == 0xDD:
            restart = (seg[0] << 8) | seg[1]
            pos += seglen
        elif marker == 0xDA:
            ns = seg[0]
            for i in range(ns):
                comp_table[i] = seg[1 + i * 2 + 1] >> 4
            predictor = seg[1 + ns * 2]
            pt = seg[3 + ns * 2] & 0x0F
            pos += seglen
            br = _BitReader(data[pos:])
            out = np.zeros((height, width * ncomp), np.uint16)
            default = 1 << (precision - pt - 1)
            for c in range(ncomp):
                if comp_table[c] not in huffs:
                    raise ValueError(
                        f"LJ92: scan references undefined huffman "
                        f"table {comp_table[c]}")

            def huff_decode(tbl):
                code = br.get_bit()
                l = 1
                while (l, code) not in tbl:
                    code = (code << 1) | br.get_bit()
                    l += 1
                    if l > 16:
                        raise ValueError("bad huffman code")
                return tbl[(l, code)]

            fresh = True  # T.81: prediction resets at scan start AND after
            # every restart marker (the interval's first line predicts like
            # the first scan line).
            for y in range(height):
                first_line = fresh
                for x in range(width):
                    for c in range(ncomp):
                        ssss = huff_decode(huffs[comp_table[c]])
                        if ssss == 16:
                            diff = 32768
                        else:
                            diff = _extend(br.get_bits(ssss), ssss)
                        idx = x * ncomp + c
                        if first_line and x == 0:
                            pred = default
                        elif x == 0:
                            pred = int(out[y - 1, idx])
                        elif first_line:
                            pred = int(out[y, idx - ncomp])
                        else:
                            ra = int(out[y, idx - ncomp])
                            rb = int(out[y - 1, idx])
                            rc_ = int(out[y - 1, idx - ncomp])
                            pred = {1: ra, 2: rb, 3: rc_, 4: ra + rb - rc_,
                                    5: ra + ((rb - rc_) >> 1),
                                    6: rb + ((ra - rc_) >> 1),
                                    7: (ra + rb) >> 1}[predictor]
                        out[y, idx] = (pred + diff) & 0xFFFF
                fresh = False
                if restart and (y + 1) % restart == 0 and y + 1 < height:
                    br.reset_to_marker()
                    fresh = True
            if pt:
                out <<= pt
            return out
        elif marker == 0xD9:
            break
        else:
            pos += seglen
    raise ValueError("no SOS in LJ92 stream")


# ---------------------------------------------------------------------------
# Encode (predictor 1, fixed canonical Huffman)
# ---------------------------------------------------------------------------

# Lengths per SSSS category 0..16: a valid (incomplete) prefix code.
_ENC_LENGTHS = [2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def _enc_table():
    counts = [0] * 16
    for l in _ENC_LENGTHS:
        counts[l - 1] += 1
    # canonical assignment in symbol order grouped by length
    order = sorted(range(17), key=lambda s: (_ENC_LENGTHS[s], s))
    codes = {}
    code = 0
    prev_len = _ENC_LENGTHS[order[0]]
    for s in order:
        code <<= (_ENC_LENGTHS[s] - prev_len)
        prev_len = _ENC_LENGTHS[s]
        codes[s] = (code, _ENC_LENGTHS[s])
        code += 1
    vals = order
    return counts, vals, codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)
                self.acc = 0
                self.n = 0

    def flush(self):
        if self.n:
            self.acc <<= (8 - self.n)
            self.acc |= (1 << (8 - self.n)) - 1  # pad with 1s per convention
            self.out.append(self.acc)
            if self.acc == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.n = 0


def encode(img: np.ndarray, ncomp: int = 1, precision: int = 16,
           restart_rows: int = 0) -> bytes:
    """[height, width*ncomp] u16 -> LJ92 stream (predictor 1).
    restart_rows > 0 emits DRI + RSTn every restart_rows lines."""
    img = np.asarray(img, np.uint16)
    height, wtot = img.shape
    assert wtot % ncomp == 0
    width = wtot // ncomp

    counts, vals, codes = _enc_table()
    out = bytearray(b"\xff\xd8")
    # SOF3
    sof = bytearray([precision,
                     height >> 8, height & 0xFF, width >> 8, width & 0xFF, ncomp])
    for c in range(ncomp):
        sof += bytes([c, 0x11, 0])
    out += b"\xff\xc3" + (len(sof) + 2).to_bytes(2, "big") + sof
    # DHT (table 0)
    dht = bytearray([0x00]) + bytes(counts) + bytes(vals)
    out += b"\xff\xc4" + (len(dht) + 2).to_bytes(2, "big") + dht
    if restart_rows:
        out += b"\xff\xdd" + (4).to_bytes(2, "big") + restart_rows.to_bytes(2, "big")
    # SOS: predictor 1, pt 0
    sos = bytearray([ncomp])
    for c in range(ncomp):
        sos += bytes([c, 0x00])
    sos += bytes([1, 0, 0])
    out += b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos

    bw = _BitWriter()
    default = 1 << (precision - 1)
    img_i = img.astype(np.int64)
    rst = 0
    fresh = True
    for y in range(height):
        first_line = fresh
        for x in range(width):
            for c in range(ncomp):
                idx = x * ncomp + c
                if first_line and x == 0:
                    pred = default
                elif x == 0:
                    pred = int(img_i[y - 1, idx])
                else:
                    pred = int(img_i[y, idx - ncomp])  # predictor 1 = Ra
                diff = (int(img_i[y, idx]) - pred)
                # wrap to 16-bit two's complement range
                diff = ((diff + 32768) & 0xFFFF) - 32768
                if diff == 0:
                    ssss = 0
                elif diff == 32768 or diff == -32768:
                    ssss = 16
                else:
                    ssss = int(abs(diff)).bit_length()
                code, nb = codes[ssss]
                bw.put(code, nb)
                if ssss == 16:
                    pass  # diff == 32768, no magnitude bits
                elif ssss > 0:
                    v = diff if diff >= 0 else diff + (1 << ssss) - 1
                    bw.put(v, ssss)
        fresh = False
        if restart_rows and (y + 1) % restart_rows == 0 and y + 1 < height:
            bw.flush()
            out += bw.out
            out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            bw = _BitWriter()
            fresh = True
    bw.flush()
    out += bw.out
    out += b"\xff\xd9"
    return bytes(out)


# ---------------------------------------------------------------------------
# Canon sRAW/mRAW: subsampled 3-component lossless JPEG
# ---------------------------------------------------------------------------
#
# CR2 sRAW/mRAW payloads are SOF3 streams with THREE components where the
# luma carries sampling factors (2,1) for sRAW2/mRAW or (2,2) for sRAW1
# and the chromas are (1,1). Per T.81 an interleaved lossless MCU is then
# [Y..(hs*vs, raster order), Cb, Cr] and component i spans
# ceil(X*Hi/Hmax) samples per line. Prediction follows the reference
# chain's semantics (dcraw ljpeg_row's sraw branch, which rawloader's
# cr2 path mirrors): every Y sample predicts from the PREVIOUS DECODED Y
# (one chained predictor across the whole MCU row), except the row's
# first Y which uses the per-component vertical predictor (previous
# row's first value; 1 << (prec-1) on the first row); chromas use
# standard predictor-1 (previous MCU's same component, vertical
# predictor at row start).


def _parse_sof3_components(data: bytes):
    """(precision, lines, samples_per_line, [(h, v), ...]) from SOF3."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            break
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:
            pos -= 1
            continue
        if marker == 0xD8 or marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        seglen = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + seglen]
        if marker == 0xC3:
            prec = seg[0]
            lines = (seg[1] << 8) | seg[2]
            samples = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            hv = []
            for c in range(ncomp):
                b = seg[7 + c * 3]
                hv.append((b >> 4, b & 0x0F))
            return prec, lines, samples, hv
        if marker == 0xDA:
            break
        pos += seglen
    raise ValueError("no SOF3 segment in lossless-JPEG stream")


def decode_sraw(data: bytes):
    """Subsampled 3-component SOF3 stream -> (mcus [rows, n_mcu*clrs]
    int32, precision, hs, vs) where clrs = hs*vs + 2 and MCU slots are
    [Y raster..., Cb, Cr]."""
    prec, lines, samples, hv = _parse_sof3_components(data)
    if len(hv) != 3 or hv[1] != (1, 1) or hv[2] != (1, 1):
        raise ValueError(f"not an sRAW component layout: {hv}")
    hs, vs = hv[0]
    if (hs, vs) not in ((2, 1), (2, 2)):
        raise ValueError(f"unsupported sRAW sampling {hs}x{vs}")
    clrs = hs * vs + 2
    n_mcu = (samples + hs - 1) // hs
    # MCU rows: lines is the LUMA line count; each MCU row covers vs lines.
    rows = (lines + vs - 1) // vs

    # Walk to SOS collecting Huffman tables (same walk as _decode_python).
    pos = 2
    huffs = {}
    comp_table = [0, 0, 0]
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError("lj92: marker desync (malformed stream)")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:
            pos -= 1
            continue
        if marker == 0xD8 or marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        seglen = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + seglen]
        if marker == 0xC4:
            q = 0
            while q < len(seg):
                th = seg[q] & 0x0F
                q += 1
                counts = list(seg[q:q + 16])
                q += 16
                nvals = sum(counts)
                huffs[th] = _build_huff(counts, list(seg[q:q + nvals]))
                q += nvals
            pos += seglen
        elif marker == 0xDA:
            ns = seg[0]
            for i in range(min(ns, 3)):
                comp_table[i] = seg[1 + i * 2 + 1] >> 4
            pos += seglen
            break
        else:
            pos += seglen
    else:
        raise ValueError("no SOS in sRAW stream")
    br = _BitReader(data[pos:])
    # slot -> component (0 for all Y slots, then 1, 2)
    slot_comp = [0] * (hs * vs) + [1, 2]
    tabs = [huffs[comp_table[slot_comp[s]]] for s in range(clrs)]

    def huff_decode(tbl):
        code = br.get_bit()
        l = 1
        while (l, code) not in tbl:
            code = (code << 1) | br.get_bit()
            l += 1
            if l > 16:
                raise ValueError("bad huffman code")
        return tbl[(l, code)]

    out = np.zeros((rows, n_mcu * clrs), np.int32)
    default = 1 << (prec - 1)
    vpred = [default, default, default]
    n_y = hs * vs
    for y in range(rows):
        spred = 0
        for m in range(n_mcu):
            base = m * clrs
            for s in range(clrs):
                ssss = huff_decode(tabs[s])
                if ssss == 16:
                    diff = 32768
                else:
                    diff = _extend(br.get_bits(ssss), ssss)
                comp = slot_comp[s]
                if s < n_y:                       # luma: chained predictor
                    if m == 0 and s == 0:
                        pred = vpred[0]
                        vpred[0] = pred + diff
                    else:
                        pred = spred
                    val = (pred + diff) & 0xFFFF
                    spred = val
                else:                             # chroma: predictor 1
                    if m == 0:
                        pred = vpred[comp]
                        vpred[comp] = pred + diff
                    else:
                        pred = int(out[y, base - clrs + s])
                    val = (pred + diff) & 0xFFFF
                out[y, base + s] = val
    return out, prec, hs, vs


def encode_sraw(Y: np.ndarray, Cb: np.ndarray, Cr: np.ndarray,
                precision: int = 15) -> bytes:
    """Canonical sRAW encoder (tests + fixtures): the exact inverse of
    decode_sraw's prediction chain. Y: [lines, samples]; Cb/Cr at the
    subsampled grid [lines/vs, samples/hs]."""
    Y = np.asarray(Y, np.uint16)
    Cb = np.asarray(Cb, np.uint16)
    Cr = np.asarray(Cr, np.uint16)
    lines, samples = Y.shape
    vs = lines // Cb.shape[0]
    hs = samples // Cb.shape[1]
    assert (hs, vs) in ((2, 1), (2, 2)), (hs, vs)
    assert Cb.shape == Cr.shape == (lines // vs, samples // hs)
    assert lines % vs == 0 and samples % hs == 0
    clrs = hs * vs + 2
    n_mcu = samples // hs
    rows = lines // vs

    counts, vals, codes = _enc_table()
    out = bytearray(b"\xff\xd8")
    sof = bytearray([precision, rows * vs >> 8, (rows * vs) & 0xFF,
                     samples >> 8, samples & 0xFF, 3])
    sof += bytes([0, (hs << 4) | vs, 0])
    sof += bytes([1, 0x11, 0])
    sof += bytes([2, 0x11, 0])
    out += b"\xff\xc3" + (len(sof) + 2).to_bytes(2, "big") + sof
    dht = bytearray([0x00]) + bytes(counts) + bytes(vals)
    out += b"\xff\xc4" + (len(dht) + 2).to_bytes(2, "big") + dht
    sos = bytearray([3])
    for c in range(3):
        sos += bytes([c, 0x00])
    sos += bytes([1, 0, 0])
    out += b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos

    bw = _BitWriter()

    def put_diff(diff):
        diff = ((diff + 32768) & 0xFFFF) - 32768
        if diff == 0:
            ssss = 0
        elif diff == -32768:
            diff = 32768
            ssss = 16
        else:
            ssss = int(abs(diff)).bit_length()
        code, nb = codes[ssss]
        bw.put(code, nb)
        if 0 < ssss < 16:
            v = diff if diff >= 0 else diff + (1 << ssss) - 1
            bw.put(v, ssss)

    default = 1 << (precision - 1)
    vpred = [default, default, default]
    Yi = Y.astype(np.int64)
    planes = {1: Cb.astype(np.int64), 2: Cr.astype(np.int64)}
    for r in range(rows):
        spred = 0
        for m in range(n_mcu):
            for s in range(clrs):
                if s < hs * vs:
                    yy = r * vs + (s // hs)
                    xx = m * hs + (s % hs)
                    val = int(Yi[yy, xx])
                    if m == 0 and s == 0:
                        pred = vpred[0]
                        vpred[0] = val
                    else:
                        pred = spred
                    put_diff(val - pred)
                    spred = val
                else:
                    comp = 1 if s == hs * vs else 2
                    val = int(planes[comp][r, m])
                    if m == 0:
                        pred = vpred[comp]
                        vpred[comp] = val
                    else:
                        pred = int(planes[comp][r, m - 1])
                    put_diff(val - pred)
    bw.flush()
    out += bw.out
    out += b"\xff\xd9"
    return bytes(out)
