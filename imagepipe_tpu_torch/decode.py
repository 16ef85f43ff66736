"""File decoding: RAW formats first, raster fallback.

Equivalent of the L0 decode layer (SURVEY.md section 2.4; call site
the reference's src/pipeline.rs:262-272: rawloader::decode_file, falling
back to image::open). Camera RAW parsing is pluggable: decoders register via
`register_raw_decoder`; built-ins cover the framework's own .synraw.npz
container (synthetic RAW round-trips for tests/benchmarks) and 16-bit
binary PGM (a common intermediate for sensor dumps). Raster formats decode
through PIL.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from .raw import CFA, Orientation, RawImage
from .sources import ImageSource

__all__ = ["decode_file", "register_raw_decoder", "save_synraw", "load_synraw"]

_RAW_DECODERS: list[Callable[[str], Optional[RawImage]]] = []


def register_raw_decoder(fn: Callable[[str], Optional[RawImage]]) -> None:
    """Register a camera-RAW decoder: fn(path) -> RawImage or None."""
    _RAW_DECODERS.append(fn)


def save_synraw(path: str, raw: RawImage) -> None:
    """Persist a RawImage to the .synraw.npz container."""
    np.savez_compressed(
        path,
        data=raw.data,
        width=raw.width, height=raw.height, cpp=raw.cpp,
        crops=np.asarray(raw.crops, np.int64),
        blacklevels=np.asarray(raw.blacklevels, np.int64),
        whitelevels=np.asarray(raw.whitelevels, np.int64),
        wb_coeffs=np.asarray(raw.wb_coeffs, np.float32),
        xyz_to_cam=raw.xyz_to_cam,
        orientation=raw.orientation.value,
        cfa=raw.cfa.name,
        make=raw.make, model=raw.model,
    )


def load_synraw(path: str) -> RawImage:
    z = np.load(path, allow_pickle=False)
    return RawImage(
        width=int(z["width"]), height=int(z["height"]), cpp=int(z["cpp"]),
        crops=tuple(int(v) for v in z["crops"]),
        blacklevels=tuple(int(v) for v in z["blacklevels"]),
        whitelevels=tuple(int(v) for v in z["whitelevels"]),
        wb_coeffs=tuple(float(v) for v in z["wb_coeffs"]),
        xyz_to_cam=z["xyz_to_cam"],
        orientation=Orientation(str(z["orientation"])),
        cfa=CFA(str(z["cfa"])),
        data=z["data"],
        make=str(z["make"]), model=str(z["model"]),
    )


def _decode_synraw(path: str) -> Optional[RawImage]:
    if path.endswith(".synraw.npz") or path.endswith(".synraw"):
        return load_synraw(path)
    return None


def _decode_pgm16(path: str) -> Optional[RawImage]:
    """16-bit binary PGM (P5) as a Bayer RGGB sensor dump with full-range
    levels -- handy for interchange with dcraw -D -4 output."""
    if not path.lower().endswith(".pgm"):
        return None
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P5":
            return None
        vals = []
        while len(vals) < 3:
            line = f.readline()
            if not line:
                raise ValueError("truncated PGM header")
            if line.startswith(b"#"):
                continue
            vals.extend(int(t) for t in line.split())
        width, height, maxval = vals[:3]
        count = width * height
        dtype = np.dtype(">u2") if maxval > 255 else np.uint8
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        data = data.astype(np.uint16).reshape(height, width)
    return RawImage(
        width=width, height=height, cpp=1,
        crops=(0, 0, 0, 0),
        blacklevels=(0, 0, 0, 0),
        whitelevels=(maxval,) * 4,
        wb_coeffs=(float("nan"),) * 4,
        xyz_to_cam=np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                             [0.0, 0.0, 1.0], [0.0, 0.0, 0.0]], np.float32),
        orientation=Orientation.Normal,
        cfa=CFA("RGGB"),
        data=data,
    )


def _decode_dng(path: str) -> Optional[RawImage]:
    if not path.lower().endswith((".dng", ".tif", ".tiff")):
        return None
    from .dng import read_dng

    return read_dng(path)


def _decode_nef(path: str) -> Optional[RawImage]:
    if not path.lower().endswith((".nef", ".nrw")):
        return None
    from .vendor import read_nef

    return read_nef(path)


def _decode_cr2(path: str) -> Optional[RawImage]:
    if not path.lower().endswith(".cr2"):
        return None
    from .vendor import read_cr2

    return read_cr2(path)


def _decode_arw(path: str) -> Optional[RawImage]:
    if not path.lower().endswith((".arw", ".sr2")):
        return None
    from .vendor import read_arw

    return read_arw(path)


def _decode_raf(path: str) -> Optional[RawImage]:
    if not path.lower().endswith(".raf"):
        return None
    from .raf import read_raf

    return read_raf(path)


def _decode_orf(path: str) -> Optional[RawImage]:
    if not path.lower().endswith(".orf"):
        return None
    from .vendor import read_orf

    return read_orf(path)


def _decode_pef(path: str) -> Optional[RawImage]:
    if not path.lower().endswith(".pef"):
        return None
    from .vendor import read_pef

    return read_pef(path)


def _decode_rw2(path: str) -> Optional[RawImage]:
    # .rwl = Leica-branded Panasonic bodies (same magic-85 container);
    # non-Panasonic RWLs fail the tag check here and fall through to the
    # DNG/TIFF-EP route below.
    if not path.lower().endswith((".rw2", ".rwl")):
        return None
    from .rw2 import read_rw2

    return read_rw2(path)


def _decode_mrw(path: str) -> Optional[RawImage]:
    if not path.lower().endswith(".mrw"):
        return None
    from .mrw import read_mrw

    return read_mrw(path)


def _decode_srf(path: str) -> Optional[RawImage]:
    if not path.lower().endswith(".srf"):
        return None
    from .sony_srf import read_srf

    return read_srf(path)


def _decode_iiq(path: str) -> Optional[RawImage]:
    if not path.lower().endswith(".iiq"):
        return None
    from .iiq import read_iiq

    return read_iiq(path)


_TIFFEP_EXTS = (".erf", ".rwl", ".srw", ".mef", ".mos", ".kdc", ".dcr",
                ".3fr", ".fff")


def _decode_tiffep(path: str) -> Optional[RawImage]:
    """Generic TIFF-EP CFA fallback for TIFF-based raws without a
    dedicated decoder (uncompressed flavors decode; lossless-JPEG strips
    — compressed Mamiya MEF / Leaf MOS — decode through the lj92 codec;
    other vendor-compressed payloads fail with the gap named). Leica RWL
    files are often plain DNGs with a different extension, so try the
    DNG reader first."""
    low = path.lower()
    if not low.endswith(_TIFFEP_EXTS):
        return None
    from .vendor import read_tiffep

    if low.endswith(".rwl"):
        from .dng import read_dng

        try:
            return read_dng(path)
        except ValueError:
            pass
    return read_tiffep(path)


def _decode_known_unsupported(path: str) -> Optional[RawImage]:
    """Recognize RAW containers whose codecs are not implemented and name
    the gap, instead of letting them fall through to a baffling PIL
    'cannot identify image' error."""
    low = path.lower()
    if low.endswith(".cr3"):
        with open(path, "rb") as f:
            head = f.read(16)
        if head[4:8] == b"ftyp" and head[8:12] in (b"crx ", b"crx\0"):
            raise ValueError(
                "CR3: Canon's crx codec is not supported; convert to DNG "
                "or shoot CR2/DNG")
    elif low.endswith(".crw"):
        with open(path, "rb") as f:
            head = f.read(16)
        if head[6:14] == b"HEAPCCDR":
            raise ValueError(
                "CRW: Canon's CIFF container (pre-2004 bodies) is not "
                "supported; convert to DNG")
    return None


def _decode_x3f(path: str) -> Optional[RawImage]:
    with open(path, "rb") as f:
        head = f.read(4)
    if head != b"FOVb":
        return None
    from .x3f import read_x3f

    return read_x3f(path)


_RAW_DECODERS.extend([_decode_synraw, _decode_pgm16, _decode_dng,
                      _decode_nef, _decode_cr2, _decode_arw, _decode_raf,
                      _decode_orf, _decode_pef, _decode_rw2, _decode_mrw,
                      _decode_iiq, _decode_srf, _decode_x3f,
                      _decode_tiffep, _decode_known_unsupported])


def decode_file(path) -> ImageSource:
    """RAW decoders in registration order, then PIL raster fallback
    (matches pipeline.rs:262-272 behavior). Decoder failures are isolated
    (a broken decoder never takes down the chain) but collected, so when
    nothing can decode the file the error names WHY each candidate passed
    (e.g. 'NEF lossless-compressed (34713) not yet supported')."""
    path = os.fspath(path)
    failures: list[str] = []
    for dec in _RAW_DECODERS:
        try:
            raw = dec(path)
        except FileNotFoundError:
            raise
        except Exception as e:
            failures.append(f"{getattr(dec, '__name__', dec)}: {e}")
            raw = None
        if raw is not None:
            return ImageSource.from_raw(raw)
    try:
        from PIL import Image

        img = Image.open(path)
        img.load()
        return ImageSource.from_raster(img)
    except FileNotFoundError:
        raise
    except Exception as e:
        detail = ("; ".join(failures)) if failures else ""
        raise ValueError(
            f"imagepipe: Don't know how to decode image {path!r}"
            + (f" ({detail})" if detail else "")) from e


def codec_family(path) -> str:
    """Best-effort codec-family label for a RAW file WITHOUT decoding
    pixels -- the audit axis of the real-file harness: a run over a
    directory of real camera files reports which decoder families were
    actually exercised (tests/test_realfiles.py prints the table, and
    docs/MIGRATION.md documents the one-command audit). Unknown or
    unparseable files label "unknown"."""
    import struct

    path = os.fspath(path)
    low = path.lower()
    try:
        with open(path, "rb") as f:
            head = f.read(0x80)
        if head[:2] == b"P5":
            return "pgm"
        if low.endswith(".synraw.npz"):
            return "synraw"
        if head[:16] == b"FUJIFILMCCD-RAW ":
            return _raf_family(path)
        if head[:4] == b"\x00MRM":
            return "mrw"
        if head[4:8] == b"ftyp" and head[8:11] == b"crx":
            return "cr3-crx-unsupported"
        if head[6:14] == b"HEAPCCDR":
            return "crw-ciff-unsupported"
        if head[:4] == b"FOVb":
            from .x3f import parse_x3f

            with open(path, "rb") as f:
                x = parse_x3f(f.read())
            fmt = x.raw_section().format
            return ("x3f-huffman" if fmt == 6
                    else f"x3f-fmt{fmt}-unsupported")
        if head[:4] in (b"IIII", b"MMMM"):
            from .iiq import _parse_entries

            with open(path, "rb") as f:
                _en, tags = _parse_entries(f.read(), 8)
            fmt = int(tags[0x10E][2]) if 0x10E in tags else 0
            return f"iiq-fmt{fmt}" if fmt >= 3 else "iiq-uncompressed"
        from .tiff import TiffFile

        with open(path, "rb") as f:
            buf = f.read()
        ext = os.path.splitext(low)[1]
        if ext == ".rw2" or (ext == ".rwl" and buf[2:3] == b"\x55"):
            tf = TiffFile(buf, magics=(42, 85))
            ifd = tf.ifds[0]
            rf = int(ifd.get1(0x002D, 0) or 0)
            w = int(ifd.get1(0x0002, 0) or 0)
            h = int(ifd.get1(0x0003, 0) or 0)
            counts = ifd.get(0x0117) or []
            extent = sum(int(c) for c in counts) if counts else 0
            if extent == w * h * 2 and extent:
                return "rw2-uncompressed"
            if rf >= 8:
                return f"rw2-v{rf}-unsupported"
            if rf == 6 and int(ifd.get1(0x000A, 14) or 14) == 12:
                return "rw2-v6-12bit"  # separately-recalled page layout
            if rf >= 5:
                return f"rw2-v{rf}"
            return "rw2-classic"
        if ext in (".nef", ".nrw"):
            from .vendor import _nikon_makernote_tiff, _raw_cfa_ifd

            tf = TiffFile(buf)
            comp = int(_raw_cfa_ifd(tf).get1(259, 1) or 1)
            if comp != 34713:
                return f"nef-comp{comp}"
            mn = _nikon_makernote_tiff(tf)
            meta = mn.find_raw_bytes(0x0096) if mn is not None else b""
            if meta and len(meta) >= 2:
                v0, v1 = meta[0], meta[1]
                if v0 == 0x46:
                    return "nef-34713-lossless"
                if v0 == 0x44 and v1 == 0x40:
                    return "nef-34713-lossy2"
                if v0 == 0x44:
                    return "nef-34713-lossy"
                return f"nef-34713-{v0:02x}{v1:02x}"
            return "nef-34713"
        if ext == ".orf":
            from .vendor import _raw_cfa_ifd

            tf = TiffFile(buf, magics=(42, 0x4F52, 0x5352))
            ifd = _raw_cfa_ifd(tf)
            w = int(ifd.get1(256, 0) or 0)
            h = int(ifd.get1(257, 0) or 0)
            counts = ifd.get(279) or []
            extent = sum(int(c) for c in counts)
            if extent >= w * h * 2 > 0:
                return "orf-16bit"
            if extent == w * h * 3 // 2:
                return "orf-12bit-packed"
            return "orf-compressed"
        if ext == ".pef":
            from .vendor import _raw_cfa_ifd

            tf = TiffFile(buf)
            comp = int(_raw_cfa_ifd(tf).get1(259, 1) or 1)
            return "pef-compressed" if comp == 65535 else f"pef-comp{comp}"
        if ext == ".dng":
            tf = TiffFile(buf)
            # Same IFD pick as read_dng: CFA photometric preferred, else
            # the largest raster IFD (LinearRaw DNGs have no CFA IFD).
            cands = [e for e in tf.ifds if e.get1(262) == 32803]
            if not cands:
                cands = [e for e in tf.ifds
                         if e.get1(256) and (e.get(273) or e.get(324))]
            if not cands:
                return "unknown"
            ifd = max(cands, key=lambda e: (e.get1(256, 0) or 0)
                      * (e.get1(257, 0) or 0))
            comp = int(ifd.get1(259, 1) or 1)
            fmt = int(ifd.get1(339, 1) or 1)   # SampleFormat 3 = float
            base = {1: "dng-uncompressed", 7: "dng-lj92", 8: "dng-deflate",
                    34892: "dng-lossy-jpeg"}.get(comp, f"dng-comp{comp}")
            spp = int(ifd.get1(277, 1) or 1)   # 3 = LinearRaw/demosaiced
            return (base + ("-float" if fmt == 3 else "")
                    + ("-linear" if spp == 3 else ""))
        if ext == ".cr2":
            tf = TiffFile(buf)
            raw_ifds = [e for e in tf.ifds
                        if e.get1(259) == 6 and e.get(273)]
            if raw_ifds:
                off = int(raw_ifds[-1].get(273)[0])
                try:
                    from .lj92 import sof_ncomp

                    if sof_ncomp(bytes(buf[off:off + 4096])) == 3:
                        return "cr2-sraw"
                except ValueError:
                    pass
            return "cr2-lj92"
        if ext in (".arw", ".sr2"):
            try:
                from .vendor import _make_model, _raw_cfa_ifd

                tf = TiffFile(buf)
                ifd = _raw_cfa_ifd(tf)
                cnt = int((ifd.get(279) or [0])[0])
                extent = 2 * int(ifd.get1(256, 0)) * int(ifd.get1(257, 0))
                if (_make_model(tf)[1].strip().upper() == "DSLR-A100"
                        and int(ifd.get1(259, 1) or 1) == 1
                        and 0 < cnt < extent):
                    return "arw-v1"
            except Exception:
                pass
            return "arw"
        if ext == ".srf":
            return "srf"
        if ext in _TIFFEP_EXTS:
            if ext in (".3fr", ".fff"):
                try:
                    from .vendor import _raw_cfa_ifd

                    tf = TiffFile(buf)
                    if int(_raw_cfa_ifd(tf).get1(259, 1) or 1) == 7:
                        return "3fr-compressed"
                except Exception:
                    pass
            if ext == ".srw":
                try:
                    from .vendor import _raw_cfa_ifd

                    tf = TiffFile(buf)
                    if int(_raw_cfa_ifd(tf).get1(259, 1) or 1) == 32772:
                        return "srw-32772"
                except Exception:
                    pass
            if ext in (".mef", ".mos"):
                try:
                    from .vendor import _raw_cfa_ifd

                    tf = TiffFile(buf)
                    if int(_raw_cfa_ifd(tf).get1(259, 1) or 1) == 7:
                        return f"{ext[1:]}-lj92"
                except Exception:
                    pass
            if ext in (".kdc", ".dcr"):
                try:
                    from .vendor import _raw_cfa_ifd

                    tf = TiffFile(buf)
                    comp = int(_raw_cfa_ifd(tf).get1(259, 1) or 1)
                    if comp == 65000:
                        return f"{ext[1:]}-65000"
                    if comp in (65001, 65002):
                        return f"{ext[1:]}-{comp}-unsupported"
                except Exception:
                    pass
            return f"tiffep-{ext[1:]}"
        return "unknown"
    except Exception:
        return "unknown"


def _raf_family(path: str) -> str:
    import struct

    with open(path, "rb") as f:
        buf = f.read()
    (_jo, _jl, meta_off, meta_len, cfa_off, _cl) = struct.unpack_from(
        ">IIIIII", buf, 0x54)
    if buf[cfa_off:cfa_off + 4] in (b"II*\0", b"MM\0*"):
        # TIFF-wrapped: fuji-compressed payloads start with the 0x4953
        # stream signature inside the FujiIFD strip; sniff loosely.
        sub = buf[cfa_off:cfa_off + (1 << 20)]
        if b"\x49\x53" in sub[:64] or _raf_fujic_strip(buf, cfa_off):
            return "raf-fujic"
        return "raf-tiff-16bit"
    recs = {}
    try:
        (count,) = struct.unpack_from(">I", buf, meta_off)
        p = meta_off + 4
        for _ in range(min(count, 4096)):
            tag, size = struct.unpack_from(">HH", buf, p)
            p += 4
            recs[tag] = buf[p:p + size]
            p += size
    except Exception:
        pass
    lay = recs.get(0x0130, b"")
    if len(lay) >= 2 and not (lay[1] & 8):
        return "raf-superccd"
    if 0x0131 in recs:
        return "raf-classic-xtrans"
    return "raf-classic-bayer"


def _raf_fujic_strip(buf: bytes, cfa_off: int) -> bool:
    """True when the embedded FujiIFD's first strip bears the fuji
    lossless-compressed stream signature."""
    try:
        from .tiff import TiffFile

        tf = TiffFile(bytes(buf[cfa_off:]))
        offs = tf.find(0xF007)
        if not offs:
            return False
        o = int(offs[0])
        return buf[cfa_off + o:cfa_off + o + 2] == b"\x49\x53"
    except Exception:
        return False
