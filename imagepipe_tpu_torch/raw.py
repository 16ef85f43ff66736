"""RAW image metadata model and synthetic RAW generation.

The reference consumes the external `rawloader` crate's data model
(SURVEY.md section 2.4; usage at the reference's src/ops/gofloat.rs:24-31,
colorspaces.rs:32-46, demosaic.rs:13, transform.rs:25-35). This module is the
host-side equivalent: the metadata tuple every op constructor reads, the CFA
pattern algebra, EXIF orientation flips, and the dcraw-style matrix
pseudo-inverse. Pixel data is a numpy array staged to the device by gofloat.

Real camera-file decoding plugs in behind `decode.py`; synthetic RAW
generation lives here so tests and benchmarks can exercise every CFA path
without camera files.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

__all__ = ["CFA", "Orientation", "RawImage", "synthetic_bayer", "synthetic_xtrans"]

_f32 = np.float32

# Color plane indices: R=0, G=1, B=2, E=3 (fourth/emerald channel).
_CFA_COLORS = {"R": 0, "G": 1, "B": 2, "E": 3}

# The reference's 48x48 expanded-pattern convention (demosaic.rs:77):
# 48 is a common multiple of every supported CFA period (2, 6, 8, 12).
PATTERN_TILE = 48


def _cfa_name(letters: str, height: int, width: int) -> str:
    """Canonical name: bare letters when dims are implied by length,
    otherwise an explicit "HxW:" prefix."""
    implied = {4: (2, 2), 16: (2, 8), 36: (6, 6), 144: (12, 12)}
    if implied.get(len(letters)) == (height, width):
        return letters
    return f"{height}x{width}:{letters}"


class CFA:
    """Color filter array pattern, mirroring rawloader's CFA.

    Constructed from a pattern string ("RGGB", 36-char X-Trans, ...).
    `color_at(row, col)` returns the plane index at a sensor position;
    `shift(x, y)` re-anchors the pattern after cropping.
    """

    def __init__(self, patname: str, height: int | None = None,
                 width: int | None = None):
        # Non-canonical dims ride inside the name as an "HxW:" prefix
        # ("2x4:RGBGBGRG" -- SuperCCD lattice patterns) so a CFA survives
        # the name-string round-trip through plan statics and hashing.
        if ":" in patname:
            dims, _, letters = patname.partition(":")
            ph, _, pw = dims.partition("x")
            height, width = int(ph), int(pw)
            patname = letters
        n = len(patname)
        if n == 0:
            self.name = ""
            self.width = 0
            self.height = 0
            self.pattern = np.zeros((0, 0), dtype=np.uint8)
            return
        if height is not None and width is not None:
            if height * width != n:
                raise ValueError(f"CFA dims {height}x{width} != pattern length {n}")
            w, h = width, height
        elif n == 4:
            w, h = 2, 2
        elif n == 16:
            w, h = 8, 2  # Canon Pro70-style 8x2 (demosaic.rs:36)
        elif n == 36:
            w, h = 6, 6  # X-Trans
        elif n == 144:
            w, h = 12, 12
        else:
            raise ValueError(f"unsupported CFA pattern length {n}: {patname!r}")
        self.width = w
        self.height = h
        self.name = _cfa_name(patname, h, w)
        pat = np.zeros((h, w), dtype=np.uint8)
        for i, ch in enumerate(patname):
            pat[i // w, i % w] = _CFA_COLORS[ch]
        self.pattern = pat

    def is_valid(self) -> bool:
        return self.width > 0

    def color_at(self, row: int, col: int) -> int:
        return int(self.pattern[row % self.height, col % self.width])

    def pattern_tile(self, tile: int = PATTERN_TILE) -> np.ndarray:
        """The pattern expanded to a [tile, tile] uint8 grid (tile is a
        multiple of every supported period)."""
        reps = (tile // self.height + 1, tile // self.width + 1)
        return np.tile(self.pattern, reps)[:tile, :tile]

    def shift(self, x: int, y: int) -> "CFA":
        """Pattern as seen from origin offset (x right, y down)."""
        if not self.is_valid():
            return CFA("")
        out = CFA.__new__(CFA)
        out.width = self.width
        out.height = self.height
        out.pattern = np.roll(self.pattern, shift=(-y % self.height, -x % self.width), axis=(0, 1))
        inv = {v: k for k, v in _CFA_COLORS.items()}
        letters = "".join(inv[int(c)] for c in out.pattern.ravel())
        out.name = _cfa_name(letters, out.height, out.width)
        return out

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"CFA({self.name!r})"


class Orientation(enum.Enum):
    """EXIF orientation, with the (transpose, flip_x, flip_y) decomposition
    used by the output transform op (rawloader's Orientation::to_flips;
    consumed at the reference's src/ops/transform.rs:25-35,57-66)."""

    Normal = "Normal"
    HorizontalFlip = "HorizontalFlip"
    Rotate180 = "Rotate180"
    VerticalFlip = "VerticalFlip"
    Transpose = "Transpose"
    Rotate90 = "Rotate90"
    Transverse = "Transverse"
    Rotate270 = "Rotate270"
    Unknown = "Unknown"

    def to_flips(self) -> tuple[bool, bool, bool]:
        return _ORIENT_TO_FLIPS[self]

    @staticmethod
    def from_flips(flips: tuple[bool, bool, bool]) -> "Orientation":
        return _FLIPS_TO_ORIENT[flips]


_ORIENT_TO_FLIPS = {
    Orientation.Normal: (False, False, False),
    Orientation.Unknown: (False, False, False),
    Orientation.VerticalFlip: (False, False, True),
    Orientation.HorizontalFlip: (False, True, False),
    Orientation.Rotate180: (False, True, True),
    Orientation.Transpose: (True, False, False),
    Orientation.Rotate90: (True, False, True),
    Orientation.Transverse: (True, True, True),
    Orientation.Rotate270: (True, True, False),
}
_FLIPS_TO_ORIENT = {
    (False, False, False): Orientation.Normal,
    (False, False, True): Orientation.VerticalFlip,
    (False, True, False): Orientation.HorizontalFlip,
    (False, True, True): Orientation.Rotate180,
    (True, False, False): Orientation.Transpose,
    (True, False, True): Orientation.Rotate90,
    (True, True, True): Orientation.Transverse,
    (True, True, False): Orientation.Rotate270,
}


def _pseudoinverse(inm: np.ndarray) -> np.ndarray:
    """dcraw-lineage 4x3 -> 3x4 pseudo-inverse in float32 (the algorithm
    rawloader uses to derive cam_to_xyz from xyz_to_cam)."""
    inm = inm.astype(_f32)
    temp = np.zeros((3, 6), dtype=_f32)
    for i in range(3):
        temp[i, i + 3] = _f32(1.0)
        for j in range(3):
            for k in range(4):
                temp[i, j] += inm[k, i] * inm[k, j]
    for i in range(3):
        num = temp[i, i].copy()
        temp[i, :] /= num
        for k in range(3):
            if k == i:
                continue
            num = temp[k, i].copy()
            temp[k, :] -= temp[i, :] * num
    out = np.zeros((3, 4), dtype=_f32)
    for i in range(4):
        for j in range(3):
            out[j, i] = np.dot(temp[j, 3:6], inm[i, :3]).astype(_f32)
    return out


@dataclasses.dataclass
class RawImage:
    """The camera-RAW metadata + pixel payload the pipeline ops consume.

    Field-for-field mirror of the rawloader::RawImage surface the reference
    uses (SURVEY.md section 2.4): sensor dims, components-per-pixel, crop
    rectangle [top, right, bottom, left], per-channel black/white levels,
    as-shot white balance, the camera's xyz_to_cam matrix, EXIF orientation,
    CFA, and the sensor data (u16 "Integer" or f32 "Float" variants).
    """

    width: int
    height: int
    cpp: int
    crops: tuple[int, int, int, int]
    blacklevels: tuple[int, int, int, int]
    whitelevels: tuple[int, int, int, int]
    wb_coeffs: tuple[float, float, float, float]
    xyz_to_cam: np.ndarray  # [4,3] f32
    orientation: Orientation
    cfa: CFA
    data: np.ndarray  # [height, width*cpp] flat or [height, width, cpp]; u16 or f32
    make: str = ""
    model: str = ""

    def __post_init__(self):
        self.xyz_to_cam = np.asarray(self.xyz_to_cam, dtype=_f32).reshape(4, 3)

    def cam_to_xyz(self) -> np.ndarray:
        """[3,4] camera->XYZ matrix (pseudo-inverse of xyz_to_cam)."""
        return _pseudoinverse(self.xyz_to_cam)

    def cam_to_xyz_normalized(self) -> np.ndarray:
        """cam_to_xyz with xyz_to_cam rows first normalized to sum 1 so a
        white-balanced neutral maps to the white point."""
        m = self.xyz_to_cam.astype(_f32).copy()
        for i in range(4):
            num = _f32(m[i, 0] + m[i, 1] + m[i, 2])
            if num != 0.0:
                m[i, :] = m[i, :] / num
            else:
                m[i, :] = 0.0
        return _pseudoinverse(m)

    def neutralwb(self) -> tuple[float, float, float, float]:
        """Fallback white balance for files without as-shot WB: multipliers
        that neutralize D65 through the camera matrix (same construction as
        OpToLab::set_temp, the reference's src/ops/colorspaces.rs:59-70)."""
        from .cct import temp_to_xyz

        xyz = temp_to_xyz(6500.0)
        coeffs = []
        for i in range(4):
            acc = float(np.dot(self.xyz_to_cam[i].astype(np.float64), xyz.astype(np.float64)))
            coeffs.append(1.0 / acc if acc != 0.0 else 0.0)
        return tuple(coeffs)

    def cropped_cfa(self) -> CFA:
        """CFA re-anchored to the crop origin (crops are [top,right,bottom,left])."""
        return self.cfa.shift(self.crops[3], self.crops[0])


# ---------------------------------------------------------------------------
# Synthetic RAW generation (benchmark + test inputs; no camera files needed).
# ---------------------------------------------------------------------------

_SYNTH_XYZ_TO_CAM = np.array(
    # A plausible CMOS-ish camera matrix (loosely Sony-like), 4th row zero.
    [[0.7437, -0.2680, -0.0625],
     [-0.5723, 1.3982, 0.1916],
     [-0.1239, 0.2170, 0.6822],
     [0.0, 0.0, 0.0]],
    dtype=_f32,
)


def _mosaic(cfa: CFA, rgb: np.ndarray) -> np.ndarray:
    """Sample an RGB float image through a CFA -> single-plane sensor data."""
    h, w, _ = rgb.shape
    tile = cfa.pattern_tile()
    ys = np.arange(h) % PATTERN_TILE
    xs = np.arange(w) % PATTERN_TILE
    colors = tile[np.ix_(ys, xs)]
    plane = np.take_along_axis(rgb, np.minimum(colors, 2)[..., None].astype(np.int64), axis=-1)[..., 0]
    return plane


def _synthetic_raw(cfa_str: str, width: int, height: int, seed: int = 0,
                   blacklevel: int = 512, whitelevel: int = 16383) -> RawImage:
    cfa = CFA(cfa_str)
    rng = np.random.default_rng(seed)
    # Smooth scene: gradients plus low-frequency noise, in linear [0,1].
    yy, xx = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    base = np.stack([
        0.55 * xx + 0.15 * yy,
        0.35 + 0.3 * yy * xx,
        0.65 - 0.4 * xx,
    ], axis=-1)
    noise = rng.standard_normal((height // 16 + 1, width // 16 + 1, 3)) * 0.03
    noise = np.kron(noise, np.ones((16, 16, 1)))[:height, :width, :]
    rgb = np.clip(base + noise, 0.0, 1.0).astype(np.float32)
    plane = _mosaic(cfa, rgb)
    data = (plane * (whitelevel - blacklevel) + blacklevel).astype(np.uint16)
    return RawImage(
        width=width,
        height=height,
        cpp=1,
        crops=(0, 0, 0, 0),
        blacklevels=(blacklevel,) * 4,
        whitelevels=(whitelevel,) * 4,
        wb_coeffs=(2.1, 1.0, 1.45, float("nan")),
        xyz_to_cam=_SYNTH_XYZ_TO_CAM,
        orientation=Orientation.Normal,
        cfa=cfa,
        data=data,
        make="synthetic",
        model=f"synth-{cfa_str[:4].lower()}-{width}x{height}",
    )


def synthetic_bayer(width: int = 6000, height: int = 4000, seed: int = 0) -> RawImage:
    """A synthetic RGGB Bayer RAW (default 24MP, the benchmark config)."""
    return _synthetic_raw("RGGB", width, height, seed)


def synthetic_xtrans(width: int = 6240, height: int = 4168, seed: int = 0) -> RawImage:
    """A synthetic Fuji X-Trans RAW (6x6 CFA, default 26MP)."""
    pattern = ("GBGGRG" "RGRBGB" "GBGGRG" "GRGGBG" "BGBRGR" "GRGGBG")
    return _synthetic_raw(pattern, width, height, seed)


def synthetic_mono(width: int = 6000, height: int = 4000, seed: int = 0,
                   blacklevel: int = 512, whitelevel: int = 16383) -> RawImage:
    """A synthetic monochrome RAW (no CFA -- Leica Monochrom-style
    sensors; the develop chain's 'mono' mode)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, height),
                         np.linspace(0, 1, width), indexing="ij")
    base = 0.5 * xx + 0.3 * yy
    noise = rng.standard_normal((height // 16 + 1, width // 16 + 1)) * 0.03
    noise = np.kron(noise, np.ones((16, 16)))[:height, :width]
    plane = np.clip(base + noise, 0.0, 1.0).astype(np.float32)
    data = (plane * (whitelevel - blacklevel) + blacklevel).astype(np.uint16)
    return RawImage(
        width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=(blacklevel,) * 4, whitelevels=(whitelevel,) * 4,
        wb_coeffs=(1.0, 1.0, 1.0, float("nan")),
        xyz_to_cam=_SYNTH_XYZ_TO_CAM, orientation=Orientation.Normal,
        cfa=CFA(""), data=data, make="synthetic",
        model=f"synth-mono-{width}x{height}")


def synthetic_linear(width: int = 6000, height: int = 4000, seed: int = 0,
                     blacklevel: int = 0, whitelevel: int = 65535) -> RawImage:
    """A synthetic demosaiced (cpp=3) RAW — the LinearRaw DNG shape
    (Lightroom linear exports, HDR merges). Data is the flat [H, W*3]
    interleaved layout RawImage permits; develops through the engine's
    rgb mode (no demosaic), like rawloader's 3-component raws feed the
    reference's gofloat.rs:101-127."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, height),
                         np.linspace(0, 1, width), indexing="ij")
    base = np.stack([0.25 + 0.5 * xx, 0.3 + 0.4 * yy,
                     0.65 - 0.4 * xx], axis=-1)
    noise = rng.standard_normal((height // 16 + 1, width // 16 + 1, 3)) * 0.03
    noise = np.kron(noise, np.ones((16, 16, 1)))[:height, :width, :]
    rgb = np.clip(base + noise, 0.0, 1.0).astype(np.float32)
    data = (rgb * (whitelevel - blacklevel) + blacklevel).astype(np.uint16)
    return RawImage(
        width=width, height=height, cpp=3, crops=(0, 0, 0, 0),
        blacklevels=(blacklevel,) * 3 + (0,),
        whitelevels=(whitelevel,) * 4,
        wb_coeffs=(1.8, 1.0, 1.3, float("nan")),
        xyz_to_cam=_SYNTH_XYZ_TO_CAM, orientation=Orientation.Normal,
        cfa=CFA(""), data=data.reshape(height, width * 3),
        make="synthetic", model=f"synth-linear-{width}x{height}")
