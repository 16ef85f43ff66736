"""The rotated resample kernel: CUDA C++ for Hopper, and its plain version.

Counterpart of `imagepipe_tpu/kernels/rotate_pallas.py`.
`rotate_resample_planar(src, width, height, topleft, topright, bottomleft,
nwidth, nheight, components)` resamples a planar float32 [C, H, W] source
through the affine geometry given by the source images of the output's
top-left, top-right and bottom-left pixels into [C, nh, nw]: the rotated
branch of the resampler behind rotatecrop (scaling.rs:51-130), in one
launch of csrc/rotate.cu, which replaces the Pallas `_rotate_kernel`.

* A source on the CPU goes to the plain version, `rotate_resample_plain`
  (scaling._transform_rotated, the JAX package's `_transform_impl` as an
  eager windowed gather). A source on a CUDA device launches the kernel, or
  the wrapper raises; nothing falls back.
* The kernel takes every geometry, C <= 8. Its geometry is
  `scaling.rotated_geometry`: 6 row terms per output row and 6 column terms
  per output column, plus the skips and the window bounds K_x, K_y of
  `_transform_impl`. `rotate_tile_plan` picks one of the kernel's two
  routes: *staged* (a block stages its tile's source box in shared memory
  and walks only each pixel's valid window), with the band tables that
  bound each tile's box, or *direct* (a thread per pixel reads its whole
  window from device memory) for a geometry whose tables hold a non-finite
  value or whose staged block would exceed `STAGE_SMEM_BYTES` (a deep
  rotated downscale). All tables go to the card in one pinned, non-blocking
  copy.
* `rotate_resample_cfa(src, ..., cfa)` is the CFA-aware form: one sensor
  plane [1, H, W] in, four colour planes [4, nh, nw] out, each sample
  counted in its colour of the CFA's pattern tile. It is the CFA mode of
  the JAX package's `scaling._transform_impl` (an XLA gather there), and
  launches csrc/rotate.cu's CFA route in one of two forms, chosen by
  `rotate_tile_plan(g, 1, H, W, cfa=True)`: staged (the staged route's
  machinery on one plane, in tiles of CFA_TILE_COLS columns, each
  sample's colour from the pattern tile in shared memory at a phase taken
  from the box origin) or direct (`rotate_kernel_cfa`, a thread per pixel
  walking its full window from device memory) for non-finite tables or a
  box too large. On the direct form a pixel whose window centre is NaN
  (every pixel of an output 1 wide or high) writes zeros without a walk,
  its bits whatever the source holds (csrc/rotate.cu's header gives the
  argument). Its plain version is `rotate_resample_cfa_plain`. The CPU and
  other devices are routed as above; `cfa_launch` is the launch itself,
  for a given plan.
* `LAUNCHES` counts the kernel's launches, `DIRECT_LAUNCHES` those on the
  direct route, `CFA_LAUNCHES` the CFA route's and `CFA_DIRECT_LAUNCHES`
  those of its direct form. The library is built by kernels/library.py,
  with every other kernel; this module declares the signatures of its
  entry points.

Numerics: every operation of the kernel is an explicit round-to-nearest
intrinsic in the plain version's order, so the two agree bit for bit
(chip_smoke.py holds them within MAX_ABS_DIFF and to the same NaN and zero
pattern). The staged route's shorter walk adds only the +-0 products the
full walk adds outside each window, which leave a sum unchanged; csrc/
rotate.cu's header gives the argument.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import cache

import numpy as np
import torch

from ..raw import PATTERN_TILE
from ..scaling import RotatedGeometry, _transform_rotated, rotated_geometry, sat_floor_np
from . import library

__all__ = ["rotate_resample_planar", "rotate_resample_plain", "rotate_resample_cfa",
           "rotate_resample_cfa_plain", "rotate_tile_plan", "tile_boxes", "RotateTilePlan",
           "check_source", "LAUNCHES", "DIRECT_LAUNCHES", "CFA_LAUNCHES", "CFA_DIRECT_LAUNCHES",
           "MAX_COMPONENTS", "MAX_ABS_DIFF", "TILE_W", "TILE_H", "CFA_TILE_COLS", "CFA_ROUTES",
           "STAGE_SMEM_BYTES"]

# Kernel launches by `rotate_resample_planar` since import (or since a caller
# reset it to 0), and those of them on the direct route; launches of the CFA
# route by `rotate_resample_cfa`, and those of them in its direct form.
LAUNCHES = 0
DIRECT_LAUNCHES = 0
CFA_LAUNCHES = 0
CFA_DIRECT_LAUNCHES = 0

# Largest channel count the kernel takes (the Pallas kernel's limit).
MAX_COMPONENTS = 8

# Largest |kernel - plain version| accepted on the card (the JAX package's
# own Pallas-vs-gather tolerance, tests/test_rotate_pallas.py); 0 expected.
MAX_ABS_DIFF = 2e-6

# The staged route's output tile: TILE_W columns (one warp) by TILE_H rows
# (a multiple of the block's 8 warps).
TILE_W = 32
TILE_H = 32
# The CFA route's staged tile: CFA_TILE_COLS output columns (csrc/rotate.cu
# kTileCols<true>; a warp walks each group of TILE_W) by TILE_H rows.
# Wider than TILE_W, fewer of the output's 32-byte sectors are written in
# two parts by two blocks (PERF.md).
CFA_TILE_COLS = 3 * TILE_W
# `cfa_launch`'s route codes: a plan's route, and "stores", the staged
# form's stores alone (every output written as zeros, nothing staged or
# walked), a probe that only scripts/time_develop_kernels.py launches.
CFA_ROUTES = {"direct": 0, "staged": 1, "stores": 2}
# Most shared memory a staged block may use: all a Hopper block can have.
STAGE_SMEM_BYTES = library.MAX_SMEM


@cache
def _lib() -> ctypes.CDLL:
    """The kernels' library with csrc/rotate.cu's entry points declared."""
    lib = library.load()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rotate_resample_launch.restype = i
    lib.rotate_resample_launch.argtypes = [p, i, i, i, p, p, i, i, f, f, i, i, i, p, p, i,
                                           i, i, p, p]
    lib.rotate_cfa_launch.restype = i
    lib.rotate_cfa_launch.argtypes = [p, i, i, p, p, i, i, f, f, i, i, p, i, i, p, p, i,
                                      i, i, p, p]
    return lib


@dataclass(frozen=True)
class RotateTilePlan:
    """The kernel's route and, on the staged route, its tiles.

    row_bands [8, nrb] float32: per band of `tile_h` output rows, the min
    of rows[0..3] of rotated_geometry, then their max; col_bands [8, ncb]
    the same over cols[0..3] per band of TILE_W output columns (CFA route:
    CFA_TILE_COLS) (None where a table holds a non-finite value). box_bound (height, width): a bound
    on every tile's box; box_floats: one box buffer, its C planes with 6
    columns more (the 16-byte copies widen a box to multiples of 4 floats
    from a multiple of 4), rounded up to 4 floats. smem_bytes: a staged
    block's shared memory, two buffers, each of a tile's row and column
    terms (6 x (tile_h + tile columns)) and a box, and on the CFA route the
    pattern tile."""
    route: str                       # "staged" or "direct"
    reason: str
    tile_h: int
    row_bands: np.ndarray | None
    col_bands: np.ndarray | None
    box_bound: tuple[int, int]
    box_floats: int
    smem_bytes: int


def _bands(terms: np.ndarray, size: int) -> np.ndarray:
    """[8, nb] float32: min then max of each of the 4 rows of `terms` [4, n]
    over consecutive bands of `size` entries (the last band may be short)."""
    starts = np.arange(0, terms.shape[1], size)
    return np.concatenate([np.minimum.reduceat(terms, starts, axis=1),
                           np.maximum.reduceat(terms, starts, axis=1)]).astype(np.float32)


def _extent_bound(row_bands, col_bands, i, k, size) -> int:
    """A bound on a tile's box extent along the axis of term `i` (0: y,
    2: x): greatest from - least from <= ceil(span + eps), span the largest
    spread of the row term over a row band plus that of the column term
    over a column band, eps both float32 roundings of the kernel's adds
    (the floors add < 1, saturation only shrinks it), plus the window's K."""
    r = row_bands[[i, i + 4]].astype(np.float64)
    c = col_bands[[i, i + 4]].astype(np.float64)
    span = float((r[1] - r[0]).max() + (c[1] - c[0]).max())
    eps = (float(np.abs(r).max()) + float(np.abs(c).max())) * 2.0 ** -23
    return min(size, math.ceil(span + eps) + k)


def rotate_tile_plan(g: RotatedGeometry, components: int, height: int, width: int,
                     tile_h: int | None = None, cfa: bool = False) -> RotateTilePlan:
    """The route of csrc/rotate.cu for geometry `g` on a [components, height,
    width] source, and the staged route's band tables and shared memory
    (see RotateTilePlan); `cfa`: the CFA route's (components 1). The tile is
    the tallest of `tile_h` (TILE_H by default), its half, ... down to 8
    rows whose block fits STAGE_SMEM_BYTES. Its cost is linear in the
    output's height and width."""
    tile_h = TILE_H if tile_h is None else int(tile_h)
    if tile_h <= 0 or tile_h % 8:
        raise ValueError(f"rotate tile plan: tile height {tile_h}, want a multiple of 8")
    if not (np.isfinite(g.rows).all() and np.isfinite(g.cols).all()):
        return RotateTilePlan("direct", "a geometry table holds a non-finite value", tile_h,
                              None, None, (0, 0), 0, 0)
    tile_cols = CFA_TILE_COLS if cfa else TILE_W
    col_bands = _bands(g.cols[:4], tile_cols)
    while True:
        row_bands = _bands(g.rows[:4], tile_h)
        box = (_extent_bound(row_bands, col_bands, 0, g.k_y, height),
               _extent_bound(row_bands, col_bands, 2, g.k_x, width))
        box_floats = -(-components * box[0] * (box[1] + 6) // 4) * 4
        smem = 4 * 2 * (6 * (tile_h + tile_cols) + box_floats)
        if cfa:
            smem += PATTERN_TILE * PATTERN_TILE
        if smem <= STAGE_SMEM_BYTES or tile_h % 16:
            break
        tile_h //= 2
    if smem > STAGE_SMEM_BYTES:
        route, reason = "direct", f"staged block needs {smem} B, over {STAGE_SMEM_BYTES}"
    else:
        route, reason = "staged", "finite tables, every box fits"
    return RotateTilePlan(route, reason, tile_h, row_bands, col_bands, box, box_floats, smem)


def tile_boxes(plan: RotateTilePlan, g: RotatedGeometry, height: int,
               width: int) -> tuple[np.ndarray, np.ndarray]:
    """(boxes [4, nrb, ncb] int64: y0, y1, x0, x1 of each tile's source box,
    inclusive; empty [nrb, ncb] bool): what the kernel derives from the band
    tables, one float32 add of a row and a column band term, floor and
    saturation each. A box runs from the least `from` to min(greatest
    `from` + K - 1, H - 1 or W - 1); a tile is empty where the greatest
    `to` is below the least `from` on an axis."""
    rb, cb = plan.row_bands, plan.col_bands

    def idx(i, maxv):
        with np.errstate(over="ignore"):
            s = rb[i][:, None] + cb[i][None, :]
        return sat_floor_np(s, maxv)

    y0, fy_hi, ty_hi = idx(0, height - 1), idx(4, height - 1), idx(5, height - 1)
    x0, fx_hi, tx_hi = idx(2, width - 1), idx(6, width - 1), idx(7, width - 1)
    boxes = np.stack([y0, np.minimum(fy_hi + g.k_y - 1, height - 1),
                      x0, np.minimum(fx_hi + g.k_x - 1, width - 1)])
    return boxes, (ty_hi < y0) | (tx_hi < x0)


def check_source(src: torch.Tensor, width: int, height: int, nwidth: int,
                 nheight: int, components: int) -> None:
    """Raise unless `src` is what the kernel takes: a contiguous float32
    [components, height, width] tensor, 1 <= components <= MAX_COMPONENTS,
    and an output of at least 1x1."""
    if src.dtype != torch.float32:
        raise TypeError(f"rotate kernel: source dtype {src.dtype}, want float32")
    if not 1 <= components <= MAX_COMPONENTS:
        raise ValueError(f"rotate kernel: {components} components, want 1..{MAX_COMPONENTS}")
    if tuple(src.shape) != (components, height, width) or not src.is_contiguous():
        raise ValueError(f"rotate kernel: source must be a contiguous [{components}, {height}, "
                         f"{width}] tensor, got {tuple(src.shape)}")
    if nwidth < 1 or nheight < 1:
        raise ValueError(f"rotate kernel: output {nwidth}x{nheight}")


def rotate_resample_plain(src: torch.Tensor, width, height, topleft, topright,
                          bottomleft, nwidth, nheight, components) -> torch.Tensor:
    """The kernel's computation in plain PyTorch, on the source's device."""
    return _transform_rotated(src, width, height, topleft, topright, bottomleft,
                              nwidth, nheight, components)


def rotate_resample_planar(src: torch.Tensor, width, height, topleft, topright,
                           bottomleft, nwidth, nheight, components) -> torch.Tensor:
    """Rotated resample of a planar [C, H, W] float32 source, C =
    components -> [C, nheight, nwidth] float32 on the source's device."""
    width, height, nwidth, nheight, components = (
        int(v) for v in (width, height, nwidth, nheight, components))
    check_source(src, width, height, nwidth, nheight, components)
    if src.device.type == "cpu":
        return rotate_resample_plain(src, width, height, topleft, topright, bottomleft,
                                     nwidth, nheight, components)
    if src.device.type != "cuda":
        raise ValueError(f"rotate kernel: unsupported device {src.device}")
    g = rotated_geometry(width, height, topleft, topright, bottomleft, nwidth, nheight)
    plan = rotate_tile_plan(g, components, height, width)
    staged = plan.route == "staged"
    parts = [g.rows.ravel(), g.cols.ravel()]
    if staged:
        parts += [plan.row_bands.ravel(), plan.col_bands.ravel()]
    tables = library.upload(np.concatenate(parts), src.device)
    offsets = np.cumsum([0] + [p.size for p in parts]) * 4 + tables.data_ptr()
    out = torch.empty((components, nheight, nwidth), dtype=torch.float32, device=src.device)
    lib = _lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    vec4 = width % 4 == 0 and src.data_ptr() % 16 == 0
    with torch.cuda.device(src.device):
        rc = lib.rotate_resample_launch(
            src.data_ptr(), components, height, width, int(offsets[0]), int(offsets[1]),
            nheight, nwidth, float(g.sxx), float(g.syy), g.k_x, g.k_y, int(staged),
            int(offsets[2]) if staged else None, int(offsets[3]) if staged else None,
            plan.tile_h, plan.box_floats if staged else 0, int(vec4), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rotate kernel launch failed: cudaError {rc}")
    global LAUNCHES, DIRECT_LAUNCHES
    LAUNCHES += 1
    DIRECT_LAUNCHES += not staged
    return out


def rotate_resample_cfa_plain(src: torch.Tensor, width, height, topleft, topright,
                              bottomleft, nwidth, nheight, cfa) -> torch.Tensor:
    """The CFA route's computation in plain PyTorch, on the source's device."""
    return _transform_rotated(src, width, height, topleft, topright, bottomleft,
                              nwidth, nheight, 4, cfa)


def rotate_resample_cfa(src: torch.Tensor, width, height, topleft, topright,
                        bottomleft, nwidth, nheight, cfa) -> torch.Tensor:
    """CFA-aware rotated resample of one sensor plane [1, H, W] float32 ->
    [4, nheight, nwidth] float32 (one plane per CFA colour) on the source's
    device."""
    width, height, nwidth, nheight = (int(v) for v in (width, height, nwidth, nheight))
    check_source(src, width, height, nwidth, nheight, 1)
    if cfa is None or not cfa.is_valid():
        raise ValueError(f"rotate kernel, CFA route: invalid CFA {cfa!r}")
    if src.device.type == "cpu":
        return rotate_resample_cfa_plain(src, width, height, topleft, topright, bottomleft,
                                         nwidth, nheight, cfa)
    if src.device.type != "cuda":
        raise ValueError(f"rotate kernel: unsupported device {src.device}")
    g = rotated_geometry(width, height, topleft, topright, bottomleft, nwidth, nheight)
    return cfa_launch(src, g, rotate_tile_plan(g, 1, height, width, cfa=True), cfa)


def cfa_launch(src: torch.Tensor, g: RotatedGeometry, plan: RotateTilePlan, cfa) -> torch.Tensor:
    """One launch of the CFA route on the CUDA plane `src` [1, H, W] with
    geometry `g`, in the form `plan.route` names (a route of CFA_ROUTES;
    the plan of `rotate_tile_plan(g, 1, H, W, cfa=True)`).
    `rotate_resample_cfa` is the entry point."""
    _, height, width = src.shape
    nheight, nwidth = g.rows.shape[1], g.cols.shape[1]
    route = CFA_ROUTES[plan.route]
    staged = route != 0
    tile = np.ascontiguousarray(cfa.pattern_tile(), dtype=np.uint8)     # [48, 48]
    parts = [g.rows.ravel(), g.cols.ravel()]
    if staged:
        parts += [plan.row_bands.ravel(), plan.col_bands.ravel()]
    floats = np.concatenate(parts)
    tables = library.upload(np.concatenate([floats.view(np.uint8), tile.ravel()]), src.device)
    offsets = np.cumsum([0] + [p.size for p in parts]) * 4 + tables.data_ptr()
    out = torch.empty((4, nheight, nwidth), dtype=torch.float32, device=src.device)
    lib = _lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    vec4 = width % 4 == 0 and src.data_ptr() % 16 == 0
    with torch.cuda.device(src.device):
        rc = lib.rotate_cfa_launch(
            src.data_ptr(), height, width, int(offsets[0]), int(offsets[1]), nheight, nwidth,
            float(g.sxx), float(g.syy), g.k_x, g.k_y, int(offsets[-1]), tile.shape[0], route,
            int(offsets[2]) if staged else None, int(offsets[3]) if staged else None,
            plan.tile_h, plan.box_floats if staged else 0, int(vec4), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rotate kernel (CFA route) launch failed: cudaError {rc}")
    global CFA_LAUNCHES, CFA_DIRECT_LAUNCHES
    CFA_LAUNCHES += 1
    CFA_DIRECT_LAUNCHES += not staged
    return out
