"""The develop kernel's ablation ladder: CUDA C++ for Hopper, and its plain version.

Counterpart of the TPU experiments `scripts/exp_kernel_variants.py` and
`scripts/exp_kernel_variants3.py`, whose `make_kernel` builds a Pallas
kernel that keeps a longer prefix of the develop kernel's work with each
variant. `run_variant(plane, scal, height=, width=, variant=, form=,
out_dtype=)` runs one rung in one launch of csrc/develop_variants.cu and
returns its three planes [3, height, width]:

* `noop`: the stores only. Form A (`exp_kernel_variants.py`) writes 1, 2, 3
  times (black > 0); form B (`exp_kernel_variants3.py`) writes zeros;
* `dma_floor`: the tile's load, then the stores. Form A writes 1, 2, 3 times
  c, where c says whether the TPU tile (`tile`, (tile_h, tile_w)) that holds
  the pixel has a sample > 0 among the first 128 of its first row; form B
  reads every sample and writes zeros;
* `levels`: v = min((raw - black) / range, 1), quantized, in all three planes;
* `demosaic`: the closed-form RGGB 3x3 demosaic of the levels, quantized;
* `color_only`: the colour back end (WB, camera matrix, Lab, Lab^-1 with no
  tone curve, XYZ->RGB, sRGB gamma) on the centre sample;
* `full`: the demosaic, then the back end.

Form A writes u8 only, as does `demosaic`; form B writes u8 or float32. The
quantize truncates, clip(v * 256, 0, 255), as the experiments do (not the
develop kernel's rounding). The plane is the uncropped sensor plane
[height, width], u16 or float32, RGGB from its origin; `scal` [8, 16] holds
the calibration as the experiments pack it (`variant_scal`).

* A plane on the CPU goes to the plain version, `variant_plain`: the
  experiment's kernel written op by op in PyTorch (the zero padding, the
  validity mask, the 0/1 colour masks), dividing by 0-d tensors on the
  plane's device so that CUDA divides and does not multiply by a
  reciprocal. A plane on a CUDA device launches the kernel, or the wrapper
  raises; nothing falls back.
* `VARIANT_LAUNCHES` counts the launches by form: "A" and "B";
  `ROUTE_LAUNCHES` the launches that load the plane by their load route.
  The library is built by kernels/library.py, with every other kernel;
  this module declares the signature of its entry point.
* `variant_plan` is the launch's plan, chosen from the shape before it: a
  block a tile of 128 columns x `tile_rows` rows (`TILE_ROWS`, or
  `STREAM_TILE_ROWS` for the rungs that only stream), a thread
  storing 16 bytes a plane at a time (16 u8 or 4 float32 pixels along a
  row); the plane's rows load by TMA where they start on 16 bytes (route
  "tma"), else by vector loads ("vector"). noop loads nothing and fills
  the output [3, height, width] as one flat array (route None).

Numerics: nvcc contracts a + b*c into FMA and the plain version does not,
so u8 outputs are held to the cross-path contract (max |diff| <= 1 LSB,
fewer than 2% of values differing) and float32 outputs to max |diff| <=
`MAX_F32_DIFF` on their 0-255 scale.
"""

from __future__ import annotations

import ctypes
from functools import cache

import numpy as np
import torch
import torch.nn.functional as F

from ..color import _div
from . import develop as kdev
from . import library

__all__ = ["run_variant", "variant_plain", "variant_scal", "check_variant", "compare_variant",
           "variant_route", "variant_plan", "VARIANTS", "FORMS", "ROUTES", "TILE_COLS",
           "TILE_ROWS", "STREAM_TILE_ROWS", "THREADS", "VARIANT_LAUNCHES", "ROUTE_LAUNCHES",
           "MAX_F32_DIFF"]

# The rungs, in the order the kernel numbers them.
VARIANTS = ("noop", "dma_floor", "levels", "demosaic", "color_only", "full")
FORMS = ("A", "B")

# Kernel launches by `run_variant` since import (or since a caller reset
# them), by form, and those that load the plane by load route.
VARIANT_LAUNCHES = {"A": 0, "B": 0}
ROUTES = ("tma", "vector")
ROUTE_LAUNCHES = {"tma": 0, "vector": 0}

# The launch plan: an output tile is TILE_COLS columns by `tile_rows` rows
# (at most 254: the TMA box holds the rows and a one-row halo above and
# below); at 32 rows a block's 256 threads store one 16-byte u8 vector each
# a plane, at 8 one float32 vector. The heights are the fastest of 8, 16, 32
# and 64 at 24 MP on the H100 (scripts/torch_kernel_variants.py
# --tile-rows): 32 by default; the rungs that only stream (dma_floor form
# B, levels) 16 to u8 and 8 to float32.
TILE_COLS = 128
TILE_ROWS = 32
STREAM_TILE_ROWS = {torch.uint8: 16, torch.float32: 8}
THREADS = 256                   # a block's threads: each stores one vector at a time
_MAX_TILE_ROWS = 254

# float32 outputs: the most |kernel - plain| may be, on the 0-255 scale.
MAX_F32_DIFF = 1e-3

# The experiments' constants (exp_kernel_variants.py:33-35), float32 values.
_LAB_E = float(np.float32(216.0) / np.float32(24389.0))
_LAB_K = float(np.float32(24389.0) / np.float32(27.0))
_LAB_KE = float(np.float32(_LAB_K) * np.float32(_LAB_E))
_XW, _YW, _ZW = 0.95047, 1.0, 1.08883


@cache
def _lib() -> ctypes.CDLL:
    """The kernels' library with csrc/develop_variants.cu's entry point
    declared."""
    lib = library.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.develop_variant_launch.restype = i
    lib.develop_variant_launch.argtypes = [p, i, i, i, p, i, i, i, i, i, p, i, i, p]
    return lib


def variant_scal(plan) -> np.ndarray:
    """The calibration [8, 16] float32 of a develop plan as the experiments
    pack it (exp_kernel_variants.py:237-242): [0, 0] black, [0, 1] range,
    [1, :4] WB, [2:5, :4] camera matrix, [5:8, :3] XYZ->RGB. The develop
    kernel's `scal` is the same table."""
    return kdev.calib_tables(plan)[0]


def check_variant(plane: torch.Tensor, scal: torch.Tensor, height: int, width: int,
                  variant: str, form: str, out_dtype, tile) -> None:
    """Raise unless the rung is one the kernels define: a contiguous
    [height, width] u16 or float32 plane, scal [8, 16] float32, a known
    variant and form, a u8 output for form A and for `demosaic` (u8 or
    float32 otherwise), and a tile (tile_h, tile_w) of positive ints for
    `dma_floor` form A only."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}, want one of {VARIANTS}")
    if form not in FORMS:
        raise ValueError(f"form {form!r}, want one of {FORMS}")
    if out_dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}, want torch.uint8 or torch.float32")
    if out_dtype != torch.uint8 and (form == "A" or variant == "demosaic"):
        raise ValueError(f"{variant} form {form} writes u8 only")
    needs_tile = variant == "dma_floor" and form == "A"
    if needs_tile != (tile is not None):
        raise ValueError("a tile (tile_h, tile_w) is given to dma_floor form A, and only to it")
    if needs_tile and (len(tile) != 2 or min(int(t) for t in tile) <= 0):
        raise ValueError(f"tile {tile}, want (tile_h, tile_w) > 0")
    if plane.dtype not in (torch.uint16, torch.float32):
        raise TypeError(f"plane dtype {plane.dtype}, want uint16 or float32")
    if tuple(plane.shape) != (height, width) or not plane.is_contiguous():
        raise ValueError(f"plane {tuple(plane.shape)}, want a contiguous [{height}, {width}]")
    if height <= 0 or width <= 0:
        raise ValueError(f"{height} x {width}: the plane is empty")
    if tuple(scal.shape) != (8, 16) or scal.dtype != torch.float32:
        raise ValueError(f"scal {tuple(scal.shape)} {scal.dtype}, want [8, 16] float32")


def variant_route(width: int, plane_dtype, data_ptr: int = 0) -> str:
    """The load route of a [., width] plane of `plane_dtype` (u16 or
    float32) whose data starts at `data_ptr`: "tma" where every row starts
    on 16 bytes (width * itemsize and the pointer multiples of 16), which
    the TMA tensor map needs, else "vector"."""
    return "tma" if (width * plane_dtype.itemsize) % 16 == 0 and data_ptr % 16 == 0 else "vector"


def variant_plan(height: int, width: int, variant: str, form: str, plane_dtype, out_dtype,
                 data_ptr: int = 0, tile_rows: int | None = None) -> dict:
    """The launch of one rung on a [height, width] plane: `route`
    (`variant_route`; None for noop), `tile_rows` (TILE_ROWS or
    STREAM_TILE_ROWS unless given), `tiles` (blocks along x and y), `vec`
    (pixels a thread stores per plane at a time: 16 bytes of the output
    type), `shape` (height, width). noop's tiles are 256 vectors of the
    flat output (tile_rows None)."""
    vec = 16 // out_dtype.itemsize
    if variant == "noop":
        return {"route": None, "tile_rows": None,
                "tiles": (-(-3 * height * width // (vec * THREADS)), 1), "vec": vec,
                "shape": (height, width)}
    if tile_rows is None:
        streams = variant == "levels" or (variant, form) == ("dma_floor", "B")
        tile_rows = STREAM_TILE_ROWS[out_dtype] if streams else TILE_ROWS
    rows = int(tile_rows)
    if not 1 <= rows <= _MAX_TILE_ROWS:
        raise ValueError(f"tile_rows {rows}, want 1..{_MAX_TILE_ROWS}")
    return {"route": variant_route(width, plane_dtype, data_ptr), "tile_rows": rows,
            "tiles": (-(-width // TILE_COLS), -(-height // rows)), "vec": vec,
            "shape": (height, width)}


def _scal(scal, device) -> torch.Tensor:
    """`scal` (an array or a tensor) as a contiguous float32 tensor on `device`."""
    if (torch.is_tensor(scal) and scal.device == device and scal.dtype == torch.float32
            and scal.is_contiguous()):
        return scal
    return library.upload(np.asarray(scal.cpu() if torch.is_tensor(scal) else scal, np.float32),
                          device)


def _quantize(o: torch.Tensor, out_dtype) -> torch.Tensor:
    q = torch.clamp(o * 256.0, 0.0, 255.0)
    return q.to(torch.int32).to(torch.uint8) if out_dtype == torch.uint8 else q


def _out(planes, out_dtype) -> torch.Tensor:
    return torch.stack([_quantize(o, out_dtype) for o in planes])


def _dma_flags(plane: torch.Tensor, height: int, width: int, tile) -> torch.Tensor:
    """dma_floor form A's c [height, width] float32: per TPU tile, whether
    one of the first 128 samples of its first row (as int32; past the width
    the padding's 0) is > 0."""
    th, tw = (int(t) for t in tile)
    rows = plane[::th].to(torch.int32)                      # each tile row's first row
    padded = F.pad(rows, (0, -(-width // tw) * tw + 128 - width))
    starts = torch.arange(0, width, tw, device=plane.device)
    window = padded[:, starts[:, None] + torch.arange(128, device=plane.device)]
    c = (window.max(dim=2).values > 0).to(torch.float32)    # [tile rows, tile cols]
    return c.repeat_interleave(th, 0)[:height].repeat_interleave(tw, 1)[:, :width]


def _backend(rgbe, scal: torch.Tensor):
    """The colour back end, op by op as exp_kernel_variants.py:151-190."""
    wb = [torch.minimum(rgbe[c] * scal[1, c], torch.ones((), device=scal.device))
          for c in range(4)]
    xyz = []
    for r in range(3):
        acc = wb[0] * scal[2 + r, 0]
        for c in range(1, 4):
            acc = acc + wb[c] * scal[2 + r, c]
        xyz.append(acc)

    def lab_f(t):
        cb = torch.exp(torch.log(torch.clamp(t, min=1e-30)) * (1.0 / 3.0))
        return torch.where(t > _LAB_E, cb, _div(_LAB_K * t + 16.0, 116.0))

    fx = lab_f(_div(xyz[0], _XW))
    fy = lab_f(_div(xyz[1], _YW))
    fz = lab_f(_div(xyz[2], _ZW))
    L = _div(116.0 * fy - 16.0, 100.0)
    A = _div(500.0 * (fx - fy) + 127.0, 255.0)
    B = _div(200.0 * (fy - fz) + 127.0, 255.0)

    cl = L * 100.0
    ca = A * 255.0 - 127.0
    cb2 = B * 255.0 - 127.0
    fy2 = _div(cl + 16.0, 116.0)
    fx2 = _div(ca, 500.0) + fy2
    fz2 = fy2 - _div(cb2, 200.0)
    fx3 = fx2 * fx2 * fx2
    fz3 = fz2 * fz2 * fz2
    xr = torch.where(fx3 > _LAB_E, fx3, _div(116.0 * fx2 - 16.0, _LAB_K))
    yr = torch.where(cl > _LAB_KE, fy2 * fy2 * fy2, _div(cl, _LAB_K))
    zr = torch.where(fz3 > _LAB_E, fz3, _div(116.0 * fz2 - 16.0, _LAB_K))
    x, y, z = xr * _XW, yr * _YW, zr * _ZW
    outs = []
    for r in range(3):
        ch = x * scal[5 + r, 0] + y * scal[5 + r, 1] + z * scal[5 + r, 2]
        ch = torch.clamp(ch, 0.0, 1.0)
        hi = 1.055 * torch.exp(torch.log(torch.clamp(ch, min=1e-30)) * (1.0 / 2.4)) - 0.055
        outs.append(torch.where(ch < 0.0031308, ch * 12.92, hi))
    return outs


def _demosaic(v: torch.Tensor, height: int, width: int):
    """RGBE of the closed-form RGGB demosaic (exp_kernel_variants.py:
    98-149) of the levels `v` [height + 2, width + 2] padded by one sample."""
    dev = v.device
    rows = torch.arange(-1, height + 1, device=dev)[:, None]
    cols = torch.arange(-1, width + 1, device=dev)[None, :]
    valid = ((rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)).to(torch.float32)
    vv = v * valid

    def sl(a, dy, dx):
        return a[1 + dy:1 + dy + height, 1 + dx:1 + dx + width]

    c_ctr = sl(v, 0, 0)
    e_sum = sl(vv, -1, 0) + sl(vv, 1, 0) + sl(vv, 0, -1) + sl(vv, 0, 1)
    e_cnt = sl(valid, -1, 0) + sl(valid, 1, 0) + sl(valid, 0, -1) + sl(valid, 0, 1)
    h_sum = sl(vv, 0, -1) + sl(vv, 0, 1)
    h_cnt = sl(valid, 0, -1) + sl(valid, 0, 1)
    v_sum = sl(vv, -1, 0) + sl(vv, 1, 0)
    v_cnt = sl(valid, -1, 0) + sl(valid, 1, 0)
    d_sum = sl(vv, -1, -1) + sl(vv, -1, 1) + sl(vv, 1, -1) + sl(vv, 1, 1)
    d_cnt = sl(valid, -1, -1) + sl(valid, -1, 1) + sl(valid, 1, -1) + sl(valid, 1, 1)

    def avg(s, c):
        return torch.where(c > 0.0, s / c, torch.zeros((), device=dev))

    pr0 = ((torch.arange(height, device=dev)[:, None] & 1) == 0).to(torch.float32)
    pc0 = ((torch.arange(width, device=dev)[None, :] & 1) == 0).to(torch.float32)
    is_r = pr0 * pc0
    is_b = (1.0 - pr0) * (1.0 - pc0)
    is_g = 1.0 - is_r - is_b
    g_h = pr0
    h_avg = avg(h_sum, h_cnt)
    v_avg = avg(v_sum, v_cnt)
    d_avg = avg(d_sum, d_cnt)
    r_at_g = g_h * h_avg + (1.0 - g_h) * v_avg
    b_at_g = g_h * v_avg + (1.0 - g_h) * h_avg
    return [is_r * c_ctr + is_g * r_at_g + is_b * d_avg,
            is_g * c_ctr + (is_r + is_b) * avg(e_sum, e_cnt),
            is_b * c_ctr + is_g * b_at_g + is_r * d_avg,
            c_ctr * 0.0]


def variant_plain(plane: torch.Tensor, scal, *, height: int, width: int, variant: str,
                  form: str, out_dtype=torch.uint8, tile=None) -> torch.Tensor:
    """The rung's computation in plain PyTorch, on the plane's device: the
    same [3, height, width] as `run_variant`."""
    scal = _scal(scal, plane.device)
    check_variant(plane, scal, height, width, variant, form, out_dtype, tile)
    dev = plane.device
    if variant in ("noop", "dma_floor") and form == "B":
        if variant == "dma_floor":
            z = plane.to(torch.int32) & 0
        else:
            z = torch.zeros((height, width), dtype=torch.int32, device=dev)
        return torch.stack([z.to(out_dtype)] * 3)
    if variant in ("noop", "dma_floor"):
        c = ((scal[0, 0] > 0).to(torch.float32) if variant == "noop"
             else _dma_flags(plane, height, width, tile))
        ones = torch.ones((height, width), device=dev)
        return torch.stack([(k * ones * c).to(torch.uint8) for k in (1, 2, 3)])

    p = plane if plane.dtype == torch.float32 else plane.to(torch.int32).to(torch.float32)
    p = F.pad(p, (1, 1, 1, 1))          # the experiments' zero padding, one sample deep
    v = torch.minimum((p - scal[0, 0]) / scal[0, 1], torch.ones((), device=dev))
    if variant == "levels":
        return _out([v[1:-1, 1:-1]] * 3, out_dtype)
    if variant == "color_only":
        c_ctr = v[1:-1, 1:-1]
        rgbe = [c_ctr, c_ctr, c_ctr, c_ctr * 0.0]
    else:
        rgbe = _demosaic(v, height, width)
    if variant == "demosaic":
        return _out(rgbe[:3], out_dtype)
    return _out(_backend(rgbe, scal), out_dtype)


def compare_variant(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |diff|, fraction of values differing) of two rungs' outputs on
    one device, on their 0-255 scale."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"{tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    d = (got.to(torch.float64) - want.to(torch.float64)).abs()
    return float(d.max()), float((d != 0).to(torch.float64).mean())


def run_variant(plane: torch.Tensor, scal, *, height: int, width: int, variant: str,
                form: str, out_dtype=torch.uint8, tile=None,
                tile_rows: int | None = None) -> torch.Tensor:
    """One rung of the ladder on the sensor plane [height, width] (u16 or
    float32) with the calibration `scal` [8, 16] -> [3, height, width] u8 or
    float32: one launch of csrc/develop_variants.cu on CUDA under
    `variant_plan` (`tile_rows` overrides its tile height), the plain
    version on the CPU."""
    if plane.device.type == "cpu":
        return variant_plain(plane, scal, height=height, width=width, variant=variant,
                             form=form, out_dtype=out_dtype, tile=tile)
    if plane.device.type != "cuda":
        raise ValueError(f"variant kernel: unsupported device {plane.device}")
    scal = _scal(scal, plane.device)
    check_variant(plane, scal, height, width, variant, form, out_dtype, tile)
    plan = variant_plan(height, width, variant, form, plane.dtype, out_dtype, plane.data_ptr(),
                        tile_rows)
    out = torch.empty((3, height, width), dtype=out_dtype, device=plane.device)
    tile_h, tile_w = (int(t) for t in tile) if tile is not None else (0, 0)
    lib = _lib()
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        rc = lib.develop_variant_launch(
            plane.data_ptr(), int(plane.dtype == torch.float32), height, width,
            scal.data_ptr(), VARIANTS.index(variant), int(form == "A"), tile_h,
            tile_w, int(out_dtype == torch.float32), out.data_ptr(), plan["tile_rows"] or 1,
            ROUTES.index(plan["route"] or "tma"), stream)
    if rc != 0:
        raise RuntimeError(f"variant kernel launch failed: cudaError {rc}")
    VARIANT_LAUNCHES[form] += 1
    if plan["route"] is not None:
        ROUTE_LAUNCHES[plan["route"]] += 1
    return out
