"""The thumbnail develop kernel: CUDA C++ for Hopper, and its plain version.

Counterpart of `imagepipe_tpu/kernels/develop_scaled.py`. `develop_scaled(
plan, plane)` develops a 'scaled' plan (a cfa plan whose maxwidth /
maxheight asks for at least the CFA's minimum downscale) in one kernel
launch: the CFA-aware paraboloid-weighted downscale fused with the develop
back end (csrc/develop_scaled.cu, which replaces the Pallas
`_scaled_kernel` and `_scaled_kernel_chunked`). No full-resolution
intermediate exists. EXIF flips run afterwards as torch ops.
`develop_scaled_batch(plans, planes)` develops B planes of one shape class
in one launch of the same kernel (the image is blockIdx.z): the geometry
is shared, the calibration each image's own. It replaces
`_develop_scaled_batchgrid_jit` and the loop `_develop_scaled_batch_jit`;
`develop_scaled` is its B = 1 case.

* Planes on the CPU go to the plain versions, `develop_scaled_plain` and
  `develop_scaled_batch_plain`: the eager engine's 'scaled' path (crop ->
  levels -> scaling.scale_down_planar with the CFA -> finish_planes) in
  'direct' numerics. Planes on a CUDA device launch the kernel, or the
  wrapper raises; nothing falls back.
* The kernel takes every window size: the Pallas envelope (window <= 16,
  chunked <= 40) was VMEM's.
* Its geometry is a few KB of separable host tables (`scaled_geometry`):
  window bounds per output row and column and the squared distances dy^2
  per (ky, row) and dx^2 per (kx, col), float32 as the reference rounds
  them. They replace the Pallas kernel's ~H*W*5 bytes of per-offset
  weight, colour and count tables.
* Its launch plan (`scaled_plan`) splits each output pixel's window across
  `window_split` lanes of one warp where windows are large, and fixes the
  block's tile of output pixels; both follow from the geometry alone.
* `scaled_plan_for(plan)` records the two as one `ScaledPlan` (None
  where the JAX package's is None), which `develop_scaled(plan, plane,
  sp)` accepts and checks against the plan, as the JAX signature has it;
  planning it fills the plan's memos, so the launch plans nothing anew. The JAX
  package's `stage_scaled_np` and `staged_scaled_cached` pad planes for
  the TPU's tiles; this kernel reads the uncropped plane, so they have no
  counterpart (`imagepipe_tpu_torch._surface.NOT_PORTED`).
* `LAUNCHES` counts the launches of `develop_scaled` and `BATCH_LAUNCHES`
  those of `develop_scaled_batch`; `develop_scaled(..., stage_limit=k)`
  with a cut k of 1..3 (the JAX function's profiling knob: the back end
  stopped after the demosaic, Lab or the spline, `engine.finish_planes`)
  counts in `CUT_LAUNCHES[k]` instead. The library is built by
  kernels/library.py, with every other kernel; this module declares the
  signature of its entry point.

Numerics: with one lane per pixel the RGBE sums equal the plain version's
term for term (same order, rounded products and adds); split across lanes
they are added in a fixed tree, so batched and single launches agree bit
for bit. The back end's FMA contractions leave the cross-path contract of
kernels/develop.py: max |diff| <= 1 LSB on fewer than 2% of values.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import cache

import numpy as np
import torch

from ..raw import CFA
from ..engine import _develop_one, check_stage_limit
from ..ops.transform import apply_flips
from ..scaling import aligned_axes
from . import develop as kdev
from . import library

__all__ = ["develop_scaled", "develop_scaled_plain", "develop_scaled_batch",
           "develop_scaled_batch_plain", "scaled_supported", "scaled_geometry",
           "ScaledLaunchPlan", "window_split", "scaled_smem_bytes", "scaled_plan",
           "ScaledPlan", "scaled_plan_for",
           "LAUNCHES", "BATCH_LAUNCHES", "CUT_LAUNCHES", "THREADS"]

# Kernel launches by `develop_scaled` and by `develop_scaled_batch` since
# import (or since a caller reset them to 0).
LAUNCHES = 0
BATCH_LAUNCHES = 0
# Launches of `develop_scaled` cut at stage_limit 1, 2 and 3, by cut.
CUT_LAUNCHES = {1: 0, 2: 0, 3: 0}

_f32 = np.float32

# Threads per block of csrc/develop_scaled.cu.
THREADS = 256


@cache
def _lib() -> ctypes.CDLL:
    """The kernels' library with csrc/develop_scaled.cu's entry point
    declared."""
    lib = library.load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.develop_scaled_batch_launch.restype = i
    lib.develop_scaled_batch_launch.argtypes = [p, i, i, ll, ll, i, i, i, i,
                                                p, p, p, p, p, p, i, p, p, i, i,
                                                p, i, i, i, i, i, i, i, i, p, p]
    return lib


def scaled_supported(plan) -> bool:
    """cfa plans on the 'scaled' path with an output of at least 2x2 and a
    CFA period the kernel takes (kernels/develop.py MAX_PATTERN)."""
    if plan.mode != "cfa" or plan.dem_path != "scaled":
        return False
    if plan.dem_h <= 1 or plan.dem_w <= 1:
        return False
    cfa = CFA(plan.cfa_name)
    return cfa.is_valid() and max(cfa.height, cfa.width) <= kdev.MAX_PATTERN


def _host_geometry(plan) -> dict:
    """scaled_geometry's tables as host arrays, memoized on the plan."""
    hit = getattr(plan, "_scaled_host_geometry", None)
    if hit is not None:
        return hit
    H, W = plan.height, plan.width
    g = aligned_axes(W, H, (0, 0), (W - 1, 0), (0, H - 1), plan.dem_w, plan.dem_h)
    x = np.minimum(g.from_x[None, :] + np.arange(g.k_x)[:, None], W - 1)
    y = np.minimum(g.from_y[None, :] + np.arange(g.k_y)[:, None], H - 1)
    dx = (x.astype(_f32) - g.cx[None, :]) / g.sxx
    dy = (y.astype(_f32) - g.cy[None, :]) / g.syy
    plan._scaled_host_geometry = dict(from_x=g.from_x, to_x=g.to_x, from_y=g.from_y,
                                      to_y=g.to_y, dx2=(dx * dx).astype(_f32),
                                      dy2=(dy * dy).astype(_f32))
    return plan._scaled_host_geometry


def scaled_geometry(plan, device="cpu") -> dict:
    """{from_x, to_x [nw], from_y, to_y [nh] int32; dx2 [K_x, nw], dy2
    [K_y, nh] float32}: the separable host tables of the plan's downscale,
    computed as the JAX package's `_transform_aligned_impl` computes them
    (:229-242), as tensors on `device`. Memoized on the plan: repeated
    develops of one plan build and upload them once."""
    device = torch.device(device)
    hit = getattr(plan, "_scaled_geometry", None)
    if hit is not None and hit[0] == device:
        return hit[1]
    tables = {k: library.upload(v, device) for k, v in _host_geometry(plan).items()}
    plan._scaled_geometry = (device, tables)
    return tables


@dataclass(frozen=True)
class ScaledLaunchPlan:
    """How csrc/develop_scaled.cu covers a geometry: sx lanes of one warp per
    output pixel, a block of THREADS threads develops tc x tr output pixels,
    kx window columns, smem bytes of shared memory per block."""
    sx: int
    tc: int
    tr: int
    kx: int
    smem: int


def window_split(k_x: int) -> int:
    """Lanes of one warp that share an output pixel's window of at most k_x
    columns, each taking every sx-th column of each window row: the largest
    power of two up to 32 that leaves each lane at least 4 columns. One lane
    below 8 columns (-> 1024 and -> 2048 at 24 MP: the sums keep the plain
    version's order); 8 at 24 MP -> 160 (39 columns), where 16 and 32 lanes
    ran slower on the card (PERF.md)."""
    sx = 1
    while sx < 32 and 2 * sx * 4 <= k_x:
        sx *= 2
    return sx


def scaled_smem_bytes(tc: int, tr: int, kx: int, ph: int, pw: int, spline_stride: int) -> int:
    """Dynamic shared memory of one scaled-kernel block (csrc/develop_scaled.cu
    `layout`): calibration, per-pixel RGBE, 1 - dx^2 of the tile's columns,
    the CFA pattern."""
    a16 = lambda n: (n + 15) & ~15
    return (4 * (128 + 5 * spline_stride) + 16 * tc * tr + a16(4 * (kx | 1) * tc)
            + a16(ph * pw))


def scaled_plan(plan, spline_stride: int) -> ScaledLaunchPlan:
    """The launch plan of the plan's geometry (memoized on the plan): the
    window split, then a tile of THREADS / sx output pixels, up to 32
    columns wide. Raises if a block needs more than MAX_SMEM of shared
    memory (windows some 1,700 columns wide)."""
    hit = getattr(plan, "_scaled_launch_plan", None)
    if hit is not None and hit[0] == spline_stride:
        return hit[1]
    kx = _host_geometry(plan)["dx2"].shape[0]
    sx = window_split(kx)
    ph, pw = kdev._pattern(plan).shape
    outs = THREADS // sx
    tc = min(32, outs)
    smem = scaled_smem_bytes(tc, outs // tc, kx, ph, pw, spline_stride)
    if smem > library.MAX_SMEM:
        raise ValueError(f"develop_scaled kernel: windows of {kx} columns need {smem} B of "
                         f"shared memory per block, more than {library.MAX_SMEM}")
    launch = ScaledLaunchPlan(sx, tc, outs // tc, kx, smem)
    plan._scaled_launch_plan = (spline_stride, launch)
    return launch


@dataclass(frozen=True)
class ScaledPlan:
    """The host plan of one 'scaled' shape class (height, width, dem_h,
    dem_w, cfa_name): its downscale geometry (`scaled_geometry`'s tables,
    on the host) and the kernel's launch plan over it (`scaled_plan`), for
    plans with a spline table `spline_stride` columns wide. A record: the
    launch reads the plan's own memoized geometry and launch plan, which
    are these."""
    key: tuple
    geometry: dict
    launch: ScaledLaunchPlan
    spline_stride: int

    def check(self, plan) -> None:
        """Raise unless this plan's shape class and spline table are the
        plan's."""
        want = (_shape_class(plan), kdev.spline_stride(plan))
        if (self.key, self.spline_stride) != want:
            raise ValueError(f"develop_scaled kernel: ScaledPlan of {self.key} (spline "
                             f"stride {self.spline_stride}) for a plan of {want[0]} "
                             f"(spline stride {want[1]})")


def _shape_class(plan) -> tuple:
    return (plan.height, plan.width, plan.dem_h, plan.dem_w, plan.cfa_name)


def scaled_plan_for(plan) -> ScaledPlan | None:
    """The ScaledPlan of a 'scaled' cfa plan, or None where the JAX package
    returns None for its kernel: not 'cfa', not 'scaled', or an output 1
    wide or high. The JAX package also returns None for windows outside
    its kernel's VMEM envelope; this kernel takes every window that fits
    its shared memory (`scaled_plan` raises beyond that)."""
    if plan.mode != "cfa" or plan.dem_path != "scaled":
        return None
    if plan.dem_h <= 1 or plan.dem_w <= 1:
        return None
    stride = kdev.spline_stride(plan)
    return ScaledPlan(_shape_class(plan), _host_geometry(plan), scaled_plan(plan, stride),
                      stride)


def develop_scaled_plain(plan, plane: torch.Tensor, stage_limit: int = 4) -> torch.Tensor:
    """The kernel's computation in plain PyTorch, on the plane's device."""
    return _develop_one(plan, plane, "direct", stage_limit)


def develop_scaled_batch_plain(plans, planes: torch.Tensor) -> torch.Tensor:
    """`develop_scaled_batch` in plain PyTorch: a loop of
    `develop_scaled_plain`."""
    return torch.stack([develop_scaled_plain(p, planes[i]) for i, p in enumerate(plans)])


def _check_kernel(plan, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"develop_scaled kernel: unsupported device {device}")
    if not scaled_supported(plan):
        raise ValueError(f"develop_scaled kernel: unsupported plan (mode {plan.mode!r}, "
                         f"dem_path {plan.dem_path!r}, {plan.dem_w}x{plan.dem_h}, "
                         f"cfa {plan.cfa_name!r})")


def _launch(plan, planes: torch.Tensor, scal, spline, pattern, phases, n_knots,
            stage_limit: int = 4) -> torch.Tensor:
    """One launch over planes [B, H0, W0] -> unflipped [B, 3, dem_h, dem_w],
    the back end cut at `stage_limit`."""
    g = scaled_geometry(plan, planes.device)
    lp = scaled_plan(plan, spline.shape[-1])
    out = kdev._out(plan, planes.shape[0], plan.dem_h, plan.dem_w, planes.device)
    lib = _lib()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        rc = lib.develop_scaled_batch_launch(
            planes.data_ptr(), kdev._element(planes), planes.shape[0], planes.stride(0),
            planes.stride(1), plan.crop_x, plan.crop_y, plan.dem_h, plan.dem_w,
            g["from_x"].data_ptr(), g["to_x"].data_ptr(),
            g["from_y"].data_ptr(), g["to_y"].data_ptr(),
            g["dx2"].data_ptr(), g["dy2"].data_ptr(), lp.kx,
            scal.data_ptr(), spline.data_ptr(), spline.shape[-1], n_knots,
            pattern.data_ptr(), pattern.shape[0], pattern.shape[1],
            lp.sx, lp.tc, lp.tr,
            int(plan.linear), plan.out_bits, stage_limit, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"develop_scaled kernel launch failed: cudaError {rc}")
    return out


def develop_scaled(plan, plane: torch.Tensor, sp: ScaledPlan | None = None,
                   stage_limit: int = 4) -> torch.Tensor:
    """Develop the uncropped sensor plane [H0, W0] (u16 or f32) of a
    'scaled' cfa plan -> quantized planar [3, dem_h, dem_w] u8/u16, flipped
    to the plan's orientation; with stage_limit 1..3 the back end cut there.
    `sp`, the shape class's `scaled_plan_for`, is checked against the plan;
    the launch reads the plan's own memoized geometry, which `sp` records."""
    stage_limit = check_stage_limit(stage_limit)
    if sp is not None:
        sp.check(plan)
    if plane.device.type == "cpu":
        return develop_scaled_plain(plan, plane, stage_limit)
    _check_kernel(plan, plane.device)
    kdev.check_plane(plan, plane, "develop_scaled kernel")
    out = _launch(plan, plane[None], *kdev._device_tables(plan, plane.device),
                  stage_limit=stage_limit)
    global LAUNCHES
    if stage_limit == 4:
        LAUNCHES += 1
    else:
        CUT_LAUNCHES[stage_limit] += 1
    return apply_flips(out[0], plan.orientation_flips)


def develop_scaled_batch(plans, planes: torch.Tensor) -> torch.Tensor:
    """Develop B uncropped sensor planes [B, H0, W0] (u16 or f32) of one
    'scaled' shape class, plans[i] calibrating planes[i], in one launch ->
    quantized planar [B, 3, dem_h, dem_w] u8/u16, flipped."""
    if planes.device.type == "cpu":
        return develop_scaled_batch_plain(plans, planes)
    kdev.check_batch(plans, planes, "develop_scaled kernel")
    _check_kernel(plans[0], planes.device)
    out = _launch(plans[0], planes, *kdev.batch_tables(plans, planes.device))
    global BATCH_LAUNCHES
    BATCH_LAUNCHES += 1
    return apply_flips(out, plans[0].orientation_flips)
