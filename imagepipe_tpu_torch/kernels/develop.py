"""The full-size develop kernel: CUDA C++ for Hopper, and its plain version.

Counterpart of `imagepipe_tpu/kernels/develop_pallas.py`. `develop(plan,
plane)` runs the whole develop of one sensor plane in one kernel launch
(csrc/develop.cu, which replaces the Pallas `_develop_kernel`) and returns
the quantized planar [3, H', W'] output, EXIF flips applied afterwards as
torch ops, like the JAX package applies them after its `pallas_call`.
`develop_batch(plans, planes)` develops B planes of one shape class, each
with its own calibration, in one launch of the same kernel (the image is
blockIdx.z), in place of `_develop_pallas_batchgrid_jit` and the loop
`_develop_pallas_batch_jit`; `develop` is its B = 1 case.
`develop_sp(plan, plane_shards, devices)` and `develop_sp_batch` develop an
image (a batch) width-sharded over several devices, one launch of the same
kernel per column shard at its global column offset, with a 1-column halo
exchange between the shards: the counterpart of `develop_pallas_sp` and of
`_sp_local_develop(_batch)`.

* Planes on the CPU go to the plain versions, `develop_plain`,
  `develop_batch_plain`, `develop_sp_plain` and `develop_sp_batch_plain`:
  the same develop written in plain PyTorch (crop -> levels -> stencil
  demosaic -> finish_planes in 'direct' numerics; the sharded ones develop
  each shard from its own columns, `engine.develop_shard`). Planes on a
  CUDA device launch the kernel, or the wrapper raises; nothing falls back.
* The kernel is built on first use, with every other kernel of `csrc/`, by
  kernels/library.py; this module declares the signatures of the entry
  points it calls. Importing it builds nothing.
* The width shards are cut, staged, their halos exchanged and their outputs
  assembled by the eager engine's plain code (`engine.sp_shards`,
  `stage_sp`, `exchange_halos`, `assemble`), which launches nothing; the
  EXIF flips are `ops.transform.apply_flips`.
* `LAUNCHES` counts the launches of `develop`, `BATCH_LAUNCHES` those of
  `develop_batch` and `SP_LAUNCHES` the shard launches of `develop_sp(_batch)`,
  so a run can show its main path went through the kernel.
  `develop(plan, plane, stage_limit)` with a cut 1..3 (the profiling knob
  of `_develop_pallas_jit(stage_limit=)`: the back end stopped after the
  demosaic, Lab or the spline, `engine.finish_planes`) counts in
  `CUT_LAUNCHES[stage_limit]` instead.
* Host tables reach the card from pinned memory without blocking the host
  (`library.upload`), so a caller can stage the next batch while this one
  runs. The kernel's demosaic reads a 16-byte table per CFA phase
  (`demosaic_phases`), uploaded once per CFA and device.
* `division_mismatches` runs csrc/division_check.cu, the card's proof that
  the kernels' reciprocal-multiply division equals the IEEE one.

Numerics: nvcc contracts a + b*c into FMA, as XLA does, and the plain
version's separate tensor ops do not. So kernel and plain version are held
to the cross-path contract of the JAX package (tests/test_pallas.py): max
|diff| <= 1 LSB and fewer than 2% of values differing.
"""

from __future__ import annotations

import ctypes
from functools import cache, lru_cache

import numpy as np
import torch

from ..raw import CFA
from ..engine import (_develop_one, _x_offsets, assemble, check_stage_limit, develop_shard,
                      exchange_halos)
from ..ops.transform import apply_flips
from . import library
from .demosaic_full import OFFSETS_3X3

__all__ = ["develop", "develop_plain", "develop_batch", "develop_batch_plain",
           "develop_sp", "develop_sp_plain", "develop_sp_batch", "develop_sp_batch_plain",
           "kernel_supported", "spline_stride", "calib_tables", "batch_tables", "demosaic_phases",
           "develop_smem_bytes", "division_mismatches", "check_plane", "check_batch", "compare",
           "LAUNCHES", "BATCH_LAUNCHES", "SP_LAUNCHES", "CUT_LAUNCHES", "MAX_PATTERN",
           "MAX_LSB", "MAX_FLIP_FRACTION"]

# Kernel launches by `develop`, by `develop_batch` and the shard launches of
# `develop_sp` and `develop_sp_batch` since import (or since a caller reset
# them to 0).
LAUNCHES = 0
BATCH_LAUNCHES = 0
SP_LAUNCHES = 0
# Launches of `develop` cut at stage_limit 1, 2 and 3, by cut.
CUT_LAUNCHES = {1: 0, 2: 0, 3: 0}

# The cross-path contract: quantized outputs differ by at most 1 LSB, on
# fewer than 2% of values.
MAX_LSB = 1
MAX_FLIP_FRACTION = 0.02

# Largest CFA period the kernel takes (the reference's 48x48 pattern tile).
MAX_PATTERN = 48

# csrc/develop.cu's tile: 128 x 8 output pixels, staged with a 1-pixel halo.
_TILE_W, _TILE_H = 128, 8


@cache
def _lib() -> ctypes.CDLL:
    """The kernels' library with the entry points this module calls
    declared: csrc/develop.cu's and csrc/division_check.cu's."""
    lib = library.load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.develop_batch_launch.restype = i
    lib.develop_batch_launch.argtypes = [p, i, i, ll, ll, i, i, i, i, i, i, p, p, i, i,
                                         p, i, i, i, i, i, i, p, p]
    lib.division_check_constants.restype = i
    lib.division_check_constants.argtypes = [p, p, p]
    lib.division_check_levels.restype = i
    lib.division_check_levels.argtypes = [p, i, i, p, p, p]
    lib.division_check_count.restype = i
    lib.division_check_count.argtypes = []
    return lib


def kernel_supported(plan) -> bool:
    """Full-size cfa and mono plans (mirrors `pallas_supported` of the JAX
    package for dem_path 'full'); rgb plans stay on the eager engine."""
    if plan.dem_path != "full":
        return False
    if plan.mode == "mono":
        return True
    if plan.mode != "cfa":
        return False
    cfa = CFA(plan.cfa_name)
    return cfa.is_valid() and max(cfa.height, cfa.width) <= MAX_PATTERN


def spline_stride(plan) -> int:
    """Columns of the plan's spline table (`calib_tables`): the knots
    rounded up to a multiple of 8, at least 16."""
    n_knots = plan.n_knots if plan.apply_curve else 0
    return max(16, -(-n_knots // 8) * 8)


def calib_tables(plan):
    """(scal [8,16], spline [5,>=16], n_knots) float32: the per-image
    calibration packed as the Pallas kernel receives it
    (develop_pallas.py:796-821)."""
    p = {k: v.cpu().numpy() for k, v in plan.params.items()}
    scal = np.zeros((8, 16), np.float32)
    scal[0, 0] = p["mins"][0]
    scal[0, 1] = p["ranges"][0]
    scal[1, :4] = p["mul"]
    scal[2:5, :4] = p["cmatrix"]
    scal[5:8, :3] = p["rgbmatrix"]

    n_knots = plan.n_knots if plan.apply_curve else 0
    spline = np.zeros((5, spline_stride(plan)), np.float32)
    if plan.apply_curve:
        spline[0, :n_knots] = p["spline_xs"]
        spline[1, :n_knots] = p["spline_ys"]
        spline[2, :n_knots] = p["spline_c1"]
        spline[3, :n_knots - 1] = p["spline_c2"]
        spline[4, :n_knots - 1] = p["spline_c3"]
    return scal, spline, n_knots


def _pattern(plan) -> np.ndarray:
    """The cropped CFA colours [ph, pw] u8 the kernels take (1x1 for mono)."""
    if plan.mode == "mono":
        return np.zeros((1, 1), np.uint8)
    return CFA(plan.cfa_name).pattern.astype(np.uint8)


@lru_cache(maxsize=64)
def _phases_cached(pattern_bytes: bytes, ph: int, pw: int) -> np.ndarray:
    pattern = np.frombuffer(pattern_bytes, np.uint8).reshape(ph, pw)
    py, px = np.divmod(np.arange(ph * pw), pw)
    centre = pattern[py, px]
    out = np.zeros((ph * pw, 16), np.uint8)
    for i, (dy, dx) in enumerate(OFFSETS_3X3):
        colour = pattern[(py + dy) % ph, (px + dx) % pw]
        # A neighbour of the centre's own colour is not summed: the centre
        # keeps its own sample (demosaic.rs:87).
        out[:, i] = np.where((colour == centre) & ((dy, dx) != (0, 0)), 4, colour)
    for c in range(4):
        out[:, 9 + c] = (out[:, :9] == c).sum(axis=1)
    if (ph, pw) == (2, 2):
        # Offsets 1/7 (column), 3/5 (row), 0/2/6/8 (cross) share a colour.
        col, row, cross = out[:, 1], out[:, 3], out[:, 0]
        plus = (row == col) & (row < 4) & (cross < 4) & (cross != row)
        pairs = (cross == 4) & (row < 4) & (col < 4) & (row != col)
        out[:, 13] = np.where(plus | pairs, row, 0)
        out[:, 14] = np.where(plus, cross, np.where(pairs, col, 0))
        out[:, 15] = np.where(plus, 1, np.where(pairs, 2, 0))
    return out


def demosaic_phases(pattern: np.ndarray) -> np.ndarray:
    """[ph * pw, 16] u8, the develop kernel's table per phase (py, px) of the
    cropped CFA `pattern` [ph, pw]: bytes 0..8 the colour of each 3x3 offset
    in the reference's order (OFFSETS_3X3), 4 where it is not summed (a
    neighbour of the centre's own colour); bytes 9..12 the number of offsets
    of each colour, which is the neighbour count wherever all nine offsets
    lie inside the crop. On a 2x2 CFA bytes 13 and 14 give the colours of
    the two neighbour groups and byte 15 their kind: 1 for the plus (offsets
    1, 3, 5, 7) and the cross (0, 2, 6, 8), at R and B sites; 2 for the row
    (3, 5) and the column (1, 7), at G sites; 0 (and bytes 13..15 zero)
    where neither fits."""
    pattern = np.ascontiguousarray(pattern, np.uint8)
    return _phases_cached(pattern.tobytes(), *pattern.shape)


def develop_smem_bytes(ph: int, pw: int, spline_stride: int) -> int:
    """Dynamic shared memory of one develop-kernel block (csrc/develop.cu
    `smem_bytes`): the levels tile with its halo, the calibration, the phase
    table."""
    return (4 * (_TILE_H + 2) * (_TILE_W + 2) + 4 * (128 + 5 * spline_stride)
            + 16 * ph * pw)


_CFA_TABLES: dict = {}


def _cfa_tables(plan, device):
    """(pattern, phases) of the plan's cropped CFA on `device`, uploaded once
    per CFA and device."""
    key = (plan.mode == "mono", plan.cfa_name, str(device))
    hit = _CFA_TABLES.get(key)
    if hit is None:
        pattern = _pattern(plan)
        hit = _CFA_TABLES[key] = (library.upload(pattern, device),
                                  library.upload(demosaic_phases(pattern), device))
    return hit


def _device_tables(plan, device):
    """(scal, spline, pattern, phases, n_knots): calib_tables on `device`,
    memoized on the plan per device, and the CFA tables (`_cfa_tables`)."""
    memo = plan.__dict__.setdefault("_cuda_tables", {})
    hit = memo.get(device)
    if hit is None:
        scal, spline, n_knots = calib_tables(plan)
        hit = memo[device] = (library.upload(scal, device), library.upload(spline, device),
                              n_knots)
    scal, spline, n_knots = hit
    return (scal, spline, *_cfa_tables(plan, device), n_knots)


def batch_tables(plans, device):
    """(scal [B,8,16], spline [B,5,S], pattern, phases, n_knots) on
    `device`: each image's own calibration, stacked, and the CFA tables the
    batch shares (the plans share their statics)."""
    tables = [calib_tables(p) for p in plans]
    scal = library.upload(np.stack([t[0] for t in tables]), device)
    spline = library.upload(np.stack([t[1] for t in tables]), device)
    return (scal, spline, *_cfa_tables(plans[0], device), tables[0][2])


def compare(got, want) -> tuple[int, float]:
    """(max |diff|, fraction of values differing) of two quantized images
    (tensors or arrays, compared on the host). Raises on a shape or dtype
    mismatch."""
    got, want = (a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
                 for a in (got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"{got.shape} {got.dtype} != {want.shape} {want.dtype}")
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d.max()), float((d != 0).mean())


def check_plane(plan, plane: torch.Tensor, kernel: str) -> None:
    """Raise unless `plane` is what the kernels take: a contiguous [H0, W0]
    u16 or f32 tensor that holds the plan's crop, for 8- or 16-bit output."""
    if plane.dtype not in (torch.uint16, torch.float32):
        raise TypeError(f"{kernel}: plane dtype {plane.dtype}, want uint16 or float32")
    if plane.dim() != 2 or not plane.is_contiguous():
        raise ValueError(f"{kernel}: plane must be a contiguous [H0, W0] tensor")
    if (plan.crop_y + plan.height > plane.shape[0]
            or plan.crop_x + plan.width > plane.shape[1]
            or min(plan.crop_x, plan.crop_y) < 0):
        raise ValueError(f"{kernel}: crop ({plan.crop_x},{plan.crop_y}) "
                         f"{plan.width}x{plan.height} exceeds plane {tuple(plane.shape)}")
    if plan.out_bits not in (8, 16):
        raise ValueError(f"{kernel}: out_bits {plan.out_bits}")


def check_batch(plans, planes: torch.Tensor, kernel: str) -> None:
    """Raise unless `planes` is what a batched launch takes for `plans`: one
    contiguous [B, H0, W0] u16 or f32 tensor, one plan per plane, and every
    plan with the same statics (one shape class)."""
    if planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError(f"{kernel}: planes must be one contiguous [B, H0, W0] tensor")
    if not plans or len(plans) != planes.shape[0]:
        raise ValueError(f"{kernel}: {len(plans)} plans for {planes.shape[0]} planes")
    statics = plans[0].statics()
    if any(p.statics() != statics for p in plans[1:]):
        raise ValueError(f"{kernel}: the plans of a batch must share their statics")
    check_plane(plans[0], planes[0], kernel)


def _element(planes: torch.Tensor) -> int:
    return int(planes.dtype == torch.float32)


def _out(plan, batch: int, height: int, width: int, device) -> torch.Tensor:
    return torch.empty((batch, 3, height, width), device=device,
                       dtype=torch.uint8 if plan.out_bits == 8 else torch.uint16)


def _launch(plan, planes: torch.Tensor, scal, spline, pattern, phases, n_knots,
            x_off: int | None = None, stage_limit: int = 4) -> torch.Tensor:
    """One launch over planes [B, H0, W0] -> unflipped [B, 3, H, W]. With
    `x_off`, planes are width shards [B, H, w + 2] (`engine.stage_sp`) of
    the crop's columns x_off .. x_off + w - 1 -> [B, 3, H, w]. stage_limit:
    4, or a cut 1..3 of a whole-image launch."""
    smem = develop_smem_bytes(*pattern.shape, spline.shape[-1])
    if smem > library.MAX_SMEM:
        raise ValueError(f"develop kernel: a block needs {smem} B of shared memory "
                         f"(CFA {tuple(pattern.shape)}, spline stride {spline.shape[-1]}), "
                         f"more than {library.MAX_SMEM}")
    if x_off is None:
        x_off, out_width, in_x0, crop_y = 0, plan.width, plan.crop_x, plan.crop_y
    else:
        out_width = planes.shape[-1] - 2
        in_x0, crop_y = 1 - x_off, 0
    out = _out(plan, planes.shape[0], plan.height, out_width, planes.device)
    lib = _lib()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        rc = lib.develop_batch_launch(
            planes.data_ptr(), _element(planes), planes.shape[0], planes.stride(0),
            planes.stride(1), in_x0, crop_y, plan.height, plan.width, x_off, out_width,
            scal.data_ptr(), spline.data_ptr(), spline.shape[-1], n_knots,
            phases.data_ptr(), pattern.shape[0], pattern.shape[1],
            int(plan.mode == "mono"), int(plan.linear), plan.out_bits, stage_limit,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"develop kernel launch failed: cudaError {rc}")
    return out


def _check_kernel(plan, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"develop kernel: unsupported device {device}")
    if not kernel_supported(plan):
        raise ValueError(f"develop kernel: unsupported plan (mode {plan.mode!r}, "
                         f"dem_path {plan.dem_path!r}, cfa {plan.cfa_name!r})")


def division_mismatches(pairs=(), f32_pairs=(), device="cuda") -> dict:
    """Run csrc/division_check.cu on the card: the inputs for which
    finish.cuh's div_rcp (a reciprocal multiply with one FMA correction)
    does not give the IEEE quotient. {"constants": [count per constant
    divisor of the back end, over all 2^32 float dividends], "levels":
    [count per (black, range) of `pairs`, over all 65,536 u16 raws],
    "levels_f32": [count per pair of `f32_pairs`, over all 2^32 float
    raws], "checked": {the same keys: inputs tried, which shows the check
    ran to its end}}. These launches are not counted in LAUNCHES."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"division_mismatches: unsupported device {device}")
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    counts, checked = {}, {}

    def zeros(n):
        return torch.zeros(n, dtype=torch.int64, device=device)

    with torch.cuda.device(device):
        counts["constants"], checked["constants"] = zeros(lib.division_check_count()), zeros(1)
        rc = lib.division_check_constants(counts["constants"].data_ptr(),
                                          checked["constants"].data_ptr(), stream)
        for key, f32, chosen in (("levels", 0, pairs), ("levels_f32", 1, f32_pairs)):
            table = torch.tensor(np.asarray(chosen, np.float32).reshape(-1, 2), device=device)
            counts[key], checked[key] = zeros(table.shape[0]), zeros(1)
            if rc == 0 and table.shape[0]:
                rc = lib.division_check_levels(table.data_ptr(), table.shape[0], f32,
                                               counts[key].data_ptr(), checked[key].data_ptr(),
                                               stream)
    if rc != 0:
        raise RuntimeError(f"division check launch failed: cudaError {rc}")
    out = {k: v.cpu().tolist() for k, v in counts.items()}
    out["checked"] = {k: int(v.item()) for k, v in checked.items()}
    return out


def develop_plain(plan, plane: torch.Tensor, stage_limit: int = 4) -> torch.Tensor:
    """The kernel's computation in plain PyTorch, on the plane's device."""
    return _develop_one(plan, plane, "direct", stage_limit)


def develop_batch_plain(plans, planes: torch.Tensor) -> torch.Tensor:
    """`develop_batch` in plain PyTorch: a loop of `develop_plain`."""
    return torch.stack([develop_plain(p, planes[i]) for i, p in enumerate(plans)])


def develop(plan, plane: torch.Tensor, stage_limit: int = 4) -> torch.Tensor:
    """Develop the uncropped sensor plane [H0, W0] (u16 or f32) of a
    full-size cfa/mono plan -> quantized planar [3, H', W'] u8/u16; with
    stage_limit 1..3 the back end cut there (`engine.finish_planes`)."""
    stage_limit = check_stage_limit(stage_limit)
    if plane.device.type == "cpu":
        return develop_plain(plan, plane, stage_limit)
    _check_kernel(plan, plane.device)
    check_plane(plan, plane, "develop kernel")
    out = _launch(plan, plane[None], *_device_tables(plan, plane.device),
                  stage_limit=stage_limit)
    global LAUNCHES
    if stage_limit == 4:
        LAUNCHES += 1
    else:
        CUT_LAUNCHES[stage_limit] += 1
    return apply_flips(out[0], plan.orientation_flips)


def develop_batch(plans, planes: torch.Tensor) -> torch.Tensor:
    """Develop B uncropped sensor planes [B, H0, W0] (u16 or f32) of one
    shape class, plans[i] calibrating planes[i], in one launch -> quantized
    planar [B, 3, H', W'] u8/u16."""
    if planes.device.type == "cpu":
        return develop_batch_plain(plans, planes)
    check_batch(plans, planes, "develop kernel")
    _check_kernel(plans[0], planes.device)
    out = _launch(plans[0], planes, *batch_tables(plans, planes.device))
    global BATCH_LAUNCHES
    BATCH_LAUNCHES += 1
    return apply_flips(out, plans[0].orientation_flips)


# -- the width-sharded develop ---------------------------------------------
#
# Counterpart of `_sp_local_develop` and `_sp_local_develop_batch`
# (develop_pallas.py:680-721) and of their callers `develop_pallas_sp` and
# the sp branch of BatchEngine._dispatch_pallas. An image's crop is cut
# into column shards (`engine.sp_shards`), one per device; a device may
# appear more than once (two shards on one card). Each shard is staged with
# a 1-column halo each side (`engine.stage_sp`), the inner halos are copied
# from the neighbouring shards on the devices (`engine.exchange_halos`),
# each shard is one launch of csrc/develop.cu at its global column offset,
# and the shards' outputs are concatenated on the first device
# (`engine.assemble`), where the EXIF flips permute the whole image.

def _place(plan, shards, devices, batch: bool) -> tuple[list, list[int]]:
    """The shards on their devices and their column offsets; raises unless
    they are what the shard launches take and cover the plan's crop."""
    devices = [torch.device(d) for d in devices]
    if not shards or len(shards) > len(devices):
        raise ValueError(f"develop_sp: {len(shards)} shards for {len(devices)} devices")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"develop_sp: devices {devices} of more than one type")
    placed = [s.to(d, non_blocking=True) for s, d in zip(shards, devices)]
    for s in placed:
        if s.dim() != (3 if batch else 2) or not s.is_contiguous():
            raise ValueError(f"develop_sp: each shard must be one contiguous "
                             f"{'[B, H, w + 2]' if batch else '[H, w + 2]'} tensor")
        if s.dtype not in (torch.uint16, torch.float32):
            raise TypeError(f"develop_sp: shard dtype {s.dtype}, want uint16 or float32")
        if s.shape[-2] != plan.height or s.shape[-1] < 3 or s.shape[0] != placed[0].shape[0]:
            raise ValueError(f"develop_sp: shard {tuple(s.shape)} for a crop of "
                             f"{plan.height} rows")
    x = sum(s.shape[-1] - 2 for s in placed)
    if x != plan.width:
        raise ValueError(f"develop_sp: the shards hold {x} columns of a crop {plan.width} wide")
    if plan.out_bits not in (8, 16):
        raise ValueError(f"develop_sp: out_bits {plan.out_bits}")
    return placed, _x_offsets(placed)


def develop_sp_plain(plan, plane_shards) -> torch.Tensor:
    """`develop_sp` in plain PyTorch on the shards' devices: the halos
    exchanged, each shard developed from its own columns
    (`develop_shard`), the outputs assembled on the first shard's
    device and flipped there."""
    exchange_halos(plane_shards)
    outs = [develop_shard(plan, s, x)
            for s, x in zip(plane_shards, _x_offsets(plane_shards))]
    return apply_flips(assemble(outs, plane_shards[0].device), plan.orientation_flips)


def develop_sp_batch_plain(plans, planes_shards) -> torch.Tensor:
    """`develop_sp_batch` in plain PyTorch: per image, `develop_sp_plain`'s
    shard develops with its own calibration."""
    exchange_halos(planes_shards)
    x_offs = _x_offsets(planes_shards)
    out = torch.stack([
        assemble([develop_shard(p, s[i], x) for s, x in zip(planes_shards, x_offs)],
                 planes_shards[0].device)
        for i, p in enumerate(plans)])
    return apply_flips(out, plans[0].orientation_flips)


def develop_sp(plan, plane_shards, devices) -> torch.Tensor:
    """Develop one image width-sharded over `devices` (shard i on
    devices[i]; a device may repeat): `plane_shards` are
    `engine.stage_sp`'s, on the host or already on their devices. The
    halos are exchanged between the devices, each shard is one launch of
    the develop kernel at its column offset (SP_LAUNCHES counts them), and
    the quantized planar [3, H', W'] output is assembled and flipped on
    devices[0]. CPU devices take the plain version."""
    shards, x_offs = _place(plan, plane_shards, devices, batch=False)
    if shards[0].device.type == "cpu":
        return develop_sp_plain(plan, shards)
    exchange_halos(shards)
    outs = []
    for s, x in zip(shards, x_offs):
        _check_kernel(plan, s.device)
        outs.append(_launch(plan, s[None], *_device_tables(plan, s.device), x_off=x)[0])
    global SP_LAUNCHES
    SP_LAUNCHES += len(outs)
    return apply_flips(assemble(outs, shards[0].device), plan.orientation_flips)


def develop_sp_batch(plans, planes_shards, devices) -> torch.Tensor:
    """Develop B images of one shape class width-sharded over `devices`,
    plans[i] calibrating image i: `planes_shards` are `engine.stage_sp`'s
    [B, H, w + 2] shards. One launch per shard develops its columns of all
    B images (blockIdx.z = image) -> quantized planar [B, 3, H', W'] on
    devices[0]. CPU devices take the plain version."""
    shards, x_offs = _place(plans[0], planes_shards, devices, batch=True)
    if len(plans) != shards[0].shape[0]:
        raise ValueError(f"develop_sp_batch: {len(plans)} plans for {shards[0].shape[0]} planes")
    statics = plans[0].statics()
    if any(p.statics() != statics for p in plans[1:]):
        raise ValueError("develop_sp_batch: the plans of a batch must share their statics")
    if shards[0].device.type == "cpu":
        return develop_sp_batch_plain(plans, shards)
    exchange_halos(shards)
    tables, outs = {}, []
    for s, x in zip(shards, x_offs):
        _check_kernel(plans[0], s.device)
        if s.device not in tables:
            tables[s.device] = batch_tables(plans, s.device)
        outs.append(_launch(plans[0], s, *tables[s.device], x_off=x))
    global SP_LAUNCHES
    SP_LAUNCHES += len(outs)
    return apply_flips(assemble(outs, shards[0].device), plans[0].orientation_flips)
