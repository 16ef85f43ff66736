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
  each shard from its own columns). Planes on a CUDA device launch the
  kernel, or the wrapper raises; nothing falls back.
* The kernel is built on first use by nvcc, with every other kernel of
  `csrc/`, into one library under `imagepipe_tpu_torch/build/` keyed by a
  hash of every source, header and flag (`build`), and bound with ctypes.
  Importing this module builds nothing.
* `LAUNCHES` counts the launches of `develop`, `BATCH_LAUNCHES` those of
  `develop_batch` and `SP_LAUNCHES` the shard launches of `develop_sp(_batch)`,
  so a run can show its main path went through the kernel.
  `develop(plan, plane, stage_limit)` with a cut 1..3 (the profiling knob
  of `_develop_pallas_jit(stage_limit=)`: the back end stopped after the
  demosaic, Lab or the spline, `engine.finish_planes`) counts in
  `CUT_LAUNCHES[stage_limit]` instead.
* Host tables reach the card from pinned memory without blocking the host
  (`upload`), so a caller can stage the next batch while this one runs. The
  kernel's demosaic reads a 16-byte table per CFA phase (`demosaic_phases`),
  uploaded once per CFA and device.
* `division_mismatches` runs csrc/division_check.cu, the card's proof that
  the kernels' reciprocal-multiply division equals the IEEE one.

Numerics: nvcc contracts a + b*c into FMA, as XLA does, and the plain
version's separate tensor ops do not. So kernel and plain version are held
to the cross-path contract of the JAX package (tests/test_pallas.py): max
|diff| <= 1 LSB and fewer than 2% of values differing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..raw import CFA
from ..engine import _develop_one, check_stage_limit, finish_planes
from ..ops.gofloat import levels
from ..scaling import resample_aligned, scale_down_axes
from .demosaic_full import OFFSETS_3X3, stencil_demosaic_shard

__all__ = ["develop", "develop_plain", "develop_batch", "develop_batch_plain",
           "develop_sp", "develop_sp_plain", "develop_sp_batch", "develop_sp_batch_plain",
           "sp_shards", "stage_sp", "stage_columns", "exchange_halos", "assemble",
           "develop_shard",
           "kernel_supported", "spline_stride", "calib_tables", "batch_tables", "demosaic_phases",
           "develop_smem_bytes", "division_mismatches", "upload", "apply_flips", "build",
           "build_key", "check_plane", "check_batch", "compare", "LAUNCHES",
           "BATCH_LAUNCHES", "SP_LAUNCHES", "CUT_LAUNCHES", "MAX_PATTERN", "MAX_SMEM",
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

# The most dynamic shared memory a block can have on Hopper (227 KB).
MAX_SMEM = 232448

# csrc/develop.cu's tile: 128 x 8 output pixels, staged with a 1-pixel halo.
_TILE_W, _TILE_H = 128, 8

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the develop kernels need the CUDA toolkit")


def build_key(csrc: Path = _CSRC) -> str:
    """Hash of the nvcc flags and of every `*.cu` and `*.cuh` under `csrc`
    (names and bytes): an edit to any source or header changes it."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for f in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every csrc/*.cu into one shared library unless a build of the
    same sources, headers and flags exists; returns its path. One nvcc per
    source, all started together, then one link."""
    key = build_key()
    lib = _BUILD_DIR / f"kernels_{key}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{key}.{os.getpid()}"
    jobs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = _BUILD_DIR / f"{src.stem}_{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = _BUILD_DIR / f"kernels_{tag}.tmp.so"
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
                          capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _library():
    """The kernels' library, built if needed, with every entry point bound
    (the develop kernels', kernels/rotate.py's, kernels/suffix.py's and
    kernels/variants.py's)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.develop_batch_launch.restype = i
        lib.develop_batch_launch.argtypes = [p, i, i, ll, ll, i, i, i, i, i, i, p, p, i, i,
                                             p, i, i, i, i, i, i, p, p]
        lib.develop_scaled_batch_launch.restype = i
        lib.develop_scaled_batch_launch.argtypes = [p, i, i, ll, ll, i, i, i, i,
                                                    p, p, p, p, p, p, i, p, p, i, i,
                                                    p, i, i, i, i, i, i, i, i, p, p]
        lib.division_check_constants.restype = i
        lib.division_check_constants.argtypes = [p, p, p]
        lib.division_check_levels.restype = i
        lib.division_check_levels.argtypes = [p, i, i, p, p, p]
        lib.division_check_count.restype = i
        f = ctypes.c_float
        lib.rotate_resample_launch.restype = i
        lib.rotate_resample_launch.argtypes = [p, i, i, i, p, p, i, i, f, f, i, i, i, p, p, i,
                                               i, i, p, p]
        lib.rotate_cfa_launch.restype = i
        lib.rotate_cfa_launch.argtypes = [p, i, i, p, p, i, i, f, f, i, i, p, i, i, p, p, i,
                                          i, i, p, p]
        lib.suffix_launch.restype = i
        lib.suffix_launch.argtypes = [p, ll, ll, i, i, i, p, i, i, i, p, p, p, p, p, p, i, i,
                                      p, p, p]
        lib.develop_variant_launch.restype = i
        lib.develop_variant_launch.argtypes = [p, i, i, i, p, i, i, i, i, i, p, i, i, p]
        _lib = lib
    return _lib


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


def upload(array, device) -> torch.Tensor:
    """A host array as a tensor on `device`. To a CUDA device it is copied
    from pinned memory without blocking the host, ordered on the device's
    current stream (torch keeps the pinned block until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


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
        hit = _CFA_TABLES[key] = (upload(pattern, device), upload(demosaic_phases(pattern), device))
    return hit


def _device_tables(plan, device):
    """(scal, spline, pattern, phases, n_knots): calib_tables on `device`,
    memoized on the plan per device, and the CFA tables (`_cfa_tables`)."""
    memo = plan.__dict__.setdefault("_cuda_tables", {})
    hit = memo.get(device)
    if hit is None:
        scal, spline, n_knots = calib_tables(plan)
        hit = memo[device] = (upload(scal, device), upload(spline, device), n_knots)
    scal, spline, n_knots = hit
    return (scal, spline, *_cfa_tables(plan, device), n_knots)


def batch_tables(plans, device):
    """(scal [B,8,16], spline [B,5,S], pattern, phases, n_knots) on
    `device`: each image's own calibration, stacked, and the CFA tables the
    batch shares (the plans share their statics)."""
    tables = [calib_tables(p) for p in plans]
    scal = upload(np.stack([t[0] for t in tables]), device)
    spline = upload(np.stack([t[1] for t in tables]), device)
    return (scal, spline, *_cfa_tables(plans[0], device), tables[0][2])


def apply_flips(out: torch.Tensor, orientation_flips) -> torch.Tensor:
    """EXIF orientation on planar [..., 3, H, W] output: flip x, flip y,
    then transpose (engine.py:243-252 of the JAX package). The flips copy
    (torch has no negative strides); u16 flips through an int16 view, as
    torch has no u16 flip."""
    transpose, flip_x, flip_y = orientation_flips
    dims = [d for d, on in ((-1, flip_x), (-2, flip_y)) if on]
    if dims:
        if out.dtype == torch.uint16:
            out = out.view(torch.int16).flip(dims).view(torch.uint16)
        else:
            out = out.flip(dims)
    if transpose:
        out = out.transpose(-1, -2)
    return out


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
    `x_off`, planes are width shards [B, H, w + 2] (`stage_sp`) of the crop's
    columns x_off .. x_off + w - 1 -> [B, 3, H, w]. stage_limit: 4, or a
    cut 1..3 of a whole-image launch."""
    smem = develop_smem_bytes(*pattern.shape, spline.shape[-1])
    if smem > MAX_SMEM:
        raise ValueError(f"develop kernel: a block needs {smem} B of shared memory "
                         f"(CFA {tuple(pattern.shape)}, spline stride {spline.shape[-1]}), "
                         f"more than {MAX_SMEM}")
    if x_off is None:
        x_off, out_width, in_x0, crop_y = 0, plan.width, plan.crop_x, plan.crop_y
    else:
        out_width = planes.shape[-1] - 2
        in_x0, crop_y = 1 - x_off, 0
    out = _out(plan, planes.shape[0], plan.height, out_width, planes.device)
    lib = _library()
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
    lib = _library()
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
# into column shards (`sp_shards`), one per device; a device may appear
# more than once (two shards on one card). Each shard is staged with a
# 1-column halo each side (`stage_sp`), the inner halos are copied from the
# neighbouring shards on the devices (`exchange_halos`), each shard is one
# launch of csrc/develop.cu at its global column offset, and the shards'
# outputs are concatenated on the first device (`assemble`), where the
# EXIF flips permute the whole image.

def sp_shards(width: int, spatial: int) -> list[tuple[int, int]]:
    """(x_off, w) of each column shard of a crop `width` wide split
    `spatial` ways. Every shard but the last is the same whole number of
    the kernel's 128-column tiles (the width over `spatial`, rounded up to a
    tile) and the last takes the rest, so interior tiles and 4-pixel vector
    stores stay in play: the counterpart of `sp_width_pad`
    (develop_pallas.py:657-662), with nothing padded. A crop narrower than
    spatial - 1 such shards gets fewer shards."""
    if spatial < 1 or width < 1:
        raise ValueError(f"sp_shards: width {width}, spatial {spatial}")
    per = -(-width // (spatial * _TILE_W)) * _TILE_W
    return [(x, min(per, width - x)) for x in range(0, width, per)]


def stage_sp(plan, planes, spatial: int, pin: bool = False) -> list[torch.Tensor]:
    """Host staging for the width-sharded develop (the counterpart of
    `stage_plane_rows_np`, develop_pallas.py:665-677): the plan's crop of
    `planes` cut into the shards of `sp_shards(plan.width, spatial)` by
    `stage_columns`, with zero halo columns. `exchange_halos` fills the
    inner halos on the devices; the outer ones stay zero and validity masks
    them off."""
    return stage_columns(plan, planes, sp_shards(plan.width, spatial), pin=pin)


def stage_columns(plan, planes, spans, pin: bool = False,
                  halos: bool = False) -> list[torch.Tensor]:
    """The plan's crop of `planes` (one [H0, W0] host array, rgb [H0, W0,
    3], or a sequence of B of them) as one host tensor per span (x0, w) of
    crop columns: [H, w + 2] (or [B, H, w + 2]; rgb with a last axis of 3)
    holding columns x0 .. x0 + w - 1 at 1..w. Columns 0 and w + 1 are a
    halo: the crop's columns x0 - 1 and x0 + w where `halos` is set and
    they lie inside the crop, else zero. pin: allocate in pinned memory,
    for a copy to the card that does not block the host."""
    single = getattr(planes, "ndim", None) == (3 if plan.mode == "rgb" else 2)
    seq = [np.asarray(planes)] if single else [np.asarray(p) for p in planes]
    dtype = torch.from_numpy(seq[0][:0]).dtype
    h, y0 = plan.height, plan.crop_y
    shards = []
    for x_off, w in spans:
        buf = torch.empty((len(seq), h, w + 2, *seq[0].shape[2:]), dtype=dtype, pin_memory=pin)
        host = buf.numpy()
        lo = max(x_off - 1, 0) if halos else x_off
        hi = min(x_off + w + 1, plan.width) if halos else x_off + w
        host[:, :, :lo - x_off + 1] = 0
        host[:, :, hi - x_off + 1:] = 0
        for i, p in enumerate(seq):
            host[i, :, lo - x_off + 1:hi - x_off + 1] = p[y0:y0 + h,
                                                          plan.crop_x + lo:plan.crop_x + hi]
        shards.append(buf[0] if single else buf)
    return shards


def exchange_halos(shards) -> None:
    """Fill the inner halo columns of staged shards ([.., H, w + 2], in
    column order) in place: shard i + 1's column 0 takes shard i's last own
    column, shard i's last column takes shard i + 1's first own column.
    Between two cards each is a peer-to-peer copy that torch orders on both
    devices' current streams with CUDA events (a two-way barrier), never
    with a host synchronize; on one card it is a copy on its stream."""
    for left, right in zip(shards, shards[1:]):
        right[..., 0].copy_(left[..., -2], non_blocking=True)
        left[..., -1].copy_(right[..., 1], non_blocking=True)


def assemble(outs, device) -> torch.Tensor:
    """The shards' outputs [.., 3, H, w] concatenated along the width on
    `device` (copies from other cards ordered by events, as above)."""
    return torch.cat([o.to(device, non_blocking=True) for o in outs], dim=-1)


def _x_offsets(shards) -> list[int]:
    """The global column offset of each staged shard [.., H, w + 2]."""
    return np.cumsum([0] + [s.shape[-1] - 2 for s in shards[:-1]]).tolist()


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


def develop_shard(plan, local: torch.Tensor, x_off: int, numerics: str = "direct",
                  out_cols=None) -> torch.Tensor:
    """One shard of raw counts developed in plain PyTorch with the whole
    image's validity, CFA colour and resample windows -> unflipped
    [3, H', n]. `local` ([H, w + 2], rgb [H, w + 2, 3]; `stage_columns`)
    holds the crop's columns x_off .. x_off + w - 1 at 1..w and a 1-column
    halo each side, which only the stencil demosaic reads. A full-size
    plan develops those w columns; a resize plan ('scaled', 'fulldown',
    'plaindown') its output columns out_cols = (o0, o1), whose source
    windows the shard must hold (`scaling.source_span`)."""
    p = plan.params
    local = local.float()
    if plan.mode == "rgb":
        rgbe = [levels(local[:, 1:-1, c], p["mins"][c], p["ranges"][c]) for c in range(3)]
        rgbe.append(torch.zeros_like(rgbe[0]))
    else:
        v = levels(local, p["mins"][0], p["ranges"][0])
        if plan.mode == "mono":
            c = v[:, 1:-1].contiguous()
            rgbe = [c, c, c, torch.zeros_like(c)]
        elif plan.dem_path == "scaled":
            rgbe = [v[:, 1:-1]]
        else:
            rgbe = stencil_demosaic_shard(v, plan.cfa_name, plan.height, plan.width, x_off)
    if plan.dem_path != "full":
        g = scale_down_axes(plan.width, plan.height, plan.dem_w, plan.dem_h)
        cfa = CFA(plan.cfa_name) if plan.dem_path == "scaled" else None
        rgbe = list(resample_aligned(torch.stack(rgbe), g, plan.width, plan.height, 4, cfa,
                                     out_cols, x_off))
    return finish_planes(rgbe, p, out_bits=plan.out_bits, linear=plan.linear,
                         apply_curve=plan.apply_curve, n_knots=plan.n_knots,
                         orientation_flips=(False, False, False), numerics=numerics)


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
    devices[i]; a device may repeat): `plane_shards` are `stage_sp`'s, on
    the host or already on their devices. The halos are exchanged between
    the devices, each shard is one launch of the develop kernel at its
    column offset (SP_LAUNCHES counts them), and the quantized planar
    [3, H', W'] output is assembled and flipped on devices[0]. CPU devices
    take the plain version."""
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
    plans[i] calibrating image i: `planes_shards` are `stage_sp`'s
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
