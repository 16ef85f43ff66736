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

* Planes on the CPU go to the plain versions, `develop_plain` and
  `develop_batch_plain`: the same develop written in plain PyTorch (crop ->
  levels -> stencil demosaic -> finish_planes in 'direct' numerics). Planes
  on a CUDA device launch the kernel, or the wrapper raises; nothing falls
  back.
* The kernel is built on first use by nvcc, with every other kernel of
  `csrc/`, into one library under `imagepipe_tpu_torch/build/` keyed by a
  hash of every source, header and flag (`build`), and bound with ctypes.
  Importing this module builds nothing.
* `LAUNCHES` counts the launches of `develop` and `BATCH_LAUNCHES` those of
  `develop_batch`, so a run can show its main path went through the kernel.
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
from ..engine import _develop_one
from .demosaic_full import OFFSETS_3X3

__all__ = ["develop", "develop_plain", "develop_batch", "develop_batch_plain",
           "kernel_supported", "calib_tables", "batch_tables", "demosaic_phases",
           "develop_smem_bytes", "division_mismatches", "upload", "apply_flips", "build",
           "build_key", "check_plane", "check_batch", "compare", "LAUNCHES",
           "BATCH_LAUNCHES", "MAX_PATTERN", "MAX_SMEM", "MAX_LSB", "MAX_FLIP_FRACTION"]

# Kernel launches by `develop` and by `develop_batch` since import (or since
# a caller reset them to 0).
LAUNCHES = 0
BATCH_LAUNCHES = 0

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
    (the develop kernels' and kernels/rotate.py's)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.develop_batch_launch.restype = i
        lib.develop_batch_launch.argtypes = [p, i, i, ll, ll, i, i, i, i, p, p, i, i,
                                             p, i, i, i, i, i, p, p]
        lib.develop_scaled_batch_launch.restype = i
        lib.develop_scaled_batch_launch.argtypes = [p, i, i, ll, ll, i, i, i, i,
                                                    p, p, p, p, p, p, i, p, p, i, i,
                                                    p, i, i, i, i, i, i, i, p, p]
        lib.division_check_constants.restype = i
        lib.division_check_constants.argtypes = [p, p, p]
        lib.division_check_levels.restype = i
        lib.division_check_levels.argtypes = [p, i, i, p, p, p]
        lib.division_check_count.restype = i
        f = ctypes.c_float
        lib.rotate_resample_launch.restype = i
        lib.rotate_resample_launch.argtypes = [p, i, i, i, p, p, i, i, f, f, i, i, p, p]
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
    spline = np.zeros((5, max(16, -(-n_knots // 8) * 8)), np.float32)
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
    memoized on the plan, and the CFA tables (`_cfa_tables`)."""
    hit = getattr(plan, "_cuda_tables", None)
    if hit is None or hit[0] != device:
        scal, spline, n_knots = calib_tables(plan)
        hit = plan._cuda_tables = (device, (upload(scal, device), upload(spline, device), n_knots))
    scal, spline, n_knots = hit[1]
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


def _launch(plan, planes: torch.Tensor, scal, spline, pattern, phases, n_knots) -> torch.Tensor:
    """One launch over planes [B, H0, W0] -> unflipped [B, 3, H, W]."""
    smem = develop_smem_bytes(*pattern.shape, spline.shape[-1])
    if smem > MAX_SMEM:
        raise ValueError(f"develop kernel: a block needs {smem} B of shared memory "
                         f"(CFA {tuple(pattern.shape)}, spline stride {spline.shape[-1]}), "
                         f"more than {MAX_SMEM}")
    out = _out(plan, planes.shape[0], plan.height, plan.width, planes.device)
    lib = _library()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        rc = lib.develop_batch_launch(
            planes.data_ptr(), _element(planes), planes.shape[0], planes.stride(0),
            planes.stride(1), plan.crop_x, plan.crop_y, plan.height, plan.width,
            scal.data_ptr(), spline.data_ptr(), spline.shape[-1], n_knots,
            phases.data_ptr(), pattern.shape[0], pattern.shape[1],
            int(plan.mode == "mono"), int(plan.linear), plan.out_bits,
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


def develop_plain(plan, plane: torch.Tensor) -> torch.Tensor:
    """The kernel's computation in plain PyTorch, on the plane's device."""
    return _develop_one(plan, plane, "direct")


def develop_batch_plain(plans, planes: torch.Tensor) -> torch.Tensor:
    """`develop_batch` in plain PyTorch: a loop of `develop_plain`."""
    return torch.stack([develop_plain(p, planes[i]) for i, p in enumerate(plans)])


def develop(plan, plane: torch.Tensor) -> torch.Tensor:
    """Develop the uncropped sensor plane [H0, W0] (u16 or f32) of a
    full-size cfa/mono plan -> quantized planar [3, H', W'] u8/u16."""
    if plane.device.type == "cpu":
        return develop_plain(plan, plane)
    _check_kernel(plan, plane.device)
    check_plane(plan, plane, "develop kernel")
    out = _launch(plan, plane[None], *_device_tables(plan, plane.device))
    global LAUNCHES
    LAUNCHES += 1
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
