"""The fused dirty suffix: CUDA C++ for Hopper, and its plain version.

Counterpart of `imagepipe_tpu/pipeline.py::_dispatch_fused` (an XLA jit of
the stages `ImageOp.device_chain` describes; no Pallas kernel).
`run_suffix(data, stages, params, quant, keep)` runs one fused segment of
the staged pipeline's chainable tail, any run of `STAGES` in that order
and the final quantize, in one launch of csrc/suffix.cu, and returns
`(outputs, quantized)`: each stage's [3, H', W'] float32 output where
`keep` asks for it (else None), and the [3, H', W'] u8 or u16 output where
`quant` is 8 or 16 (else None).

* A segment runs in the numerics its ops resolve (`color.resolve_numerics`:
  the override of `color.numerics_mode` where one is set, else 'lut' on
  the CPU and 'direct' on CUDA). On the CPU it goes to the plain version,
  `suffix_plain`: the stages composed from the port's color.py and
  spline.py functions, as the ops' `run` composes them. On a CUDA device
  it launches the kernel in that numerics' form, or the wrapper raises;
  nothing falls back.
* Per stage, `params` holds its host values as `ImageOp.device_chain`
  gives them: to_lab (WB multipliers [4], camera matrix [3, 4]), basecurve
  (the spline's coefficients [5, n]: xs, ys, c1, c2, c3, the last two
  n - 1 long and padded), from_lab (the XYZ->RGB matrix [3, 3]), gamma
  (), transform (transpose, flip_x, flip_y). The kernel takes them as one
  float32 table (`pack_params`), one small pinned upload per launch.
* The 'lut' form reads color.TransformLUT's tables from their device
  copies (`TransformLUT._table`, made once per device), not uploaded per
  launch.
* `LAUNCHES` counts the kernel's launches in 'direct' numerics,
  `LUT_LAUNCHES` those in 'lut'. The library is built by
  kernels/library.py, with every other kernel; this module declares the
  signature of its entry point.

Numerics: every operation of the kernel is an explicit round-to-nearest
intrinsic in the plain version's order, with torch's NaN rules, so on the
card the two agree bit for bit in either numerics (chip_smoke.py phase
1e, NaN and +-Inf inputs included).
"""

from __future__ import annotations

import ctypes
from functools import cache

import numpy as np
import torch

from .. import color as cc
from ..ops.transform import apply_flips
from ..spline import eval_spline_arrays
from . import library

__all__ = ["run_suffix", "suffix_plain", "pack_params", "check_segment", "fuses", "STAGES",
           "LAUNCHES", "LUT_LAUNCHES"]

# Kernel launches by `run_suffix` in 'direct' and in 'lut' numerics since
# import (or since a caller reset them).
LAUNCHES = 0
LUT_LAUNCHES = 0

# The stages a segment may hold, in the order they run (each at most once).
STAGES = ("to_lab", "basecurve", "from_lab", "gamma", "transform")

# The kernel indexes a frame's pixels with 32 bits.
_MAX_PIXELS = (1 << 31) - 1


@cache
def _lib() -> ctypes.CDLL:
    """The kernels' library with csrc/suffix.cu's entry point declared."""
    lib = library.load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.suffix_launch.restype = i
    lib.suffix_launch.argtypes = [p, ll, ll, i, i, i, p, i, i, i, p, p, p, p, p, p, i, i,
                                  p, p, p]
    return lib


def check_segment(data: torch.Tensor, stages, params, quant, keep) -> None:
    """Raise unless the segment is one the kernel takes: a float32
    [4, H, W] input (to_lab first) or [3, H, W] (else) with unit column
    stride, stages a non-empty run of STAGES in order with one params
    tuple each, quant None, 8 or 16, and one keep flag per stage."""
    if not stages:
        raise ValueError("suffix: a segment needs at least one stage")
    order = [STAGES.index(s) if s in STAGES else -1 for s in stages]
    if min(order) < 0 or order != sorted(set(order)):
        raise ValueError(f"suffix: stages {list(stages)}, want a run of {STAGES} in order")
    if len(params) != len(stages) or len(keep) != len(stages):
        raise ValueError("suffix: one params tuple and one keep flag per stage")
    if quant not in (None, 8, 16):
        raise ValueError(f"suffix: quantize to {quant} bits, want None, 8 or 16")
    planes = 4 if stages[0] == "to_lab" else 3
    if data.dtype != torch.float32 or data.dim() != 3 or data.shape[0] != planes:
        raise ValueError(f"suffix: input {tuple(data.shape)} {data.dtype}, want float32 "
                         f"[{planes}, H, W] for a segment from {stages[0]}")
    if data.stride(2) != 1:
        raise ValueError("suffix: input columns must be contiguous")


def _numpy(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _stage_plain(stage: str, x: torch.Tensor, p, numerics: str) -> torch.Tensor:
    """One stage as the op's `run` computes it."""
    if stage == "to_lab":
        mul, cmatrix = p
        return torch.stack(cc.camera_to_lab_planar(mul, cmatrix, [x[c] for c in range(4)],
                                                    numerics))
    if stage == "basecurve":
        coeffs = _numpy(p[0])
        n = coeffs.shape[1]
        tables = [torch.tensor(row[:size], device=x.device)
                  for row, size in zip(coeffs, (n, n, n, n - 1, n - 1))]
        return torch.cat([eval_spline_arrays(*tables, n, x[0])[None], x[1:]])
    if stage == "from_lab":
        return torch.stack(cc.lab_to_rgb_planar(p[0], (x[0], x[1], x[2])))
    if stage == "gamma":
        return cc.apply_srgb_gamma(torch.clamp(x, 0.0, 1.0), numerics)
    return apply_flips(x, p)


def fuses(device) -> bool:
    """Whether a segment on `device` runs fused: on the CPU (the plain
    version) and on CUDA (the kernel), in either numerics. Elsewhere the
    pipeline runs the segment's ops' `run` in turn."""
    return torch.device(device).type in ("cpu", "cuda")


def suffix_plain(data: torch.Tensor, stages, params, quant=None, keep=None,
                 numerics: str = "auto"):
    """The kernel's computation in plain PyTorch, on the input's device:
    the same (outputs, quantized) as `run_suffix`."""
    keep = [True] * len(stages) if keep is None else list(keep)
    check_segment(data, stages, params, quant, keep)
    numerics = cc.resolve_numerics(numerics, data.device)
    outs = []
    for stage, p, k in zip(stages, params, keep):
        data = _stage_plain(stage, data, p, numerics)
        outs.append(data if k else None)
    q = None
    if quant is not None:
        q = cc.output8bit(data) if quant == 8 else cc.output16bit(data)
    return outs, q


def pack_params(stages, params) -> tuple[np.ndarray, int]:
    """(table, n_knots): the segment's parameters as the kernel reads them,
    float32 [25 + 5 n]: WB multipliers [4], camera matrix [3, 4], XYZ->RGB
    matrix [3, 3], then the spline's rows (0 where a stage is absent)."""
    by = dict(zip(stages, params))
    coeffs = _numpy(by["basecurve"][0]) if "basecurve" in by else np.zeros((5, 0), np.float32)
    table = np.zeros(25 + coeffs.size, np.float32)
    if "to_lab" in by:
        table[0:4] = _numpy(by["to_lab"][0]).reshape(4)
        table[4:16] = _numpy(by["to_lab"][1]).reshape(12)
    if "from_lab" in by:
        table[16:25] = _numpy(by["from_lab"][0]).reshape(9)
    table[25:] = coeffs.reshape(-1)
    return table, coeffs.shape[1]


def run_suffix(data: torch.Tensor, stages, params, quant=None, keep=None,
               numerics: str = "auto"):
    """One fused segment: `stages` (a run of STAGES, in order) with their
    `params` on `data`, keeping the outputs `keep` flags (all by default),
    quantized to `quant` bits after the last stage when it is 8 or 16, in
    `numerics` ('auto' resolves as the staged ops do,
    `color.resolve_numerics`). Returns (outputs, quantized) on the input's
    device. A frame with no pixels gives empty outputs and launches
    nothing."""
    stages = tuple(stages)
    keep = [True] * len(stages) if keep is None else [bool(k) for k in keep]
    check_segment(data, stages, params, quant, keep)
    numerics = cc.resolve_numerics(numerics, data.device)
    if data.device.type == "cpu":
        return suffix_plain(data, stages, params, quant, keep, numerics)
    if data.device.type != "cuda":
        raise ValueError(f"suffix kernel: unsupported device {data.device}")
    _, height, width = data.shape
    if height * width > _MAX_PIXELS:
        raise ValueError(f"suffix kernel: {height} x {width} pixels, at most {_MAX_PIXELS}")
    transpose, flip_x, flip_y = dict(zip(stages, params)).get("transform", (False,) * 3)
    outs = [torch.empty((3, height, width), dtype=torch.float32, device=data.device)
            if k else None for k in keep]
    q = None
    if quant is not None:
        q = torch.empty((3, height, width), dtype=torch.uint8 if quant == 8 else torch.uint16,
                        device=data.device)
    if height * width:
        table, n_knots = pack_params(stages, params)
        table = library.upload(table, data.device)
        ptr = dict.fromkeys(STAGES)
        for s, o in zip(stages, outs):
            ptr[s] = None if o is None else o.data_ptr()
        bits = sum(1 << STAGES.index(s) for s in stages)
        lut = numerics == "lut"
        tables = [t._table(data.device).data_ptr() if lut else None
                  for t in (cc.XYZ_LAB_TRANSFORM, cc.SRGB_GAMMA_TRANSFORM)]
        lib = _lib()
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            rc = lib.suffix_launch(
                data.data_ptr(), data.stride(0), data.stride(1), height, width, bits,
                table.data_ptr(), n_knots, int(bool(flip_x)), int(bool(flip_y)),
                *(ptr[s] for s in STAGES), None if q is None else q.data_ptr(), quant or 0,
                int(lut), *tables, stream)
        if rc != 0:
            raise RuntimeError(f"suffix kernel launch failed: cudaError {rc}")
        global LAUNCHES, LUT_LAUNCHES
        if lut:
            LUT_LAUNCHES += 1
        else:
            LAUNCHES += 1
    if transpose:
        # The flips were stores; the transpose is a view, as apply_flips
        # returns it.
        outs[-1] = None if outs[-1] is None else outs[-1].transpose(-1, -2)
        q = None if q is None else q.transpose(-1, -2)
    return outs, q
