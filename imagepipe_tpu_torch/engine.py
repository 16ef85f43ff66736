"""Eager develop engine: the whole RAW->sRGB chain on tensors.

Counterpart of `imagepipe_tpu/engine.py`: levels, demosaic, white balance +
camera matrix + Lab, tone spline, Lab^-1, gamma, EXIF orientation and
quantize, as plain PyTorch on the plan's device. It runs every plan on the
CPU, and on CUDA the plans the develop kernel leaves to it (rgb mode, lut
numerics), as the XLA engine does beside the Pallas kernel in the JAX
package. It is also the plain version the CUDA kernel is checked against
(kernels/develop.py).

Every dem_path is ported: 'full', and the resize paths of a maxwidth /
maxheight below the image size: 'scaled' (the fused CFA demosaic +
downscale), 'fulldown' (stencil demosaic, then a 4-plane downscale) and
'plaindown' (mono and rgb). On CUDA the scaled-demosaic kernel
(kernels/develop_scaled.py) takes the 'scaled' cfa plans in 'direct'
numerics, and this engine is the executor of 'fulldown', 'plaindown', rgb
and 'lut' plans. There is no row banding: it exists for the 16 GB TPU chip
(engine.py:362-372 of the JAX package). `develop_batch_perimage` develops a
batch of one shape class with per-image calibration, the batch engine's
eager executor (parallel/batch.py).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import color as cc
from .raw import CFA
from .kernels.demosaic_full import stencil_demosaic_planes
from .ops.colorspaces import normalize_wbs
from .ops.demosaic import minscale_for
from .scaling import calculate_scale, scale_down_planar, scaling_size
from .spline import SplineFunc, eval_spline_arrays

__all__ = ["DevelopPlan", "make_develop_plan", "plan_from_jax",
           "develop_fused", "develop_batch_perimage", "finish_planes",
           "normalize_plane_np", "planar_to_hwc"]

_PARAM_KEYS = ("mins", "ranges", "mul", "cmatrix", "rgbmatrix")
_SPLINE_KEYS = ("spline_xs", "spline_ys", "spline_c1", "spline_c2", "spline_c3")


class DevelopPlan:
    """Static config plus device tensors for the develop of one RAW shape
    class on one device. Fields mirror the JAX package's DevelopPlan."""

    def __init__(self, *, cfa_name, height, width, crop_x, crop_y, mode,
                 out_bits, linear, params, apply_curve, n_knots,
                 orientation_flips, numerics, device, dem_path="full",
                 dem_w=0, dem_h=0):
        self.cfa_name = cfa_name
        self.height = height
        self.width = width
        self.crop_x = crop_x
        self.crop_y = crop_y
        self.mode = mode            # 'cfa' | 'mono' | 'rgb'
        self.out_bits = out_bits    # 8 | 16
        self.linear = linear
        self.params = params        # dict of float32 tensors on `device`
        self.apply_curve = apply_curve
        self.n_knots = n_knots
        self.orientation_flips = tuple(orientation_flips)  # (transpose, flip_x, flip_y)
        self.numerics = numerics    # 'lut' | 'direct'
        self.device = torch.device(device)
        self.dem_path = dem_path
        self.dem_w = dem_w
        self.dem_h = dem_h

    def statics(self) -> dict:
        """The static config, keyed as the JAX package's `statics()`: plans
        with equal statics develop in one batch."""
        return dict(cfa_name=self.cfa_name, height=self.height, width=self.width,
                    crop_x=self.crop_x, crop_y=self.crop_y,
                    mode=self.mode, out_bits=self.out_bits, linear=self.linear,
                    apply_curve=self.apply_curve, n_knots=self.n_knots,
                    orientation_flips=self.orientation_flips,
                    numerics=self.numerics, dem_path=self.dem_path,
                    dem_w=self.dem_w, dem_h=self.dem_h)

    def to(self, device) -> "DevelopPlan":
        """This plan with its params on `device` (itself if they are there);
        to a CUDA device they are copied without blocking the host."""
        device = torch.device(device)
        if device == self.device:
            return self
        twin = copy.copy(self)
        twin.device = device
        if device.type == "cuda":
            twin.params = {k: v.pin_memory().to(device, non_blocking=True)
                           for k, v in self.params.items()}
        else:
            twin.params = {k: v.to(device) for k, v in self.params.items()}
        return twin


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


def make_develop_plan(pipeline, out_bits: int = 8, numerics: str = "auto",
                      device=None) -> DevelopPlan:
    """The develop plan of a Pipeline over a RAW source with no rotatecrop
    (engine.py:71-169 of the JAX package); `device` defaults to the
    pipeline's."""
    device = torch.device(pipeline.device if device is None else device)
    img = pipeline.globals.image
    if not img.is_raw:
        raise ValueError("the develop plan targets RAW sources")
    ops = pipeline.ops
    if not ops.rotatecrop._noop():
        raise NotImplementedError("rotatecrop (non-noop crop or rotation): ROADMAP A9")
    raw = img.raw

    gf = ops.gofloat
    x, y, width, height = gf._size_image(raw.width, raw.height)
    if raw.cpp == 3:
        mode = "rgb"
    elif gf.is_cfa:
        mode = "cfa"
    else:
        mode = "mono"

    if mode == "mono":
        cmatrix = cc.SRGB_D65_43
        mul = [1.0, 1.0, 1.0, 1.0]
    else:
        cmatrix = ops.tolab.cam_to_xyz_normalized
        mul = normalize_wbs(ops.tolab.wb_coeffs)

    bc = ops.basecurve
    apply_curve = not (len(bc.points) == 0 and abs(bc.exposure) < 0.001)
    n_knots = 0
    arrays = dict(
        mins=gf.blacklevels,
        ranges=[w - b for w, b in zip(gf.whitelevels, gf.blacklevels)],
        mul=mul, cmatrix=cmatrix, rgbmatrix=cc.XYZ_D65_33)
    if apply_curve:
        scale = 2.0 ** bc.exposure
        spline = SplineFunc([(px, py * scale) for (px, py) in bc.points])
        n_knots = len(spline.xs)
        arrays.update(spline_xs=spline.xs, spline_ys=spline.ys,
                      spline_c1=spline.c1s, spline_c2=spline.c2s,
                      spline_c3=spline.c3s)

    cfa = CFA(ops.demosaic.cfa) if mode == "cfa" else None
    settings = pipeline.globals.settings
    dem_path, dem_w, dem_h = _demosaic_path(pipeline, mode, cfa, width, height)
    return DevelopPlan(
        cfa_name=(cfa.name if cfa is not None else ""),
        height=height, width=width, crop_x=x, crop_y=y, mode=mode,
        out_bits=out_bits, linear=settings.linear and out_bits == 16,
        params=_tensors(arrays, device), apply_curve=apply_curve,
        n_knots=n_knots, orientation_flips=ops.transform._orientation().to_flips(),
        numerics=cc.resolve_numerics(numerics, device), device=device,
        dem_path=dem_path, dem_w=dem_w, dem_h=dem_h)


def _demosaic_path(pipeline, mode, cfa, width, height):
    """(dem_path, dem_w, dem_h): the demosaic-stage size from the 3-pass
    size planning (pipeline.rs:317-338) and the path demosaic.rs:41-60
    would take, as the JAX package plans it."""
    settings = pipeline.globals.settings
    if not (settings.maxwidth or settings.maxheight):
        return "full", width, height
    allops = pipeline.ops.all_ops()
    for op in allops:
        op.reset()
    fw, fh = pipeline.globals.image.width(), pipeline.globals.image.height()
    for op in allops:
        fw, fh = op.transform_forward(fw, fh)
    fw, fh = scaling_size(fw, fh, settings.maxwidth, settings.maxheight)
    for op in reversed(allops):
        fw, fh = op.transform_reverse(fw, fh)
    for op in allops:
        op.reset()
    scale = calculate_scale(width, height, fw, fh)
    if scale <= 1.0:
        return "full", fw, fh
    if mode != "cfa":
        return "plaindown", fw, fh
    return ("scaled" if scale >= minscale_for(cfa.width) else "fulldown"), fw, fh


def plan_from_jax(jax_plan, device) -> DevelopPlan:
    """The port's plan for a JAX-package DevelopPlan: the same statics, its
    params moved over as numpy (`np.asarray`) and onto `device`. This is how
    state crosses between the two packages."""
    keys = _PARAM_KEYS + (_SPLINE_KEYS if jax_plan.apply_curve else ())
    return DevelopPlan(
        cfa_name=jax_plan.cfa_name, height=jax_plan.height,
        width=jax_plan.width, crop_x=jax_plan.crop_x, crop_y=jax_plan.crop_y,
        mode=jax_plan.mode, out_bits=jax_plan.out_bits,
        linear=jax_plan.linear,
        params=_tensors({k: jax_plan.params[k] for k in keys}, device),
        apply_curve=jax_plan.apply_curve, n_knots=jax_plan.n_knots,
        orientation_flips=jax_plan.orientation_flips,
        numerics=jax_plan.numerics, device=device,
        dem_path=jax_plan.dem_path, dem_w=jax_plan.dem_w, dem_h=jax_plan.dem_h)


def _levels(plane, mins, ranges):
    return torch.clamp((plane - mins) / ranges, max=1.0)


def _develop_one(plan: DevelopPlan, plane: torch.Tensor, numerics: str):
    """plane: the full sensor [H0,W0] (cfa/mono) or [H0,W0,3] (rgb), u16 or
    f32 counts -> quantized planar [3, H', W']. Crop, levels (cfa/mono use
    channel 0's levels, gofloat.rs:101-127), demosaic and the plan's resize
    (engine.py:212-226 of the JAX package), then finish_planes."""
    p = plan.params
    h, w = plan.height, plan.width
    plane = plane[plan.crop_y:plan.crop_y + h, plan.crop_x:plan.crop_x + w].float()
    if plan.mode == "rgb":
        rgbe = [_levels(plane[..., c], p["mins"][c], p["ranges"][c]) for c in range(3)]
        rgbe.append(torch.zeros((h, w), dtype=torch.float32, device=plane.device))
    else:
        v = _levels(plane, p["mins"][0], p["ranges"][0])
        if plan.mode == "mono":
            rgbe = [v, v, v, torch.zeros_like(v)]
        elif plan.dem_path == "scaled":
            # Fused demosaic + downscale (demosaic.rs:47-50).
            rgbe = list(scale_down_planar(v[None], plan.dem_w, plan.dem_h, 4,
                                          cfa=CFA(plan.cfa_name)))
        else:
            rgbe = stencil_demosaic_planes(v, plan.cfa_name, h, w)
            if plan.dem_path == "fulldown":
                rgbe = list(scale_down_planar(torch.stack(rgbe), plan.dem_w,
                                              plan.dem_h, 4))
    # Any resize of a non-CFA input (demosaic.rs:44-46).
    if plan.dem_path == "plaindown":
        rgbe = list(scale_down_planar(torch.stack(rgbe), plan.dem_w, plan.dem_h, 4))
    return finish_planes(rgbe, p, out_bits=plan.out_bits, linear=plan.linear,
                         apply_curve=plan.apply_curve, n_knots=plan.n_knots,
                         orientation_flips=plan.orientation_flips,
                         numerics=numerics)


def finish_planes(rgbe, params, *, out_bits, linear, apply_curve, n_knots,
                  orientation_flips, numerics):
    """The develop back end on RGBE planes: WB/matrix/Lab/spline/Lab^-1/
    gamma/orientation/quantize -> quantized planar [3, H', W']."""
    L, A, B = cc.camera_to_lab_planar(params["mul"], params["cmatrix"], rgbe,
                                      numerics)
    if apply_curve:
        L = eval_spline_arrays(
            params["spline_xs"], params["spline_ys"], params["spline_c1"],
            params["spline_c2"], params["spline_c3"], n_knots, L)
    rgb = list(cc.lab_to_rgb_planar(params["rgbmatrix"], (L, A, B)))
    # Gamma is skipped for 16-bit linear output (gamma.rs:17-18).
    if not linear:
        rgb = [cc.apply_srgb_gamma(torch.clamp(ch, 0.0, 1.0), numerics) for ch in rgb]

    transpose, flip_x, flip_y = orientation_flips
    for i in range(3):
        ch = rgb[i]
        if flip_x:
            ch = ch.flip(1)
        if flip_y:
            ch = ch.flip(0)
        if transpose:
            ch = ch.T
        rgb[i] = ch

    q = cc.output8bit if out_bits == 8 else cc.output16bit
    return torch.stack([q(ch) for ch in rgb], dim=0)


def normalize_plane(plan: DevelopPlan, plane: torch.Tensor) -> torch.Tensor:
    """A flat [H, W*3] cpp=3 payload as [H, W, 3]; cfa/mono pass through."""
    if plan.mode == "rgb" and plane.dim() == 2:
        return plane.reshape(plane.shape[0], -1, 3)
    return plane


def normalize_plane_np(plan: DevelopPlan, plane) -> np.ndarray:
    """`normalize_plane` on a host array, for staging batches on the host."""
    plane = np.asarray(plane)
    if plan.mode == "rgb" and plane.ndim == 2:
        return plane.reshape(plane.shape[0], -1, 3)
    return plane


def develop_fused(plan: DevelopPlan, plane: torch.Tensor) -> torch.Tensor:
    """Develop one sensor plane (a tensor on the plan's device) through the
    eager chain in the plan's numerics -> quantized planar [3, H', W']."""
    return _develop_one(plan, normalize_plane(plan, plane), plan.numerics)


def develop_batch_perimage(plans, planes: torch.Tensor) -> torch.Tensor:
    """Develop a batch of one shape class, planes[i] ([B, H0, W0] or
    [B, H0, W0, 3] normalized planes on the plans' device) with plans[i]'s
    own calibration (WB, levels, matrices, spline), through the eager chain
    in the plans' numerics -> quantized planar [B, 3, H', W'].

    Counterpart of `_develop_batch_perimage_jit` (a vmap of `_develop_one`
    in the JAX package); here a Python loop of `_develop_one`, one image at
    a time. It serves the plans the kernels do not take ('fulldown',
    'plaindown', rgb, 'lut') on any device, and every plan on the CPU."""
    statics = plans[0].statics()
    if any(p.statics() != statics for p in plans[1:]):
        raise ValueError("develop_batch_perimage: the plans of a batch must share their statics")
    return torch.stack([_develop_one(p, planes[i], p.numerics) for i, p in enumerate(plans)])


def planar_to_hwc(out: torch.Tensor) -> np.ndarray:
    """[3, H, W] tensor -> host [H, W, 3] numpy view."""
    return np.moveaxis(out.cpu().numpy(), -3, -1)
