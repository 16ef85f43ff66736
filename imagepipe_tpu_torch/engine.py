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
and 'lut' plans. `develop_fused(plan, plane, bands)` develops a frame over
30 MP in row bands with 1-row halos, as the JAX package does, bit-equal to
the unbanded develop and with a lower peak of device memory.
`develop_batch_perimage` develops a batch of one shape class with per-image
calibration, the batch engine's eager executor (parallel/batch.py);
`develop_batch_fn(plan)` is its closure over one plan's calibration; and
`develop_batch_perimage_sp` the same batch width-sharded across a row of
devices.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import color as cc
from . import profiling
from .raw import CFA
from .kernels.demosaic_full import stencil_demosaic_planes
from .ops.colorspaces import normalize_wbs
from .ops.demosaic import minscale_for
from .ops.gofloat import levels
from .scaling import (calculate_scale, scale_down_axes, scale_down_planar, scaling_size,
                      source_span)
from .spline import SplineFunc, eval_spline_arrays

__all__ = ["DevelopPlan", "make_develop_plan", "plan_from_jax",
           "develop_fused", "auto_bands", "develop_batch_perimage",
           "develop_batch_fn", "stack_params", "normalize_plane",
           "develop_batch_perimage_sp", "stage_perimage_sp", "sp_spans",
           "finish_planes", "normalize_plane_np", "planar_to_hwc", "check_stage_limit",
           "STAGE_LIMITS"]

_PARAM_KEYS = ("mins", "ranges", "mul", "cmatrix", "rgbmatrix")
_SPLINE_KEYS = ("spline_xs", "spline_ys", "spline_c1", "spline_c2", "spline_c3")

# Where the develop back end may stop (`finish_planes`): after the
# demosaic (1), after WB + matrix + Lab (2), after the spline (3), or the
# whole chain (4), as the JAX package's develop kernels' stage_limit.
STAGE_LIMITS = (1, 2, 3, 4)


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
        raise ValueError("the develop plan does not cover rotatecrop; the staged "
                         "path (Pipeline.run) runs it")
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
        numerics=cc.device_numerics(numerics, device), device=device,
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


def _develop_one(plan: DevelopPlan, plane: torch.Tensor, numerics: str,
                 stage_limit: int = 4):
    """plane: the full sensor [H0,W0] (cfa/mono) or [H0,W0,3] (rgb), u16 or
    f32 counts -> quantized planar [3, H', W']. Crop, levels (cfa/mono use
    channel 0's levels, gofloat.rs:101-127), demosaic and the plan's resize
    (engine.py:212-226 of the JAX package), then finish_planes, cut at
    `stage_limit`."""
    p = plan.params
    h, w = plan.height, plan.width
    plane = plane[plan.crop_y:plan.crop_y + h, plan.crop_x:plan.crop_x + w].float()
    if plan.mode == "rgb":
        rgbe = [levels(plane[..., c], p["mins"][c], p["ranges"][c]) for c in range(3)]
        rgbe.append(torch.zeros((h, w), dtype=torch.float32, device=plane.device))
    else:
        v = levels(plane, p["mins"][0], p["ranges"][0])
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
                         numerics=numerics, stage_limit=stage_limit)


def check_stage_limit(stage_limit) -> int:
    """`stage_limit` as an int of STAGE_LIMITS; raises ValueError on any
    other value."""
    if isinstance(stage_limit, bool) or stage_limit not in STAGE_LIMITS:
        raise ValueError(f"stage_limit {stage_limit!r}, want one of {STAGE_LIMITS}")
    return int(stage_limit)


def finish_planes(rgbe, params, *, out_bits, linear, apply_curve, n_knots,
                  orientation_flips, numerics, stage_limit=4):
    """The develop back end on RGBE planes: WB/matrix/Lab/spline/Lab^-1/
    gamma/orientation/quantize -> quantized planar [3, H', W'].
    stage_limit < 4 (a profiling knob, `_finish_tile(stage_limit)` of the
    JAX package's develop kernels) quantizes, without gamma, what the chain
    has after the demosaic (1: RGBE's first three planes), after Lab (2:
    L, A, B) or after the spline (3)."""
    stage_limit = check_stage_limit(stage_limit)
    rgb = list(rgbe[:3])
    if stage_limit >= 2:
        L, A, B = cc.camera_to_lab_planar(params["mul"], params["cmatrix"], rgbe,
                                          numerics)
        if apply_curve and stage_limit >= 3:
            L = eval_spline_arrays(
                params["spline_xs"], params["spline_ys"], params["spline_c1"],
                params["spline_c2"], params["spline_c3"], n_knots, L)
        rgb = [L, A, B]
    if stage_limit == 4:
        rgb = list(cc.lab_to_rgb_planar(params["rgbmatrix"], rgb))
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


def auto_bands(plan: DevelopPlan) -> int:
    """The JAX package's band count for `develop_fused(bands=None)`
    (engine.py:370-374 there): one band per ~24 MP above 30 MP, else 1."""
    pixels = plan.height * plan.width
    return pixels // (24_000_000 + 1) + 1 if pixels > 30_000_000 else 1


def develop_fused(plan: DevelopPlan, plane: torch.Tensor,
                  bands: int | None = None) -> torch.Tensor:
    """Develop one sensor plane (a tensor on the plan's device) through the
    eager chain in the plan's numerics -> quantized planar [3, H', W'].

    bands: develop a full-size cfa plan in horizontal bands of the crop,
    each with a 1-row halo clamped at the image edges, to bound the peak
    device memory of the chain's [H, W] float32 intermediates; None is
    `auto_bands`. A band is the plan's develop over its rows with the CFA
    pattern re-anchored to its first row (`CFA.shift`), as the JAX package
    bands (engine.py:358-408 there); its halo rows are dropped, so every
    kept row saw its real neighbours. The EXIF flips permute the
    concatenated image. Bit-equal to bands=1: the stencil is 3x3-local and
    every other stage pointwise. Other plans develop whole."""
    plane = normalize_plane(plan, plane)
    bands = auto_bands(plan) if bands is None else bands
    if bands <= 1 or plan.mode != "cfa" or plan.dem_path != "full":
        return _develop_one(plan, plane, plan.numerics)
    from .kernels.develop import apply_flips

    h = plan.height
    band_h = -(-h // bands)
    cfa = CFA(plan.cfa_name)
    pieces = []
    for s in range(0, h, band_h):
        e = min(h, s + band_h)
        s_h, e_h = max(0, s - 1), min(h, e + 1)
        band = copy.copy(plan)
        band.height, band.crop_y = e_h - s_h, plan.crop_y + s_h
        band.cfa_name = cfa.shift(0, s_h).name
        band.orientation_flips = (False, False, False)
        pieces.append(_develop_one(band, plane, plan.numerics)[:, s - s_h:e - s_h])
    return apply_flips(torch.cat(pieces, dim=1), plan.orientation_flips)


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


def develop_batch_fn(plan: DevelopPlan):
    """fn(planes) -> quantized planar [B, 3, H', W']: the batched develop of
    planes [B, H, W] (or rgb [B, H, W*3] / [B, H, W, 3]) with this one
    plan's calibration for every image, as the JAX package vmaps one plan's
    params (engine.py:411-422 there). The eager engine on the plan's device
    (`develop_batch_perimage`); planes elsewhere are copied there. On CUDA
    it launches no develop kernel, even for a plan the kernel takes: the
    kernel route for a batch is `parallel.BatchEngine` or
    `kernels.develop.develop_batch`."""

    def fn(planes) -> torch.Tensor:
        planes = torch.as_tensor(planes, device=plan.device)
        if plan.mode == "rgb" and planes.dim() == 3:
            planes = planes.reshape(planes.shape[0], planes.shape[1], -1, 3)
        return develop_batch_perimage([plan] * planes.shape[0], planes)

    return fn


def stack_params(param_dicts) -> dict:
    """Stack a list of per-image param dicts key by key: tensors into one
    tensor (the port's plans hold tensors), anything else into a numpy
    array."""
    return {k: (torch.stack([d[k] for d in param_dicts]) if torch.is_tensor(v)
                else np.stack([np.asarray(d[k]) for d in param_dicts]))
            for k, v in param_dicts[0].items()}


# -- the width-sharded eager develop -----------------------------------------
#
# The counterpart of the JAX package's GSPMD partition of
# `_develop_batch_perimage_jit` over the 'spatial' mesh axis
# (parallel/batch.py:160-172 there): each of a row's devices develops one
# column shard of every image of a chunk, and the shards' outputs are
# assembled on the row's first device, where the EXIF flips permute the
# whole image. Every output value is the same sequence of float32
# operations as in `develop_batch_perimage`, so the two are bit-equal.

def sp_spans(plan: DevelopPlan, spatial: int) -> list[tuple[int, int, int, int]]:
    """(o0, n, x0, w) of each shard of the sharded eager develop: output
    columns o0 .. o0 + n - 1 (before the flips) from the crop's columns
    x0 .. x0 + w - 1. A full-size plan cuts its crop into
    `kdev.sp_shards(plan.width, spatial)` and each shard develops its own
    columns. A resize plan ('scaled', 'fulldown', 'plaindown') has windows
    that cross any cut of its source, so it cuts its OUTPUT columns
    instead (`sp_shards(plan.dem_w, spatial)`), and each shard takes the
    source span its windows read (`source_span`); neighbouring spans
    overlap."""
    from .kernels.develop import sp_shards

    if plan.dem_path == "full":
        return [(x, w, x, w) for x, w in sp_shards(plan.width, spatial)]
    g = scale_down_axes(plan.width, plan.height, plan.dem_w, plan.dem_h)
    spans = []
    for o0, n in sp_shards(plan.dem_w, spatial):
        xs, xe = source_span(g, o0, o0 + n, plan.width)
        spans.append((o0, n, xs, xe - xs))
    return spans


def stage_perimage_sp(plan: DevelopPlan, planes, spatial: int,
                      pin: bool = False) -> list[torch.Tensor]:
    """Host staging of the sharded eager develop: `planes` (one normalized
    host plane or a sequence of B) as one tensor per shard of
    `sp_spans(plan, spatial)` ([B, H, w + 2], rgb [B, H, w + 2, 3];
    `kdev.stage_columns`). A full-size plan's shards are `kdev.stage_sp`'s,
    whose inner halos `exchange_halos` fills on the devices; a resize
    plan's overlapping spans take their halo columns from the host, which
    holds every column."""
    from .kernels import develop as kdev

    if plan.dem_path == "full":
        return kdev.stage_sp(plan, planes, spatial, pin=pin)
    spans = [(x0, w) for _, _, x0, w in sp_spans(plan, spatial)]
    return kdev.stage_columns(plan, planes, spans, pin=pin, halos=True)


def develop_batch_perimage_sp(plans, planes_shards, devices) -> torch.Tensor:
    """`develop_batch_perimage` width-sharded over `devices` (a row of
    `parallel.make_batch_mesh`; a device may repeat): `planes_shards` are
    `stage_perimage_sp(plans[0], ..., len(devices))`'s, on the host or on
    their devices, shard i on devices[i]. For a cfa full-size plan the
    halos are exchanged between the devices (`kdev.exchange_halos`); each
    shard develops its columns of every image with that image's
    calibration in its plan's numerics (`kdev.develop_shard`), and the
    outputs are assembled on devices[0] and flipped there -> quantized
    planar [B, 3, H', W']. Plain PyTorch on any device: no kernel is
    launched."""
    from .kernels import develop as kdev

    plan = plans[0]
    statics = plan.statics()
    if any(p.statics() != statics for p in plans[1:]):
        raise ValueError("develop_batch_perimage_sp: the plans of a batch must share "
                         "their statics")
    devices = [torch.device(d) for d in devices]
    spans = sp_spans(plan, len(devices))
    if len(planes_shards) != len(spans) or any(
            s.shape[0] != len(plans) or s.shape[2] != w + 2
            for s, (_, _, _, w) in zip(planes_shards, spans)):
        raise ValueError(f"develop_batch_perimage_sp: shards "
                         f"{[tuple(s.shape) for s in planes_shards]} for {len(plans)} plans "
                         f"and spans {spans}")
    shards = [s.to(d, non_blocking=True) for s, d in zip(planes_shards, devices)]
    if plan.dem_path == "full" and plan.mode == "cfa":
        kdev.exchange_halos(shards)
    outs = []
    for (o0, n, x0, _), s in zip(spans, shards):
        local = [p.to(s.device) for p in plans]
        outs.append(torch.stack([kdev.develop_shard(p, s[i], x0, p.numerics, (o0, o0 + n))
                                 for i, p in enumerate(local)]))
    return kdev.apply_flips(kdev.assemble(outs, devices[0]), plan.orientation_flips)


def planar_to_hwc(out: torch.Tensor) -> np.ndarray:
    """[3, H, W] tensor -> host [H, W, 3] numpy view. The span `output.d2h`
    is the wait for the work queued before the copy, then the copy.

    On CUDA the copy goes into a block of torch's caching pinned host
    allocator, laid out as `out` is, and the result is a view of that block
    alone. The block goes back to the pool when the result is dropped, and
    a later output reuses it with no fresh pages to touch. A caller that
    keeps N results holds N blocks, each rounded up to a power of two (a
    78 MB output holds 128 MB). While a profiler records, each such call
    counts `output.pinned`, and `output.pinned_grew` where the pool had to
    allocate a block. On the CPU the result is a view of `out` itself."""
    cuda = out.device.type == "cuda"
    grew = (torch.cuda.host_memory_stats()["num_host_alloc"]
            if cuda and profiling.recording() else None)
    with profiling.span("output.d2h"):
        if cuda:
            host = torch.empty_like(out, device="cpu", pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(out.device).synchronize()
        else:
            host = out.cpu()
    if grew is not None:
        profiling.count("output.pinned")
        if torch.cuda.host_memory_stats()["num_host_alloc"] > grew:
            profiling.count("output.pinned_grew")
    return np.moveaxis(host.numpy(), -3, -1)
