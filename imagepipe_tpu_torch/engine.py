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
devices. The width shards' plain code (`sp_shards`, `stage_sp`,
`stage_columns`, `exchange_halos`, `develop_shard`, `assemble`) is also
what the develop kernel's shard launches (kernels/develop.py) cut, stage
and assemble with, and its plain version.

`planar_to_hwc` brings an output to the host. On CUDA every host output,
the pipeline's and the batch engine's, is made by one pair of functions:
`start_host_copy` starts the copy into pooled pinned blocks, and
`host_results` makes each block a result, a view while the blocks that
live results hold stay within `PINNED_RESULTS_BYTES`.
"""

from __future__ import annotations

import copy
import threading
import weakref

import numpy as np
import torch

from . import color as cc
from . import profiling
from .raw import CFA
from .kernels.demosaic_full import stencil_demosaic_planes, stencil_demosaic_shard
from .ops.colorspaces import normalize_wbs
from .ops.demosaic import minscale_for
from .ops.gofloat import levels
from .ops.transform import apply_flips
from .scaling import (calculate_scale, resample_aligned, scale_down_axes, scale_down_planar,
                      scaling_size, source_span)
from .spline import SplineFunc, eval_spline_arrays

__all__ = ["DevelopPlan", "make_develop_plan", "plan_from_jax",
           "develop_fused", "auto_bands", "develop_batch_perimage",
           "develop_batch_fn", "stack_params", "normalize_plane",
           "develop_batch_perimage_sp", "stage_perimage_sp", "sp_spans",
           "sp_shards", "stage_sp", "stage_columns", "exchange_halos", "assemble",
           "develop_shard", "finish_planes", "normalize_plane_np", "planar_to_hwc",
           "start_host_copy", "host_results", "check_stage_limit", "STAGE_LIMITS",
           "PINNED_RESULTS_BYTES"]

_PARAM_KEYS = ("mins", "ranges", "mul", "cmatrix", "rgbmatrix")
_SPLINE_KEYS = ("spline_xs", "spline_ys", "spline_c1", "spline_c2", "spline_c3")

# Where the develop back end may stop (`finish_planes`): after the
# demosaic (1), after WB + matrix + Lab (2), after the spline (3), or the
# whole chain (4), as the JAX package's develop kernels' stage_limit.
STAGE_LIMITS = (1, 2, 3, 4)

# The width shards' unit: csrc/develop.cu's tile is 128 columns wide, and
# shards of whole tiles keep its interior tiles and vector stores in play.
_SHARD_TILE = 128

# The pinned bytes, in the pool's power-of-two blocks, that live host
# results of the process (every pipeline's and batch engine's) may hold at
# once: 64 results of 24 MP at 8 bits. Past it a result is a copy in
# ordinary memory, so what results keep locked stays bounded whatever a
# caller keeps.
PINNED_RESULTS_BYTES = 8 << 30
# Reentrant: a collection that frees a result may run inside the lock.
_pinned_lock = threading.RLock()
_pinned_held = 0


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


# -- the width shards --------------------------------------------------------
#
# An image's crop cut into column shards, one per device of a row; a device
# may appear more than once (two shards on one card). Each shard is staged
# on the host with a 1-column halo each side, the inner halos are copied
# from the neighbouring shards on the devices, each shard is developed from
# its own columns, and the shards' outputs are concatenated on the first
# device, where the EXIF flips permute the whole image. Plain PyTorch: the
# develop kernel's shard launches (kernels/develop.py::develop_sp) and the
# sharded eager develop below share it.

def sp_shards(width: int, spatial: int) -> list[tuple[int, int]]:
    """(x_off, w) of each column shard of a crop `width` wide split
    `spatial` ways. Every shard but the last is the same whole number of
    the develop kernel's 128-column tiles (the width over `spatial`,
    rounded up to a tile) and the last takes the rest, so interior tiles
    and 4-pixel vector stores stay in play: the counterpart of
    `sp_width_pad` (develop_pallas.py:657-662), with nothing padded. A crop
    narrower than spatial - 1 such shards gets fewer shards."""
    if spatial < 1 or width < 1:
        raise ValueError(f"sp_shards: width {width}, spatial {spatial}")
    per = -(-width // (spatial * _SHARD_TILE)) * _SHARD_TILE
    return [(x, min(per, width - x)) for x in range(0, width, per)]


def stage_sp(plan: DevelopPlan, planes, spatial: int, pin: bool = False) -> list[torch.Tensor]:
    """Host staging for the width-sharded develop (the counterpart of
    `stage_plane_rows_np`, develop_pallas.py:665-677): the plan's crop of
    `planes` cut into the shards of `sp_shards(plan.width, spatial)` by
    `stage_columns`, with zero halo columns. `exchange_halos` fills the
    inner halos on the devices; the outer ones stay zero and validity masks
    them off."""
    return stage_columns(plan, planes, sp_shards(plan.width, spatial), pin=pin)


def stage_columns(plan: DevelopPlan, planes, spans, pin: bool = False,
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


def develop_shard(plan: DevelopPlan, local: torch.Tensor, x_off: int, numerics: str = "direct",
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
    `sp_shards(plan.width, spatial)` and each shard develops its own
    columns. A resize plan ('scaled', 'fulldown', 'plaindown') has windows
    that cross any cut of its source, so it cuts its OUTPUT columns
    instead (`sp_shards(plan.dem_w, spatial)`), and each shard takes the
    source span its windows read (`source_span`); neighbouring spans
    overlap."""
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
    `stage_columns`). A full-size plan's shards are `stage_sp`'s,
    whose inner halos `exchange_halos` fills on the devices; a resize
    plan's overlapping spans take their halo columns from the host, which
    holds every column."""
    if plan.dem_path == "full":
        return stage_sp(plan, planes, spatial, pin=pin)
    spans = [(x0, w) for _, _, x0, w in sp_spans(plan, spatial)]
    return stage_columns(plan, planes, spans, pin=pin, halos=True)


def develop_batch_perimage_sp(plans, planes_shards, devices) -> torch.Tensor:
    """`develop_batch_perimage` width-sharded over `devices` (a row of
    `parallel.make_batch_mesh`; a device may repeat): `planes_shards` are
    `stage_perimage_sp(plans[0], ..., len(devices))`'s, on the host or on
    their devices, shard i on devices[i]. For a cfa full-size plan the
    halos are exchanged between the devices (`exchange_halos`); each
    shard develops its columns of every image with that image's
    calibration in its plan's numerics (`develop_shard`), and the
    outputs are assembled on devices[0] and flipped there -> quantized
    planar [B, 3, H', W']. Plain PyTorch on any device: no kernel is
    launched."""
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
        exchange_halos(shards)
    outs = []
    for (o0, n, x0, _), s in zip(spans, shards):
        local = [p.to(s.device) for p in plans]
        outs.append(torch.stack([develop_shard(p, s[i], x0, p.numerics, (o0, o0 + n))
                                 for i, p in enumerate(local)]))
    return apply_flips(assemble(outs, devices[0]), plan.orientation_flips)


# -- host output -------------------------------------------------------------

def planar_to_hwc(out: torch.Tensor) -> np.ndarray:
    """[3, H, W] tensor -> host [H, W, 3] numpy view. The span `output.d2h`
    is the wait for the work queued before the copy, then the copy.

    On CUDA the copy goes into a block of torch's caching pinned host
    allocator, laid out as `out` is (`start_host_copy`), and the result is
    a view of that block alone, or a copy past `PINNED_RESULTS_BYTES`
    (`host_results`). The block goes back to the pool when the result is
    dropped, and a later output reuses it with no fresh pages to touch. On
    the CPU the result is a view of `out` itself."""
    with profiling.span("output.d2h"):
        if out.device.type == "cuda":
            return host_results(*start_host_copy(out))[0]
        host = out.cpu()
    return np.moveaxis(host.numpy(), -3, -1)


def start_host_copy(out: torch.Tensor) -> tuple[list[torch.Tensor], torch.cuda.Event]:
    """Start copying a CUDA output to the host without blocking, each image
    into a block of its own from torch's caching pinned host allocator: a
    [3, H, W] output laid out as it is (as `.cpu()` lays it out), each
    image of a batch [B, 3, H, W] contiguous (as the batch engine's CPU
    results are). Returns the blocks and a CUDA event, recorded on the
    output device's current stream after the copies, that fires once they
    hold the images. While a profiler records, counts `output.pinned`
    (images copied) and `output.pinned_grew` (the blocks the pool had to
    allocate for them)."""
    grew = torch.cuda.host_memory_stats()["num_host_alloc"] if profiling.recording() else None
    if out.dim() == 3:
        images, layout = [out], torch.preserve_format
    else:
        images, layout = out, torch.contiguous_format
    blocks = [torch.empty_like(img, device="cpu", pin_memory=True, memory_format=layout)
              .copy_(img, non_blocking=True) for img in images]
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))
    if grew is not None:
        profiling.count("output.pinned", len(blocks))
        profiling.count("output.pinned_grew",
                        torch.cuda.host_memory_stats()["num_host_alloc"] - grew)
    return blocks, done


def host_results(blocks, done: torch.cuda.Event | None = None) -> list[np.ndarray]:
    """Wait on `done` (where given), then each [3, H, W] host block as an
    [H, W, 3] result: a view of the block while the blocks that live
    results hold, counted as the pool's power-of-two blocks (a 78 MB output
    holds 128 MB), stay within `PINNED_RESULTS_BYTES`, else a copy in
    ordinary memory with the same values and strides. A view's base array
    carries its block's share until it is collected."""
    global _pinned_held
    if done is not None:
        done.synchronize()
    results = []
    for block in blocks:
        planar = block.numpy()
        size = 1 << max(planar.nbytes - 1, 0).bit_length()
        with _pinned_lock:
            view = _pinned_held + size <= PINNED_RESULTS_BYTES
            if view:
                _pinned_held += size
        if view:
            weakref.finalize(planar, _release_pinned, size)
        else:
            planar = planar.copy(order="K")
        results.append(np.moveaxis(planar, -3, -1))
    return results


def _release_pinned(size: int) -> None:
    global _pinned_held
    with _pinned_lock:
        _pinned_held -= size
