"""Pipeline: the eight ops, their content hash and YAML serial, and the
develop of a RAW to 8-bit or 16-bit output, at full size or as a
thumbnail (settings.maxwidth / maxheight).

Counterpart of `imagepipe_tpu/pipeline.py` (pipeline.rs). Settings, ops,
hashing and serials are byte-identical to the JAX package's. What runs:

* a RAW source with default geometry (no rotatecrop) develops in one pass.
  On CUDA, in 'direct' numerics, full-size cfa and mono plans launch the
  develop kernel (kernels/develop.py) and 'scaled' cfa thumbnails the
  scaled-demosaic kernel (kernels/develop_scaled.py). Every other plan
  ('fulldown', 'plaindown', rgb, 'lut') runs the eager engine (engine.py)
  on the same device;
* a raster source with default ops takes the fast path; a downscale runs
  the port's resampler on the pipeline's device.

The staged per-op run with its stage cache (`cache=`, `run()`) and a
non-noop rotatecrop are later slices; they raise NotImplementedError
naming their ROADMAP item.

A Pipeline develops on one device, chosen when it is made: `device=None`
picks the first CUDA device when there is one, else the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from contextlib import contextmanager

import numpy as np
import torch
import yaml

from ._host import BufHasher, ImageSource, decode_file, hasher
from .engine import develop_fused, make_develop_plan, planar_to_hwc
from .kernels import develop as kdev
from .kernels import develop_scaled as kdev_scaled
from .ops import gofloat, demosaic, rotatecrop, colorspaces, curves, gamma, transform
from .ops.base import STAGED
from .scaling import scale_down_srgb, scale_down_srgb16, scaling_size

__all__ = [
    "SRGBImage", "SRGBImage16", "PipelineSettings", "PipelineGlobals",
    "PipelineOps", "Pipeline", "SERIAL_VERSION", "default_device",
]

log = logging.getLogger("imagepipe_tpu_torch")

SERIAL_VERSION = 0


def default_device() -> torch.device:
    """The first CUDA device when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@contextmanager
def _timing(name: str):
    """Per-stage host wall timing at INFO level (pipeline.rs:68-80)."""
    start = time.perf_counter()
    yield
    log.info("timing: %7.1f ms for |%s", (time.perf_counter() - start) * 1000.0, name)


@dataclasses.dataclass
class SRGBImage:
    """Final 8-bit output: [height, width, 3] uint8 (pipeline.rs:25-30)."""
    width: int
    height: int
    data: np.ndarray


@dataclasses.dataclass
class SRGBImage16:
    """Final 16-bit output: [height, width, 3] uint16 (pipeline.rs:36-41)."""
    width: int
    height: int
    data: np.ndarray


@dataclasses.dataclass
class PipelineSettings:
    """Global knobs (pipeline.rs:110-131); all hashed into the op chain."""
    maxwidth: int = 0
    maxheight: int = 0
    demosaic_width: int = 0
    demosaic_height: int = 0
    linear: bool = False
    use_fastpath: bool = True

    def serialize_binary(self) -> bytes:
        return (hasher.pack_u64(self.maxwidth) + hasher.pack_u64(self.maxheight)
                + hasher.pack_u64(self.demosaic_width)
                + hasher.pack_u64(self.demosaic_height)
                + hasher.pack_bool(self.linear) + hasher.pack_bool(self.use_fastpath))

    def hash(self, h: BufHasher) -> None:
        h.from_serialize(self)


@dataclasses.dataclass
class PipelineGlobals:
    image: ImageSource
    settings: PipelineSettings


class PipelineOps:
    """The 8 fixed stages in execution order (pipeline.rs:154-164,211-243)."""

    ORDER = ("gofloat", "demosaic", "rotatecrop", "tolab", "basecurve",
             "fromlab", "gamma", "transform")

    def __init__(self, img: ImageSource):
        self.gofloat = gofloat.OpGoFloat(img)
        self.demosaic = demosaic.OpDemosaic(img)
        self.rotatecrop = rotatecrop.OpRotateCrop(img)
        self.tolab = colorspaces.OpToLab(img)
        self.basecurve = curves.OpBaseCurve(img)
        self.fromlab = colorspaces.OpFromLab(img)
        self.gamma = gamma.OpGamma(img)
        self.transform = transform.OpTransform(img)

    def all_ops(self):
        return [getattr(self, name) for name in self.ORDER]

    def content_hash(self) -> bytes:
        h = BufHasher()
        for op in self.all_ops():
            h.from_serialize(op)
        return h.result()

    def __eq__(self, other):
        if not isinstance(other, PipelineOps):
            return NotImplemented
        return self.content_hash() == other.content_hash()

    def __hash__(self):
        return hash(self.content_hash())

    # YAML schema: stage name -> op settings, stage order preserved
    # (serde field order parity, pipeline.rs:154-164).
    def to_settings_dict(self) -> dict:
        return {name: getattr(self, name).to_settings_dict() for name in self.ORDER}

    def load_settings_dict(self, d: dict) -> None:
        for name in self.ORDER:
            sub = d.get(name)
            if sub is not None:
                getattr(self, name).load_settings_dict(sub)


class Pipeline:
    """Develop one image through the 8-stage chain (pipeline.rs:245-470)."""

    def __init__(self, globals_: PipelineGlobals, ops: PipelineOps, device=None):
        self.globals = globals_
        self.ops = ops
        self.device = torch.device(default_device() if device is None else device)
        self._fused_plan = None

    # -- construction ------------------------------------------------------

    @staticmethod
    def new_from_file(path, device=None) -> "Pipeline":
        with _timing("total new_from_file()"):
            img = decode_file(path)
        return Pipeline.new_from_source(img, device)

    @staticmethod
    def new_from_source(img: ImageSource, device=None) -> "Pipeline":
        return Pipeline(PipelineGlobals(img, PipelineSettings()), PipelineOps(img),
                        device)

    def default_ops(self) -> bool:
        return self.ops == PipelineOps(self.globals.image)

    # -- serialization (pipeline.rs:290-309) -------------------------------

    def to_serial(self) -> str:
        doc = [
            {"version": SERIAL_VERSION, "filehash": "0"},
            self.ops.to_settings_dict(),
        ]
        return yaml.safe_dump(doc, sort_keys=False)

    @staticmethod
    def new_from_serial(img: ImageSource, serial: str, device=None) -> "Pipeline":
        doc = yaml.safe_load(serial)
        meta, opsdict = doc[0], doc[1]
        if int(meta.get("version", 0)) > SERIAL_VERSION:
            raise ValueError(f"unsupported pipeline file version {meta['version']}")
        pipe = Pipeline.new_from_source(img, device)
        pipe.ops.load_settings_dict(opsdict)
        return pipe

    def run(self, cache=None):
        raise NotImplementedError(f"Pipeline.run: {STAGED}")

    # -- outputs (pipeline.rs:377-469) -------------------------------------

    def _fastpath_applicable(self) -> bool:
        return (not self.globals.image.is_raw
                and self.globals.settings.use_fastpath and self.default_ops())

    def _fused_applicable(self) -> bool:
        """RAW source, fast path allowed and default geometry: develop in
        one pass instead of per stage."""
        s = self.globals.settings
        return (self.globals.image.is_raw and s.use_fastpath
                and self.ops.rotatecrop._noop())

    def _fused_plan_cached(self, out_bits: int):
        """make_develop_plan memoized on the (settings, ops) state, so a
        render loop keeps its device tables and uploads nothing twice."""
        h = BufHasher()
        self.globals.settings.hash(h)
        for op in self.ops.all_ops():
            op.hash(h)
        key = (out_bits, self.globals.settings.linear, h.result())
        if self._fused_plan is not None and self._fused_plan[0] == key:
            return self._fused_plan[1]
        plan = make_develop_plan(self, out_bits=out_bits, device=self.device)
        self._fused_plan = (key, plan)
        return plan

    def _sensor_plane(self) -> torch.Tensor:
        """The RAW's sensor data on this pipeline's device, uploaded once
        per RawImage and device. Cached under its own attribute: the JAX
        package keeps jax arrays in `_device_plane` / `_pallas_staged`."""
        raw = self.globals.image.raw
        hit = getattr(raw, "_torch_plane", None)
        if hit is not None and hit[0] == self.device:
            return hit[1]
        plane = torch.from_numpy(np.ascontiguousarray(raw.data)).to(self.device)
        raw._torch_plane = (self.device, plane)
        return plane

    def _run_fused(self, out_bits: int) -> np.ndarray:
        plan = self._fused_plan_cached(out_bits)
        plane = self._sensor_plane()
        if plan.device.type == "cuda" and plan.numerics == "direct":
            if kdev.kernel_supported(plan):
                with _timing("  fused develop (CUDA kernel)"):
                    return planar_to_hwc(kdev.develop(plan, plane))
            if kdev_scaled.scaled_supported(plan):
                with _timing("  fused develop (CUDA scaled-demosaic kernel)"):
                    return planar_to_hwc(kdev_scaled.develop_scaled(plan, plane))
        with _timing("  fused develop (eager engine)"):
            return planar_to_hwc(develop_fused(plan, plane))

    def _raster_fastpath(self, bits: int) -> np.ndarray:
        other = self.globals.image.other
        rgb = other.to_rgb8() if bits == 8 else other.to_rgb16()
        height, width = rgb.shape[:2]
        s = self.globals.settings
        nwidth, nheight = scaling_size(width, height, s.maxwidth, s.maxheight)
        if (nwidth, nheight) == (width, height):
            return rgb
        scale = scale_down_srgb if bits == 8 else scale_down_srgb16
        with _timing("  raster downscale"):
            src = torch.from_numpy(np.require(rgb, requirements=["C", "W"])).to(self.device)
            return scale(src, nwidth, nheight).cpu().numpy()

    def _output(self, bits: int, cache):
        if cache is not None:
            raise NotImplementedError(f"cache argument: {STAGED}")
        if self._fastpath_applicable():
            return self._raster_fastpath(bits)
        if not self._fused_applicable():
            if self.globals.image.is_raw and self.globals.settings.use_fastpath:
                raise NotImplementedError(
                    "rotatecrop (non-noop crop or rotation): ROADMAP A9")
            raise NotImplementedError(f"edited raster or use_fastpath=False: {STAGED}")
        # 8-bit output is gamma-encoded; 16-bit output is linear.
        self.globals.settings.linear = bits == 16
        return self._run_fused(bits)

    def output_8bit(self, cache=None) -> SRGBImage:
        with _timing("total output_8bit()"):
            data = self._output(8, cache)
        return SRGBImage(data.shape[1], data.shape[0], data)

    def output_16bit(self, cache=None) -> SRGBImage16:
        with _timing("total output_16bit()"):
            data = self._output(16, cache)
        return SRGBImage16(data.shape[1], data.shape[0], data)
