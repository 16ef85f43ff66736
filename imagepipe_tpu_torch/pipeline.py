"""Pipeline: the eight ops, their content hash and YAML serial, size
planning, the stage cache, and the develop of an image to 8-bit or 16-bit
output, at full size or as a thumbnail (settings.maxwidth / maxheight).

Counterpart of `imagepipe_tpu/pipeline.py` (pipeline.rs). Settings, ops,
hashing and serials are byte-identical to the JAX package's. The routing of
`output_8bit(cache)` / `output_16bit(cache)` is the JAX package's:

* a raster source with default ops (and the fast path allowed) takes the
  raster fast path; a downscale runs the resampler on the pipeline's device;
* a RAW source with `cache=None`, the fast path allowed and a no-op
  rotatecrop develops in one pass. On CUDA, in 'direct' numerics,
  full-size cfa and mono plans launch the develop kernel
  (kernels/develop.py) and 'scaled' cfa thumbnails the scaled-demosaic
  kernel (kernels/develop_scaled.py). Every other plan ('fulldown',
  'plaindown', rgb, 'lut') runs the eager engine (engine.py);
* everything else runs staged (`run`, `_run_impl`): 3-pass size planning,
  a hash chain salted with the image's content hash, the deepest cache hit
  (latest wins), then the dirty suffix, each stage's result cached under
  its chain hash (pipeline.rs:311-375). Each maximal run of ops that join
  a fused segment (`ImageOp.device_chain`: a no-op rotatecrop, to_lab,
  basecurve, from_lab, gamma, transform) with two or more real stages, or
  one at the chain's end with the output's quantize, runs as one segment
  (`_dispatch_fused`): on CUDA one launch of the suffix kernel
  (kernels/suffix.py) in the numerics the ops resolve ('direct', or 'lut'
  under a `color.numerics_mode` override), bit-equal to running the ops'
  `run` in turn, every stage still cached. The other ops run their `run`;
  a rotated frame's rotatecrop launches the rotate kernel on CUDA
  (kernels/rotate.py). `FUSE_SUFFIX = False` runs every op's `run`
  instead.

A Pipeline develops on one device, chosen when it is made: `device=None`
is `default_device()`, the first CUDA device; the CPU only when asked for.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
import yaml

from . import hasher, profiling
from .buffer import OpBuffer
from .cache import MultiCache
from .color import output8bit, output16bit
from .decode import decode_file
from .hasher import BufHasher
from .sources import ImageSource, image_content_hash
from .engine import develop_fused, make_develop_plan, planar_to_hwc
from .kernels import develop as kdev
from .kernels import develop_scaled as kdev_scaled
from .kernels import suffix as ksuffix
from .ops import gofloat, demosaic, rotatecrop, colorspaces, curves, gamma, transform
from .scaling import scale_down_srgb, scale_down_srgb16, scaling_size

__all__ = [
    "SRGBImage", "SRGBImage16", "PipelineSettings", "PipelineGlobals",
    "PipelineOps", "Pipeline", "PipelineCache", "SERIAL_VERSION", "default_device",
]

log = logging.getLogger("imagepipe_tpu_torch")

SERIAL_VERSION = 0

PipelineCache = MultiCache

# Run each fusable stretch of the dirty suffix as one segment
# (_dispatch_fused); False runs every op's `run` in turn. Module flag, so a
# caller can hold the two bit-equal.
FUSE_SUFFIX = True

# Cache every stage output of a fused segment under its chain hash, as the
# per-stage loop does (pipeline.rs:369). False caches only the segment's
# last stage: the same outputs, fewer device buffers per edit, and a later
# edit inside the segment resumes from the stage before it.
CACHE_FUSED_INTERMEDIATES = True


def default_device() -> torch.device:
    """The first CUDA device. Raises when there is none: the port runs on
    the CPU only where a caller asks for it (`device="cpu"`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("imagepipe_tpu_torch: no CUDA device; pass device='cpu' "
                           "to develop on the CPU")
    return torch.device("cuda", 0)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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

    def hash(self, hasher: BufHasher) -> None:
        hasher.from_serialize(self)


@dataclasses.dataclass
class PipelineGlobals:
    """The image, the settings, and the device the staged ops run on (not
    hashed: the settings alone enter the hash chain)."""
    image: ImageSource
    settings: PipelineSettings
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))

    @staticmethod
    def mock(width: int, height: int, device="cpu") -> "PipelineGlobals":
        img = ImageSource.from_raster(np.zeros((height, width, 3), np.uint8))
        return PipelineGlobals(img, PipelineSettings(), torch.device(device))


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
        self.globals.device = self.device
        self._fused_plan = None
        self._stage_s: dict[str, float] = {}

    @property
    def stage_ms(self) -> dict[str, float]:
        """Host ms of each stage of the last staged run (its `stage.<name>`
        span), by op name, a fused segment's names joined by '+'; with the
        logger at DEBUG each stage ends in a device synchronize, so they
        include its device time."""
        return {k: s * 1e3 for k, s in self._stage_s.items()}

    # -- construction ------------------------------------------------------

    @staticmethod
    def new_cache(size: int) -> MultiCache:
        return MultiCache(size)

    @staticmethod
    def new_from_file(path, device=None) -> "Pipeline":
        device = default_device() if device is None else device
        return Pipeline.new_from_source(decode_file(path), device)

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

    # -- the scheduler (pipeline.rs:311-375) -------------------------------

    def run(self, cache: MultiCache | None = None) -> OpBuffer:
        return self._run_impl(cache)[0]

    def _run_impl(self, cache, final_quant=None):
        """`run`, and with `final_quant` 8 or 16 the output's quantize in
        the last fused segment when that segment ends the chain. Returns
        (final OpBuffer, quantized [3, H, W] tensor or None)."""
        with profiling.span("pipeline.plan"):
            ops = self.ops.all_ops()

            # Phase A: reset op memo state.
            for op in ops:
                op.reset()

            # Phase B: 3-pass size planning.
            width, height = self.globals.image.width(), self.globals.image.height()
            for op in ops:
                width, height = op.transform_forward(width, height)
            log.debug("Maximum possible image size is %dx%d", width, height)
            settings = self.globals.settings
            width, height = scaling_size(width, height, settings.maxwidth, settings.maxheight)
            log.debug("Final image size is %dx%d", width, height)
            for op in reversed(ops):
                width, height = op.transform_reverse(width, height)
            log.debug("Needed image size at demosaic %dx%d", width, height)
            settings.demosaic_width = width
            settings.demosaic_height = height

            # Phase C: chained hashing, salted with the image content hash
            # so a cache shared by several images cannot collide; the
            # deepest hit wins (pipeline.rs:341-352).
            h = BufHasher()
            h.write(image_content_hash(self.globals.image))
            settings.hash(h)
            ophashes = []
            startpos = 0
            bufin = OpBuffer.default()
            for i, op in enumerate(ops):
                op.hash(h)
                ophashes.append(h.copy().result())
                if cache is not None:
                    hit = cache.get(ophashes[-1])
                    if hit is not None:
                        bufin = hit
                        startpos = i + 1
        profiling.count("stage_cache.stages", len(ops))
        profiling.count("stage_cache.reused", startpos)

        # Phase D: run the dirty suffix.
        return self._execute_suffix(ops, startpos, bufin, ophashes, cache, final_quant)

    def _chains(self, ops, i, buf) -> list:
        """The device_chain of ops[i:] up to the first op that declines,
        each given the descriptor of the one before's output."""
        chains = []
        meta = (buf.width, buf.height, buf.colors, buf.monochrome)
        for op in ops[i:]:
            c = op.device_chain(self.globals, meta)
            if c is None:
                break
            chains.append(c)
            meta = c[3]
        return chains

    def _execute_suffix(self, ops, startpos, bufin, ophashes, cache, final_quant):
        """Run ops[startpos:], caching each stage's result under its chain
        hash (pipeline.rs:354-372). Each maximal run of joining ops fuses
        into one segment when that saves a launch: two or more real stages,
        or one at the chain's end with the quantize joining, on a device
        that fuses (`ksuffix.fuses`: the CPU and CUDA), in the numerics its
        ops resolve, the 'lut' override included. A declining op (an active
        rotatecrop) runs its `run`, and fusion starts again after it.
        Each stage or segment is the span `stage.<name>` (the segment's op
        names joined by '+'), its host seconds in `stage_ms`. Returns (final
        OpBuffer, quantized tensor or None)."""
        self._stage_s = {}
        sync = log.isEnabledFor(logging.DEBUG)
        quant = None
        i, n = startpos, len(ops)
        while i < n:
            fuse = FUSE_SUFFIX and ksuffix.fuses(bufin.data.device)
            chains = self._chains(ops, i, bufin) if fuse else []
            j = i + len(chains)
            real = sum(c[1] is not None for c in chains)
            fused = real >= 2 or (j == n and final_quant and real >= 1)
            name = "+".join(op.name() for op in ops[i:j]) if fused else ops[i].name()
            with profiling.span(f"stage.{name}", into=self._stage_s, key=name,
                                device=self.device):
                if fused:
                    bufin, quant = self._dispatch_fused(ops, i, chains, bufin, ophashes, cache,
                                                        final_quant if j == n else None)
                    i = j
                else:
                    op = ops[i]
                    bufin = op.run(self.globals, bufin)
                    if cache is not None:
                        cache.put_arc(ophashes[i], bufin, bufin.nbytes())
                    i += 1
                if sync:
                    _synchronize(self.device)
        return bufin, quant

    def _dispatch_fused(self, ops, startpos, chains, bufin, ophashes, cache, final_quant):
        """Run ops[startpos:startpos + len(chains)] as one segment
        (kernels/suffix.run_suffix: one kernel launch on CUDA) and cache
        each stage's buffer under its chain hash, or only the last one
        when CACHE_FUSED_INTERMEDIATES is False. An identity stage's
        buffer is its input's, as `op.run` returning `buf` shares it. A
        failed build or launch raises. Returns (final OpBuffer, quantized
        tensor or None)."""
        keep_all = CACHE_FUSED_INTERMEDIATES and cache is not None
        real = [k for k, c in enumerate(chains) if c[1] is not None]
        outs, quant = ksuffix.run_suffix(
            bufin.data, [chains[k][1] for k in real], [chains[k][2] for k in real],
            final_quant, [keep_all or k == real[-1] for k in real])
        out_of = dict(zip(real, outs))
        buffers, buf = [], bufin
        for k, c in enumerate(chains):
            if k in out_of:
                w, h, colors, mono = c[3]
                buf = None if out_of[k] is None else OpBuffer(w, h, colors, mono, out_of[k])
            buffers.append(buf)
        if cache is not None:
            for k in range(len(chains)) if keep_all else [len(chains) - 1]:
                cache.put_arc(ophashes[startpos + k], buffers[k], buffers[k].nbytes())
        return buffers[-1], quant

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
        with profiling.span("fused.plan"):
            h = BufHasher()
            self.globals.settings.hash(h)
            for op in self.ops.all_ops():
                op.hash(h)
            key = (out_bits, self.globals.settings.linear, h.result())
            if self._fused_plan is None or self._fused_plan[0] != key:
                self._fused_plan = (key, make_develop_plan(self, out_bits=out_bits,
                                                           device=self.device))
            return self._fused_plan[1]

    def _sensor_plane(self) -> torch.Tensor:
        """The RAW's sensor data on this pipeline's device, uploaded once
        per RawImage and device (shared with the staged gofloat)."""
        return gofloat.sensor_plane(self.globals.image.raw, self.device)

    def _run_fused(self, out_bits: int) -> np.ndarray:
        plan = self._fused_plan_cached(out_bits)
        plane = self._sensor_plane()
        direct = plan.device.type == "cuda" and plan.numerics == "direct"
        with profiling.span("fused.develop"):
            if direct and kdev.kernel_supported(plan):
                out = kdev.develop(plan, plane)
            elif direct and kdev_scaled.scaled_supported(plan):
                out = kdev_scaled.develop_scaled(plan, plane)
            else:
                out = develop_fused(plan, plane)
        return planar_to_hwc(out)

    def _raster_fastpath(self, bits: int) -> np.ndarray:
        other = self.globals.image.other
        rgb = other.to_rgb8() if bits == 8 else other.to_rgb16()
        height, width = rgb.shape[:2]
        s = self.globals.settings
        nwidth, nheight = scaling_size(width, height, s.maxwidth, s.maxheight)
        if (nwidth, nheight) == (width, height):
            return rgb
        scale = scale_down_srgb if bits == 8 else scale_down_srgb16
        src = torch.from_numpy(np.require(rgb, requirements=["C", "W"])).to(self.device)
        return scale(src, nwidth, nheight).cpu().numpy()

    def _output(self, bits: int, cache) -> np.ndarray:
        if self._fastpath_applicable():
            return self._raster_fastpath(bits)
        # 8-bit output is gamma-encoded; 16-bit output is linear.
        self.globals.settings.linear = bits == 16
        if cache is None and self._fused_applicable():
            return self._run_fused(bits)
        buffer, quant = self._run_impl(cache, final_quant=bits)
        if quant is None:
            with profiling.span("pipeline.quantize"):
                quant = output8bit(buffer.data) if bits == 8 else output16bit(buffer.data)
        return planar_to_hwc(quant)

    def output_8bit(self, cache: MultiCache | None = None) -> SRGBImage:
        with profiling.request("pipeline.output_8bit"):
            data = self._output(8, cache)
        return SRGBImage(data.shape[1], data.shape[0], data)

    def output_16bit(self, cache: MultiCache | None = None) -> SRGBImage16:
        with profiling.request("pipeline.output_16bit"):
            data = self._output(16, cache)
        return SRGBImage16(data.shape[1], data.shape[0], data)
