"""imagepipe_tpu_torch: the RAW developer of `imagepipe_tpu`, in PyTorch.

The port of the JAX package to PyTorch and CUDA (Hopper). It imports torch
and never JAX, and loads nothing of the JAX package: the framework-free
host code (decode, RAW model, DNG/TIFF, codecs, hashing, CCT, image
sources) is this package's own copy of the JAX package's modules, under
the same file names (`raw.py`, `decode.py`, ...). A fix to one copy goes
into both (tests/test_torch_nojax.py holds them equal).

The develop of a RAW to 8-bit or 16-bit output runs as hand-written CUDA
kernels on an NVIDIA GPU (kernels/, csrc/) and as an eager PyTorch engine
for the plans they do not take (engine.py). Entry points run on the first
CUDA device unless the caller passes `device="cpu"`; with no CUDA device
and no device given they raise (`default_device`).

Public surface: the JAX package's (the reference's lib.rs:7-26): Pipeline,
ImageSource, OpBuffer, SRGBImage(16), Rotation, SplineFunc,
color_conversions, simple_decode_8bit, with MultiCache / PipelineCache,
the camera registry (register_camera, register_alias, register_from_dng,
register_sidecar_dir, known_cameras), from_rgb_str_vec, PipelineSettings/
Globals/Ops, CFA, Orientation, RawImage, RasterImage; plus default_device.
The batch engine is `parallel.BatchEngine`. Each module has the public
names of the JAX module of the same name, but those `_surface.NOT_PORTED`
lists with the reason the port leaves them out.
"""

from . import color as color_conversions
from .buffer import OpBuffer, from_rgb_str_vec
from .cache import MultiCache
from .cameras import (
    known_cameras, register_alias, register_camera, register_from_dng,
    register_sidecar_dir,
)
from .raw import CFA, Orientation, RawImage
from .ops.transform import Rotation
from .sources import ImageSource, RasterImage
from .pipeline import (
    Pipeline, PipelineCache, PipelineGlobals, PipelineOps, PipelineSettings,
    SRGBImage, SRGBImage16, default_device,
)
from .spline import SplineFunc

__version__ = "0.1.0"

__all__ = [
    "color_conversions", "OpBuffer", "from_rgb_str_vec", "MultiCache",
    "Rotation", "Pipeline", "PipelineCache", "PipelineGlobals", "PipelineOps",
    "PipelineSettings", "SRGBImage", "SRGBImage16", "CFA", "Orientation",
    "RawImage", "ImageSource", "RasterImage", "SplineFunc",
    "simple_decode_8bit", "register_camera", "register_alias",
    "register_from_dng", "register_sidecar_dir", "known_cameras",
    "default_device",
]


def simple_decode_8bit(path, maxwidth: int = 0, maxheight: int = 0,
                       device=None) -> SRGBImage:
    """One-call decode to 8-bit sRGB (lib.rs:21-26)."""
    pipeline = Pipeline.new_from_file(path, device)
    pipeline.globals.settings.maxwidth = maxwidth
    pipeline.globals.settings.maxheight = maxheight
    return pipeline.output_8bit(None)
