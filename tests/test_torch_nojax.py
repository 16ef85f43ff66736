"""PyTorch port: the package never imports JAX nor loads the JAX package.

* In a fresh interpreter, import `imagepipe_tpu_torch`, write a small DNG
  and a TIFF-EP (`tests/tiffgen.py`), decode and develop them on the CPU to
  8 and 16 bits and as a thumbnail, run the CLI and a `BatchEngine`, render
  a rotated frame staged with a stage cache and edit one through a
  `RenderService`; then
  no module in `sys.modules` has a file under `imagepipe_tpu/`, and `jax`
  never loaded.
* In a fresh interpreter, import the eager engine and the ops without the
  package's `__init__` (which imports the pipeline, and through it the
  kernels' wrappers) and run their plain work on the CPU: the banded and
  the width-sharded develop, the host output, the EXIF flips. No kernel
  wrapper and not the kernels' library loads: the dependencies point one
  way, ops -> engine -> kernels.
* The port's host modules (decode, the RAW model, DNG/TIFF, the codecs, ...)
  are copies of the JAX package's JAX-free ones. A drift test per module
  holds each copy equal to its original, apart from the edits listed here,
  so a fix cannot reach one copy only.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "imagepipe_tpu")
PORT_PKG = os.path.join(REPO, "imagepipe_tpu_torch")

# The port's copies of the JAX package's JAX-free host modules.
HOST_MODULES = (
    "raw", "hasher", "cct", "sources", "tiff", "cameras", "native", "lj92",
    "dng", "decode", "vendor", "fujic", "rw2", "nikon", "olympus", "pentax",
    "samsung", "kodak", "iiq", "hasselblad", "x3f", "arw1", "mrw", "raf",
    "sony_srf")

# The listed edits. (1) The originals cite the reference's Rust sources by
# their absolute checkout path; the copies cite them as "the reference's
# src/...". (2) `sources.py` loses the two functions that stage data on a
# TPU with jax.numpy (the port uploads in `Pipeline._sensor_plane` and
# `parallel/batch.py`).
_REFERENCE_PATH = re.compile(r"/\w+/reference/src/")
_DROPPED = {"sources": ("def staged_raw_plane(", "    def staged_planes(")}


def _drop_def(text: str, header: str) -> str:
    """`text` without the definition whose first line starts with `header`:
    from that line up to the next non-blank line indented no deeper."""
    lines = text.split("\n")
    start = next(i for i, line in enumerate(lines) if line.startswith(header))
    indent = len(header) - len(header.lstrip())
    end = start + 1
    while end < len(lines) and (not lines[end].strip()
                                or len(lines[end]) - len(lines[end].lstrip()) > indent):
        end += 1
    return "\n".join(lines[:start] + lines[end:])


def expected_copy(name: str, original: str) -> str:
    """The text of the port's copy of host module `name`, from the JAX
    package's file text."""
    text = _REFERENCE_PATH.sub("the reference's src/", original)
    for header in _DROPPED.get(name, ()):
        text = _drop_def(text, header)
    if name == "sources":
        text = text.replace(', "staged_raw_plane"]', "]")
    return text


def _read(*parts) -> str:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("name", HOST_MODULES)
def test_host_module_copy_matches_jax_package(name):
    original = _read(JAX_PKG, f"{name}.py")
    copy = _read(PORT_PKG, f"{name}.py")
    assert copy == expected_copy(name, original)
    assert "jax" not in {n.split(".")[0] for n in _imported_names(copy)}


def _imported_names(text: str):
    """Absolute module names and `.x` relative names imported by `text`."""
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
            elif node.module:
                yield "." + node.module
            else:
                yield from ("." + a.name for a in node.names)


def test_host_modules_are_the_import_closure():
    """The copied set is what decode, DNG I/O, the RAW model, hashing, CCT
    and image sources reach through their relative imports; `.color` is
    the port's own module, which holds the constants two codecs import."""
    seen, todo = set(), ["decode", "dng", "raw", "sources", "hasher", "cct"]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for imported in _imported_names(_read(PORT_PKG, f"{name}.py")):
            if imported.startswith(".") and imported[1:] != "color":
                todo.append(imported[1:])
    assert seen == set(HOST_MODULES)


_SCRIPT = r"""
import os, sys
import numpy as np
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import cameras, cli, decode, dng, raw
from imagepipe_tpu_torch.parallel import BatchEngine
sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
from tiffgen import TiffBuilder

tmp = sys.argv[1]
path = os.path.join(tmp, "tiny.dng")
dng.write_dng(path, raw.synthetic_bayer(64, 48, seed=7))
assert decode.decode_file(path).raw.width == 64
p = tip.Pipeline.new_from_file(path, device="cpu")
assert p.output_8bit().data.shape == (48, 64, 3)
assert p.output_16bit().data.shape == (48, 64, 3)
# A thumbnail: the scaled demosaic and the resampler.
p.globals.settings.maxwidth = 16
assert p.output_8bit().data.shape == (12, 16, 3)
assert tip.simple_decode_8bit(path, maxwidth=20, device="cpu").data.shape == (15, 20, 3)
assert cli.main(["converter", path], device="cpu") == 0

# A TIFF-EP (Epson ERF layout) through the vendor codec path.
cfa = np.random.default_rng(3).integers(0, 4096, (32, 48)).astype(">u2")
b = TiffBuilder(">")
strip = b.add_blob(cfa.tobytes())
ifd = b.add_ifd([(256, 4, [48]), (257, 4, [32]), (258, 3, [16]), (259, 3, [1]),
                 (262, 3, [32803]), (273, 4, [strip]), (278, 4, [32]),
                 (279, 4, [cfa.nbytes]), (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2])],
                chain=False)
b.add_ifd([(271, 2, "SEIKO EPSON CORP."), (272, 2, "R-D1"), (274, 3, [1]), (330, 4, [ifd])])
erf = os.path.join(tmp, "tiny.erf")
with open(erf, "wb") as f:
    f.write(b.bytes())
assert decode.decode_file(erf).raw.data.shape == (32, 48)
assert tip.Pipeline.new_from_file(erf, device="cpu").output_8bit().data.shape == (32, 48, 3)

# The staged path: a rotated, cropped render through a stage cache, and an
# edit through the render service.
p = tip.Pipeline.new_from_file(path, device="cpu")
p.ops.rotatecrop.rotation = 0.1
p.ops.rotatecrop.crop_left = 0.05
cache = tip.Pipeline.new_cache(64 << 20)
assert p.output_8bit(cache).data.shape[2] == 3 and len(cache) == 8
from imagepipe_tpu_torch.service import RenderService
svc = RenderService(cache_bytes=64 << 20, device="cpu")
svc.open_file("tiny", path)
assert svc.edit("tiny", {"rotatecrop": {"rotation": 0.05}}).data.shape[2] == 3
assert len(svc.cache) == 8

outs = BatchEngine(devices=["cpu"], max_batch=2).develop_files([path, path, erf])
assert [o.shape for o in outs] == [(48, 64, 3), (48, 64, 3), (32, 48, 3)]
outs = BatchEngine(devices=["cpu"] * 2, spatial=2).develop_files([path, erf])
assert [o.shape for o in outs] == [(48, 64, 3), (32, 48, 3)]
# The width-sharded develop (its plain version on CPU devices).
from imagepipe_tpu_torch.engine import make_develop_plan, stage_sp
from imagepipe_tpu_torch.kernels import develop as kdev
wide = raw.synthetic_xtrans(300, 24, seed=2)
plan = make_develop_plan(tip.Pipeline.new_from_source(tip.ImageSource.from_raw(wide), "cpu"),
                         numerics="direct")
sharded = kdev.develop_sp(plan, stage_sp(plan, wide.data, 3), ["cpu"] * 3)
assert sharded.shape == (3, 24, 300)
# The develop kernel's ablation ladder (its plain version on the CPU).
import torch
from imagepipe_tpu_torch.kernels import variants
rung = variants.run_variant(torch.from_numpy(wide.data), variants.variant_scal(plan), height=24,
                            width=300, variant="full", form="A")
assert rung.shape == (3, 24, 300) and rung.dtype == torch.uint8
# cameras' lazy `from .color import SRGB_D65_33` resolves to the port's module.
m = cameras.xyz_to_cam_from_cam2srgb([[1, 0, 0], [0, 1, 0], [0, 0, 1]])
assert m.shape == (4, 3)

jax_pkg = os.path.join(sys.argv[2], "imagepipe_tpu") + os.sep
files = sorted(n for n, mod in sys.modules.items()
               if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(jax_pkg))
print("JAXPKG", files)
mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "imagepipe_tpu.")))
print("JAXMODS", mods)
"""


def test_port_never_imports_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path), REPO],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAXPKG []" in proc.stdout, proc.stdout
    assert "JAXMODS []" in proc.stdout, proc.stdout


# The kernels' wrappers and library, which the eager engine and the ops must
# not load.
_KERNEL_MODULES = ("develop", "develop_scaled", "rotate", "suffix", "variants", "library")

_ENGINE_SCRIPT = r"""
import sys, types
# A bare package in place of the real one, whose __init__ imports the
# pipeline: only engine's and ops' own imports load modules.
pkg = types.ModuleType("imagepipe_tpu_torch")
pkg.__path__ = [sys.argv[1]]
sys.modules["imagepipe_tpu_torch"] = pkg
import numpy as np
import torch
from imagepipe_tpu_torch import color, engine, ops
from imagepipe_tpu_torch.buffer import OpBuffer
from imagepipe_tpu_torch.ops.transform import rotate_buffer
from imagepipe_tpu_torch.raw import Orientation, synthetic_bayer

raw = synthetic_bayer(300, 40, seed=3)
plan = engine.DevelopPlan(
    cfa_name="RGGB", height=40, width=300, crop_x=0, crop_y=0, mode="cfa", out_bits=8,
    linear=False, params={k: torch.tensor(np.asarray(v, np.float32)) for k, v in dict(
        mins=[0.0] * 4, ranges=[4095.0] * 4, mul=[2.0, 1.0, 1.5, 1.0],
        cmatrix=color.SRGB_D65_43, rgbmatrix=color.XYZ_D65_33).items()},
    apply_curve=False, n_knots=0, orientation_flips=(True, False, True), numerics="direct",
    device="cpu")
plane = torch.from_numpy(raw.data.astype(np.uint16))
whole = engine.develop_fused(plan, plane, bands=1)
assert torch.equal(engine.develop_fused(plan, plane, bands=3), whole)
shards = engine.stage_perimage_sp(plan, [raw.data, raw.data], 2)
sharded = engine.develop_batch_perimage_sp([plan, plan], shards, ["cpu", "cpu"])
assert torch.equal(sharded[1], whole)
assert engine.planar_to_hwc(whole).shape == (300, 40, 3)
buf = rotate_buffer(OpBuffer(40, 300, 3, False, whole.float()), Orientation.Rotate90)
assert (buf.width, buf.height) == (300, 40)
print("LOADED", sorted(m.rsplit(".", 1)[-1] for m in sys.modules
                       if m.startswith("imagepipe_tpu_torch.kernels.")))
"""


def test_engine_and_ops_load_no_kernel_wrapper():
    proc = subprocess.run([sys.executable, "-c", _ENGINE_SCRIPT, PORT_PKG],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = next(x for x in proc.stdout.splitlines() if x.startswith("LOADED"))
    loaded = set(ast.literal_eval(line[len("LOADED "):]))
    assert loaded and not loaded & set(_KERNEL_MODULES), loaded
