"""PyTorch port: the develop kernel's ablation ladder (kernels/variants.py).

The TPU kernels are `make_kernel` of scripts/exp_kernel_variants.py (form A)
and scripts/exp_kernel_variants3.py (form B). Each test loads the script
with importlib and builds its own `pallas_call` from `make_kernel` with the
script's specs and padding (exp_kernel_variants.py:203-221, 258-263), run
in interpret mode on the CPU; the port's plain version `variant_plain`
takes the unpadded plane. The CUDA kernel (csrc/develop_variants.cu) has no
CPU mode: the `cuda`-marked tests hold it against the plain version on the
card (`python -m pytest tests/test_torch_variants.py -m cuda`).

Contract: u8 outputs max |diff| <= 1 LSB on fewer than 2% of values; float32
outputs max |diff| <= 1e-3 on their 0-255 scale. The float32 output of
`full` is not held to the JAX kernel at 1e-3: XLA on the CPU contracts
a * b + c into FMA and divides by a constant through its reciprocal, and
the back end turns an ulp at the Lab^-1 cancellation into ~1e-3 at dark,
saturated pixels, so the plain version, which rounds each operation, is
1.63e-3 off it at the base frame. That output is held to the u8 rung it
truncates to, which is held to the JAX kernel, and on the card the kernel
to its plain version at 1e-3. Run as a script, this file prints each
rung's measured maximum against the JAX kernel.
"""

import importlib.util
import json
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from imagepipe_tpu import ImageSource, Pipeline
from imagepipe_tpu.engine import make_develop_plan
from imagepipe_tpu.raw import synthetic_bayer
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.engine import make_develop_plan as port_plan
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import variants as kv

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HALO, HALO_X = 8, 128                      # the scripts' padding
BASE = (192, 768)                          # (height, width): whole 96 x 384 TPU tiles
PARTIAL = (100, 500)                       # partial TPU tiles on both axes
TILE = (96, 384)                           # the scripts' tile


@lru_cache(maxsize=None)
def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script_for(form):
    return _script("exp_kernel_variants" if form == "A" else "exp_kernel_variants3")


@lru_cache(maxsize=None)
def _frame(height, width):
    """(u16 plane, scal [8, 16]) of a seeded synthetic Bayer RAW, the
    scal block of the scripts' main() (exp_kernel_variants.py:237-242). The
    first 128 samples of the tile row at (96, 384) are 0, so a dma_floor
    form A tile flags 0; so are the first 40 samples of row 0."""
    raw = synthetic_bayer(width, height, seed=3)
    plan = make_develop_plan(Pipeline.new_from_source(ImageSource.from_raw(raw)), out_bits=8)
    p = plan.params
    scal = np.zeros((8, 16), np.float32)
    scal[0, 0] = np.asarray(p["mins"])[0]
    scal[0, 1] = np.asarray(p["ranges"])[0]
    scal[1, :4] = np.asarray(p["mul"])
    scal[2:5, :4] = np.asarray(p["cmatrix"])
    scal[5:8, :3] = np.asarray(p["rgbmatrix"])
    data = raw.data.copy()
    data[TILE[0], TILE[1]:TILE[1] + 128] = 0
    data[0, :40] = 0
    return data, scal


def _plane(height, width, dt):
    data, _ = _frame(height, width)
    return data if dt == "u16" else data.astype(np.float32)


def _jax_rung(form, variant, plane, scal, out_dt, tile=TILE):
    """The script's make_kernel in a pallas_call with the script's specs and
    padding, interpret=True -> [3, H, W]."""
    mod = _script_for(form)
    th, tw = tile
    height, width = plane.shape
    grid = (pl.cdiv(height, th), pl.cdiv(width, tw))
    pp = jnp.pad(jnp.asarray(plane), ((HALO, grid[0] * th + HALO - height),
                                      (HALO_X, grid[1] * tw + HALO_X - width)))
    outdt = jnp.uint8 if out_dt == "u8" else jnp.float32
    kernel = (mod.make_kernel(th, tw, height, width, variant) if form == "A"
              else mod.make_kernel(th, tw, height, width, variant, outdt))
    out = pl.pallas_call(
        kernel, grid=grid,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[pl.BlockSpec((th, tw), lambda i, j: (i, j), memory_space=pltpu.VMEM)] * 3,
        out_shape=[jax.ShapeDtypeStruct((height, width), outdt)] * 3,
        scratch_shapes=[pltpu.VMEM((2, th + 2 * HALO, tw + 2 * HALO_X), pp.dtype),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)(jnp.asarray(scal), pp)
    return np.stack([np.asarray(o) for o in out])


def _port(form, variant, plane, scal, out_dt, tile=None):
    dtype = torch.uint8 if out_dt == "u8" else torch.float32
    if (variant, form) == ("dma_floor", "A") and tile is None:
        tile = TILE
    return kv.variant_plain(torch.from_numpy(plane), scal, height=plane.shape[0],
                            width=plane.shape[1], variant=variant, form=form, out_dtype=dtype,
                            tile=tile)


def _assert_contract(got, want, out_dt):
    if not torch.is_tensor(want):
        want = torch.from_numpy(np.ascontiguousarray(want))
    maxd, frac = kv.compare_variant(got, want.to(got.device))
    if out_dt == "u8":
        assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)
    else:
        assert maxd <= kv.MAX_F32_DIFF, maxd


def _rungs(with_full_f32=True):
    out = []
    for form in kv.FORMS:
        for variant in kv.VARIANTS:
            for dt in ("u16", "f32"):
                outs = ("u8",) if form == "A" or variant == "demosaic" else ("u8", "f32")
                out += [(form, variant, dt, o) for o in outs
                        if with_full_f32 or (variant, o) != ("full", "f32")]
    return out


@pytest.mark.parametrize("form,variant,dt,out_dt", _rungs(with_full_f32=False))
def test_plain_matches_tpu_kernel(form, variant, dt, out_dt):
    """Every rung of both scripts' make_kernel, u16 and f32 planes, u8 and
    (form B) f32 outputs, at whole TPU tiles."""
    plane = _plane(*BASE, dt)
    scal = _frame(*BASE)[1]
    want = _jax_rung(form, variant, plane, scal, out_dt)
    _assert_contract(_port(form, variant, plane, scal, out_dt), want, out_dt)


@pytest.mark.parametrize("form,variant", [(f, v) for f in kv.FORMS for v in kv.VARIANTS])
def test_plain_matches_tpu_kernel_on_partial_tiles(form, variant):
    """A frame that is no multiple of the TPU tile (interpret mode masks the
    ragged blocks), u16 plane, u8 output."""
    plane = _plane(*PARTIAL, "u16")
    scal = _frame(*PARTIAL)[1]
    want = _jax_rung(form, variant, plane, scal, "u8")
    _assert_contract(_port(form, variant, plane, scal, "u8"), want, "u8")


@pytest.mark.parametrize("tile", [(96, 384), (32, 768), (64, 128)])
@pytest.mark.parametrize("dt", ["u16", "f32"])
def test_dma_floor_form_a_follows_the_tpu_tile(tile, dt):
    """dma_floor form A's output depends on the TPU tile: each tile's flag
    comes from its own first row. The zeroed samples flag the tile at
    (96, 384) as 0 at that tile shape, and no tile at the others."""
    plane = _plane(*BASE, dt)
    scal = _frame(*BASE)[1]
    want = _jax_rung("A", "dma_floor", plane, scal, "u8", tile)
    got = _port("A", "dma_floor", plane, scal, "u8", tile)
    _assert_contract(got, want, "u8")
    zero_tile = tile == (96, 384)
    assert (got[:, 96:192, 384:768] == 0).all() == zero_tile
    assert (got[1] == 2).sum() == got[1].numel() - (96 * 384 if zero_tile else 0)


@pytest.mark.parametrize("dt", ["u16", "f32"])
def test_full_f32_truncates_to_the_u8_rung(dt):
    """The float32 output of `full` is the u8 rung before its truncation:
    held to the JAX kernel through it (see the module docstring)."""
    plane = _plane(*BASE, dt)
    scal = _frame(*BASE)[1]
    f32 = _port("B", "full", plane, scal, "f32")
    u8 = _port("B", "full", plane, scal, "u8")
    assert f32.dtype == torch.float32 and f32.min() >= 0 and f32.max() <= 255
    assert torch.equal(f32.to(torch.int32).to(torch.uint8), u8)
    _assert_contract(u8, _jax_rung("B", "full", plane, scal, "u8"), "u8")


def test_variant_scal_matches_the_scripts():
    """variant_scal of the port's plan is the scripts' scal block of the
    JAX plan for the same RAW, bit for bit."""
    _, want = _frame(*BASE)
    raw = traw.synthetic_bayer(BASE[1], BASE[0], seed=3)
    plan = port_plan(tip.Pipeline.new_from_source(tip.ImageSource.from_raw(raw), "cpu"),
                     out_bits=8)
    got = kv.variant_scal(plan)
    assert got.dtype == np.float32 and got.shape == (8, 16)
    np.testing.assert_array_equal(got, want)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    plane = torch.from_numpy(_plane(*BASE, "u16"))
    scal = _frame(*BASE)[1]
    before = dict(kv.VARIANT_LAUNCHES)
    for variant in kv.VARIANTS:
        args = dict(height=BASE[0], width=BASE[1], variant=variant, form="B")
        assert torch.equal(kv.run_variant(plane, scal, **args), kv.variant_plain(plane, scal, **args))
    assert kv.VARIANT_LAUNCHES == before


@pytest.mark.parametrize("bad,match", [
    (dict(variant="tone"), "variant"),
    (dict(form="C"), "form"),
    (dict(form="A", out_dtype=torch.float32), "u8 only"),
    (dict(variant="demosaic", out_dtype=torch.float32), "u8 only"),
    (dict(out_dtype=torch.uint16), "out_dtype"),
    (dict(variant="dma_floor", form="A"), "tile"),
    (dict(tile=(96, 384)), "tile"),
    (dict(variant="dma_floor", form="A", tile=(0, 384)), "tile"),
    (dict(height=191), "plane"),
    (dict(scal=np.zeros((8, 8), np.float32)), "scal"),
])
def test_wrapper_refuses_what_no_kernel_defines(bad, match):
    args = dict(height=BASE[0], width=BASE[1], variant="levels", form="B",
                out_dtype=torch.uint8, tile=None, scal=_frame(*BASE)[1])
    args.update(bad)
    scal = args.pop("scal")
    with pytest.raises(ValueError, match=match):
        kv.run_variant(torch.from_numpy(_plane(*BASE, "u16")), scal, **args)


def test_wrapper_refuses_other_devices_and_plane_types():
    scal = _frame(*BASE)[1]
    args = dict(height=4, width=8, variant="levels", form="B")
    with pytest.raises(ValueError, match="unsupported device"):
        kv.run_variant(torch.zeros((4, 8), dtype=torch.float32, device="meta"), scal, **args)
    with pytest.raises(TypeError, match="plane dtype"):
        kv.run_variant(torch.zeros((4, 8), dtype=torch.int32), scal, **args)


def test_timing_script_runs_on_the_cpu():
    """scripts/torch_kernel_variants.py end to end through the plain
    versions at a tiny size: one JSON line per rung, then the develop row,
    then the summary line, each row with the keys the card's run prints."""
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_kernel_variants.py"),
                           "--device", "cpu", "--size", "256x64"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "cpu"
    rows = [json.loads(line) for line in lines[1:-1]]
    summary = json.loads(lines[-1])
    assert summary["rows"] == rows and summary["size"] == [256, 64]
    assert [r["exp"] for r in rows] == [
        f"{v}_{f}_{d}_{o}" for f, v, d, o in _rungs()] + ["develop"]
    keys = {"exp", "ms", "min_ms", "runs", "host_bound", "mp_s", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "clock", "card"}
    for r in rows:
        assert set(r) == keys and r["clock"] == "host" and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations")
        assert (r["library_ms"] is not None) == r["exp"].startswith("noop_B")


# -- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form,variant,dt,out_dt", _rungs())
@pytest.mark.parametrize("size", [BASE, PARTIAL, (67, 301)])
def test_kernel_matches_plain_on_card(card, size, form, variant, dt, out_dt):
    """Each rung's kernel against its plain version on the card, with one
    launch counted for its form; float32 outputs bit for bit."""
    plane = torch.from_numpy(_plane(*size, dt) if size != (67, 301) else
                             _plane(*BASE, dt)[:67, :301].copy()).to(card)
    scal = _frame(*BASE)[1]
    dtype = torch.uint8 if out_dt == "u8" else torch.float32
    args = dict(height=plane.shape[0], width=plane.shape[1], variant=variant, form=form,
                out_dtype=dtype, tile=TILE if (variant, form) == ("dma_floor", "A") else None)
    before = kv.VARIANT_LAUNCHES[form]
    got = kv.run_variant(plane, scal, **args)
    torch.cuda.synchronize()
    assert kv.VARIANT_LAUNCHES[form] == before + 1
    want = kv.variant_plain(plane, scal, **args)
    _assert_contract(got, want, out_dt)
    if out_dt == "f32":
        assert torch.equal(got, want)


if __name__ == "__main__":
    # The measured maxima of the plain version against the TPU kernels, every
    # rung at both frames, from the repository root:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_variants.py
    for size in (BASE, PARTIAL):
        for form, variant, dt, out_dt in _rungs():
            plane, scal = _plane(*size, dt), _frame(*size)[1]
            want = torch.from_numpy(_jax_rung(form, variant, plane, scal, out_dt))
            maxd, frac = kv.compare_variant(_port(form, variant, plane, scal, out_dt), want)
            print(f"{size[0]}x{size[1]} {variant}_{form}_{dt}_{out_dt}: max |diff| {maxd}, "
                  f"differing {frac:.3g}")
