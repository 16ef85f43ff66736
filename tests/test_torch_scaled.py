"""PyTorch port: the thumbnail develop (maxwidth / maxheight) against the JAX
package, and the scaled-demosaic kernel's wrapper, plain version and inputs.

* The eager engine's resize paths ('scaled', 'fulldown', 'plaindown')
  against the JAX package's `develop_fused` on the same plan
  (`plan_from_jax`), for 8 and 16 bit, 'lut' and 'direct' numerics, Bayer,
  X-Trans, mono and rgb, one Rotate90 and one odd-crop frame.
* `develop_scaled_plain`, the plain version of csrc/develop_scaled.cu,
  against the Pallas kernels it replaces, run in interpret mode as
  tests/test_scaled.py runs them: one single-pass geometry (600x400 -> 96
  wide) and one chunked one (600x400 -> 36 wide, windows of 19-20; deeper
  chunked geometries only cost more interpret time).
* The kernel's inputs: the per-offset weights, colours and counts rebuilt
  from the port's separable tables equal the Pallas kernels' own
  (`_build_geometry`) exactly.

Contract for developed output: max |diff| <= 1 LSB and under 2% of values
differing (kernels/develop.py MAX_LSB, MAX_FLIP_FRACTION). The CUDA kernel
itself is compared with its plain version on the card by the `cuda`-marked
tests below (`python -m pytest tests/test_torch_scaled.py -m cuda` on a
machine with an NVIDIA GPU) and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource, Pipeline
from imagepipe_tpu.engine import develop_fused, make_develop_plan
from imagepipe_tpu.kernels import develop_pallas as jdp
from imagepipe_tpu.kernels import develop_scaled as jds
from imagepipe_tpu.raw import (CFA, Orientation, synthetic_bayer, synthetic_linear,
                               synthetic_mono, synthetic_xtrans)
from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KINDS = {"bayer": synthetic_bayer, "xtrans": synthetic_xtrans,
         "mono": synthetic_mono, "rgb": synthetic_linear}
# (kind, maxwidth) of a 480x320 frame for each resize path.
PATHS = {"scaled": [("bayer", 96), ("xtrans", 72)],
         "fulldown": [("bayer", 300), ("xtrans", 200)],
         "plaindown": [("mono", 200), ("rgb", 96)]}


def _jax_plan(raw, maxwidth, bits=8, numerics="direct", maxheight=0):
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.maxwidth = maxwidth
    p.globals.settings.maxheight = maxheight
    p.globals.settings.linear = bits == 16
    return make_develop_plan(p, out_bits=bits, numerics=numerics)


def _plane(raw):
    return torch.from_numpy(np.ascontiguousarray(raw.data))


def _assert_contract(got, want):
    maxd, frac = kdev.compare(got, want)
    assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)


def _engine_case(raw, maxwidth, bits, numerics, dem_path, maxheight=0):
    plan = _jax_plan(raw, maxwidth, bits, numerics, maxheight)
    assert plan.dem_path == dem_path
    want = np.asarray(develop_fused(plan, raw.data))
    got = tengine.develop_fused(tengine.plan_from_jax(plan, "cpu"), _plane(raw))
    assert got.shape == want.shape
    _assert_contract(got, want)
    return plan, got


@pytest.mark.parametrize("numerics", ["lut", "direct"])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("case", [f"{p}-{i}" for p in PATHS for i in range(2)])
def test_resize_paths_match_jax(case, bits, numerics):
    dem_path, i = case.split("-")
    kind, maxwidth = PATHS[dem_path][int(i)]
    raw = KINDS[kind](480, 320, seed=3)
    plan, got = _engine_case(raw, maxwidth, bits, numerics, dem_path)
    assert got.shape == (3, plan.dem_h, maxwidth)


def test_scaled_rotate90_matches_jax():
    raw = synthetic_bayer(480, 320, seed=4)
    raw.orientation = Orientation.Rotate90
    plan, got = _engine_case(raw, 0, 8, "direct", "scaled", maxheight=60)
    assert got.shape == (3, plan.dem_w, plan.dem_h) == (3, 60, 40)   # transposed


@pytest.mark.parametrize("kind", ["bayer", "xtrans"])
def test_scaled_odd_crop_matches_jax(kind):
    raw = KINDS[kind](486, 330, seed=5)
    raw.crops = (3, 5, 7, 11)          # odd origin re-anchors the CFA
    plan, _ = _engine_case(raw, 80, 8, "direct", "scaled")
    assert (plan.crop_x, plan.crop_y) == (11, 3)


@pytest.mark.parametrize("maxwidth", [96, 36], ids=["single-pass", "chunked"])
def test_plain_matches_pallas_interpret(maxwidth):
    raw = synthetic_bayer(600, 400, seed=6)
    plan = _jax_plan(raw, maxwidth)
    sp = jds.scaled_plan_for(plan)
    assert sp is not None and bool(sp.statics.get("chunked")) == (maxwidth == 36)
    want = np.asarray(jdp.develop_pallas(plan, raw.data, interpret=True))
    tplan = tengine.plan_from_jax(plan, "cpu")
    got = kds.develop_scaled_plain(tplan, _plane(raw))
    _assert_contract(got, want)
    # On a CPU tensor the wrapper is the plain version, and launches nothing.
    before = kds.LAUNCHES
    np.testing.assert_array_equal(kds.develop_scaled(tplan, _plane(raw)).numpy(),
                                  got.numpy())
    assert kds.LAUNCHES == before


def _per_offset_tables(geom, pattern, height, width):
    """w_off, col_off [K_y*K_x, nh, nw] and cnt [4, nh, nw], rebuilt from the
    separable tables the CUDA kernel receives, in its ky-outer, kx-inner
    order."""
    g = {k: v.numpy() for k, v in geom.items()}
    k_y, k_x = g["dy2"].shape[0], g["dx2"].shape[0]
    ph, pw = pattern.shape
    nh, nw = g["dy2"].shape[1], g["dx2"].shape[1]
    w_off = np.zeros((k_y * k_x, nh, nw), np.float32)
    col_off = np.zeros((k_y * k_x, nh, nw), np.uint8)
    cnt = np.zeros((4, nh, nw), np.float32)
    for ky in range(k_y):
        y = g["from_y"] + ky
        for kx in range(k_x):
            x = g["from_x"] + kx
            w = (np.float32(1.0) - g["dx2"][kx])[None, :] - g["dy2"][ky][:, None]
            w = np.where(w < 0.0, np.float32(0.0), w)
            valid = (y <= g["to_y"])[:, None] & (x <= g["to_x"])[None, :]
            w = np.where(valid, w, np.float32(0.0)).astype(np.float32)
            color = pattern[np.ix_(np.minimum(y, height - 1) % ph,
                                   np.minimum(x, width - 1) % pw)]
            w_off[ky * k_x + kx] = w
            col_off[ky * k_x + kx] = color
            for c in range(4):
                cnt[c] += w * (color == c).astype(np.float32)
    return w_off, col_off, cnt


@pytest.mark.parametrize("kind,maxwidth", [("bayer", 96), ("xtrans", 96), ("bayer", 24)],
                         ids=["bayer-single-pass", "xtrans-single-pass", "bayer-chunked"])
def test_geometry_tables_equal_pallas(kind, maxwidth):
    raw = KINDS[kind](600, 400, seed=7)
    plan = _jax_plan(raw, maxwidth)
    sp = jds._build_geometry(plan)
    tplan = tengine.plan_from_jax(plan, "cpu")
    geom = kds.scaled_geometry(tplan)
    assert kds.scaled_geometry(tplan) is geom        # memoized on the plan
    nh, nw = plan.dem_h, plan.dem_w
    st = sp.statics
    k_y, k_x = geom["dy2"].shape[0], geom["dx2"].shape[0]
    w_off, col_off, cnt = _per_offset_tables(geom, CFA(plan.cfa_name).pattern,
                                             plan.height, plan.width)
    if st.get("chunked"):
        # [nkx, K_y*CKX, ...] chunk-major; padded offsets carry no weight.
        ckx, nkx = st["CKX"], st["nkx"]
        assert nkx * ckx >= k_x and st["K_y"] == k_y
        kx = np.arange(k_x)
        want_w = np.stack([sp.w_off[kx // ckx, ky * ckx + kx % ckx] for ky in range(k_y)])
        want_c = np.stack([sp.col_off[kx // ckx, ky * ckx + kx % ckx] for ky in range(k_y)])
        want_w = want_w.reshape(k_y * k_x, *want_w.shape[2:])
        want_c = want_c.reshape(k_y * k_x, *want_c.shape[2:])
    else:
        assert (st["K_y"], st["K_x"]) == (k_y, k_x)
        want_w, want_c = sp.w_off, sp.col_off
    np.testing.assert_array_equal(w_off, want_w[:, :nh, :nw])
    np.testing.assert_array_equal(col_off, want_c[:, :nh, :nw])
    np.testing.assert_array_equal(cnt, sp.cnt[:, :nh, :nw])


@pytest.mark.parametrize("kind,maxwidth,supported", [
    ("bayer", 96, True), ("xtrans", 72, True), ("bayer", 12, True),   # beyond the Pallas envelope
    ("bayer", 300, False), ("bayer", 0, False), ("mono", 96, False), ("rgb", 96, False)])
def test_scaled_supported(kind, maxwidth, supported):
    plan = _jax_plan(KINDS[kind](480, 320), maxwidth)
    tplan = tengine.plan_from_jax(plan, "cpu")
    assert kds.scaled_supported(tplan) == supported
    assert not kdev.kernel_supported(tplan) or plan.dem_path == "full"


def test_wrapper_rejects_what_the_kernel_does_not_take():
    raw = synthetic_bayer(480, 320)
    tplan = tengine.plan_from_jax(_jax_plan(raw, 96), "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        kds.develop_scaled(tplan, torch.empty((320, 480), device="meta"))


def test_build_key_covers_every_source_and_header(tmp_path):
    """An edit to any csrc/*.cu or *.cuh (or a new one) changes the library's
    key, so a stale build is never reused. Needs no nvcc."""
    import shutil

    csrc = kdev._CSRC
    names = sorted(p.name for p in csrc.iterdir() if p.suffix in (".cu", ".cuh"))
    assert {"develop.cu", "develop_scaled.cu", "finish.cuh"} <= set(names)
    shutil.copytree(csrc, tmp_path / "csrc")
    copy = tmp_path / "csrc"
    base = kdev.build_key(copy)
    assert base == kdev.build_key(csrc)
    keys = {base}
    for name in names:
        f = copy / name
        data = f.read_bytes()
        f.write_bytes(data + b"\n// edit\n")
        keys.add(kdev.build_key(copy))
        f.write_bytes(data)
        assert kdev.build_key(copy) == base
    (copy / "extra.cuh").write_text("#pragma once\n")
    keys.add(kdev.build_key(copy))
    assert len(keys) == len(names) + 2


# -- on the card ----------------------------------------------------------

def _rotated():
    raw = synthetic_bayer(600, 400, seed=8)
    raw.orientation = Orientation.Rotate90
    return raw


def _cropped():
    raw = synthetic_bayer(606, 410, seed=9)
    raw.crops = (3, 5, 7, 11)
    return raw


def _float_plane():
    raw = synthetic_bayer(600, 400, seed=10)
    raw.data = raw.data.astype(np.float32)
    return raw


CARD_CASES = {   # (raw, maxwidth, bits), chip_smoke.py phase 1 at small size
    "bayer-300": (lambda: synthetic_bayer(600, 400), 300, 8),
    "bayer-100": (lambda: synthetic_bayer(600, 400), 100, 8),
    "bayer-32": (lambda: synthetic_bayer(600, 400), 32, 8),
    "bayer-16": (lambda: synthetic_bayer(600, 400), 16, 8),
    "bayer-100-16bit": (lambda: synthetic_bayer(600, 400), 100, 16),
    "xtrans-100": (lambda: synthetic_xtrans(624, 416), 100, 8),
    "rotate90-100": (_rotated, 100, 8),
    "cropped-100": (_cropped, 100, 8),
    "float-100": (_float_plane, 100, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    make, maxwidth, bits = CARD_CASES[case]
    raw = make()
    tplan = tengine.plan_from_jax(_jax_plan(raw, maxwidth, bits), "cuda")
    plane = _plane(raw).cuda()
    before = kds.LAUNCHES
    got = kds.develop_scaled(tplan, plane)
    torch.cuda.synchronize()
    assert kds.LAUNCHES == before + 1
    _assert_contract(got, kds.develop_scaled_plain(tplan, plane))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,maxwidth,scaled", [("bayer", 96, 1), ("xtrans", 72, 1),
                                                  ("bayer", 300, 0), ("mono", 96, 0),
                                                  ("rgb", 96, 0)])
def test_pipeline_thumbnail_routing_on_card(kind, maxwidth, scaled):
    """On CUDA a 'scaled' thumbnail launches the scaled kernel once and the
    full-size kernel never; 'fulldown' and 'plaindown' run the eager engine
    on the card and launch neither."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    import imagepipe_tpu_torch as tip
    from imagepipe_tpu_torch import _host

    make = {"bayer": _host.synthetic_bayer, "xtrans": _host.synthetic_xtrans,
            "mono": _host.synthetic_mono, "rgb": _host.synthetic_linear}[kind]
    src = _host.ImageSource.from_raw(make(480, 320))
    card = tip.Pipeline.new_from_source(src, device="cuda")
    cpu = tip.Pipeline.new_from_source(src, device="cpu")
    for p in (card, cpu):
        p.globals.settings.maxwidth = maxwidth
    full, before = kdev.LAUNCHES, kds.LAUNCHES
    got = card.output_8bit().data
    assert (kds.LAUNCHES - before, kdev.LAUNCHES - full) == (scaled, 0)
    # The CPU pipeline runs 'lut' numerics, the card 'direct': <= 1 LSB apart.
    _assert_contract(got, cpu.output_8bit().data)
