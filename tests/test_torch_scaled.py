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
from imagepipe_tpu_torch.kernels import library

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


@pytest.mark.parametrize("k_x,want", [(4, 1), (7, 1), (8, 2), (11, 2), (20, 4), (39, 8),
                                      (151, 32), (401, 32), (1, 1)])
def test_window_split(k_x, want):
    """One lane below 8 window columns (-> 1024 and -> 2048 at 24 MP keep
    the plain version's order), then the most lanes, up to 32, that leave
    each at least 4 columns."""
    sx = kds.window_split(k_x)
    assert sx == want and sx & (sx - 1) == 0


def _geometry_plan(width, height, maxwidth, cfa_name="RGGB"):
    """The few plan fields the scaled kernel's host planning reads, for a
    width x height crop thumbnailed to `maxwidth` (no sensor data)."""
    from types import SimpleNamespace

    nh = max(1, round(height * maxwidth / width))
    return SimpleNamespace(mode="cfa", cfa_name=cfa_name, height=height, width=width,
                           dem_w=maxwidth, dem_h=nh)


GEOMETRIES = {   # (width, height, maxwidth, cfa): the main path's and the tests' deepest
    "24mp-2048": (6000, 4000, 2048, "RGGB"), "24mp-1024": (6000, 4000, 1024, "RGGB"),
    "24mp-320": (6000, 4000, 320, "RGGB"), "24mp-160": (6000, 4000, 160, "RGGB"),
    "24mp-16": (6000, 4000, 16, "RGGB"), "xtrans-1024": (6240, 4168, 1024, "xtrans"),
    "61mp-1024": (9504, 6336, 1024, "RGGB"), "600-16": (600, 400, 16, "RGGB"),
    "590-20": (590, 400, 20, "xtrans"), "600-33": (600, 400, 33, "RGGB"),
}


def _xtrans_name():
    return synthetic_xtrans(12, 12).cfa.name


@pytest.mark.parametrize("case", list(GEOMETRIES))
def test_scaled_plan_fits(case):
    """The launch plan fits in shared memory at every geometry, the deepest
    the tests reach included, fills a 256-thread block, and splits windows
    as window_split says."""
    w, h, maxwidth, cfa = GEOMETRIES[case]
    plan = _geometry_plan(w, h, maxwidth, _xtrans_name() if cfa == "xtrans" else cfa)
    lp = kds.scaled_plan(plan, 160)
    assert lp.smem <= library.MAX_SMEM
    assert lp.tc * lp.tr * lp.sx == kds.THREADS
    g = kds._host_geometry(plan)
    assert lp.kx == g["dx2"].shape[0] == int((g["to_x"] - g["from_x"]).max()) + 1
    assert lp.sx == kds.window_split(lp.kx)
    assert lp.smem == kds.scaled_smem_bytes(lp.tc, lp.tr, lp.kx, *kdev._pattern(plan).shape, 160)


def test_scaled_plan_raises_past_shared_memory():
    """A window too wide for one block's shared memory raises: no fallback."""
    plan = _geometry_plan(40000, 400, 2)
    with pytest.raises(ValueError, match="shared memory"):
        kds.scaled_plan(plan, 16)


def _lane_visits(ny, nx, sx):
    """(ky, kx) pairs the lanes visit, walking csrc/develop_scaled.cu's loops:
    every row, columns kx = lane (mod sx)."""
    return [(ky, kx) for lane in range(sx) for ky in range(ny) for kx in range(lane, nx, sx)]


@pytest.mark.parametrize("case", ["600-16", "590-20", "600-33", "24mp-160"])
def test_scaled_lanes_visit_each_window_sample_once(case):
    """Across its lanes, each output pixel's window is walked exactly once."""
    w, h, maxwidth, cfa = GEOMETRIES[case]
    plan = _geometry_plan(w, h, maxwidth, _xtrans_name() if cfa == "xtrans" else cfa)
    lp = kds.scaled_plan(plan, 16)
    g = kds._host_geometry(plan)
    assert lp.sx > 1
    for row in range(0, plan.dem_h, max(1, plan.dem_h // 7)):
        for col in range(0, plan.dem_w, max(1, plan.dem_w // 7)):
            ny = int(g["to_y"][row] - g["from_y"][row] + 1)
            nx = int(g["to_x"][col] - g["from_x"][col] + 1)
            visits = _lane_visits(ny, nx, lp.sx)
            assert sorted(visits) == [(ky, kx) for ky in range(ny) for kx in range(nx)]


def _kernel_rgbe(levels, g, pattern, lanes):
    """csrc/develop_scaled.cu's RGBE in numpy float32: each lane sums its
    columns of the window in ky-outer, kx-inner order, then the lanes' sums
    are added as the shuffle tree adds them."""
    nh, nw = len(g["from_y"]), len(g["from_x"])
    h, w = levels.shape
    ph, pw = pattern.shape
    sums = np.zeros((lanes, 4, nh, nw), np.float32)
    counts = np.zeros((lanes, 4, nh, nw), np.float32)
    for ky in range(g["dy2"].shape[0]):
        y = g["from_y"] + ky
        yc = np.minimum(y, h - 1)
        for kx in range(g["dx2"].shape[0]):
            x = g["from_x"] + kx
            xc = np.minimum(x, w - 1)
            valid = (y <= g["to_y"])[:, None] & (x <= g["to_x"])[None, :]
            wgt = (np.float32(1.0) - g["dx2"][kx])[None, :] - g["dy2"][ky][:, None]
            wgt = np.where(wgt < 0, np.float32(0.0), wgt).astype(np.float32)
            vw = (levels[np.ix_(yc, xc)] * wgt).astype(np.float32)
            colour = pattern[np.ix_(yc % ph, xc % pw)]
            lane = kx % lanes
            for c in range(4):
                sel = valid & (colour == c)
                sums[lane, c] = np.where(sel, sums[lane, c] + vw, sums[lane, c])
                counts[lane, c] = np.where(sel, counts[lane, c] + wgt, counts[lane, c])
    off = lanes // 2
    while off:
        sums[:off] = sums[:off] + sums[off:2 * off]
        counts[:off] = counts[:off] + counts[off:2 * off]
        off //= 2
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(counts[0] > 0, sums[0] / counts[0], np.float32(0.0)).astype(np.float32)


@pytest.mark.parametrize("maxwidth,kind", [(96, "bayer"), (40, "bayer"), (16, "bayer"),
                                           (20, "xtrans")])
def test_scaled_kernel_order_matches_plain(maxwidth, kind):
    """The scaled kernel's summation order, emulated: with one lane per pixel
    its RGBE equals the plain version's bit for bit; split across lanes it
    develops within the cross-path contract of the plain version."""
    from imagepipe_tpu_torch.raw import CFA as PortCFA
    from imagepipe_tpu_torch.scaling import scale_down_planar

    raw = KINDS[kind](590, 400, seed=11)
    tplan = tengine.plan_from_jax(_jax_plan(raw, maxwidth), "cpu")
    assert tplan.dem_path == "scaled"
    g = kds._host_geometry(tplan)
    lanes = kds.window_split(g["dx2"].shape[0])
    levels = np.random.default_rng(12).uniform(-0.05, 1.0, (tplan.height, tplan.width))
    levels = levels.astype(np.float32)
    cfa = PortCFA(tplan.cfa_name)
    got = _kernel_rgbe(levels, g, cfa.pattern, lanes)
    want = scale_down_planar(torch.from_numpy(levels)[None], tplan.dem_w, tplan.dem_h, 4,
                             cfa=cfa).numpy()
    if lanes == 1:
        np.testing.assert_array_equal(got, want)
        return
    assert np.abs(got - want).max() <= 1e-6
    params = tplan.params

    def finish(rgbe):
        return tengine.finish_planes(list(torch.from_numpy(rgbe)), params, out_bits=16,
                                     linear=False, apply_curve=False, n_knots=0,
                                     orientation_flips=(False, False, False), numerics="direct")
    _assert_contract(finish(got), finish(want))


def test_build_key_covers_every_source_and_header(tmp_path):
    """An edit to any csrc/*.cu or *.cuh (or a new one) changes the library's
    key, so a stale build is never reused. Needs no nvcc."""
    import shutil

    csrc = library._CSRC
    names = sorted(p.name for p in csrc.iterdir() if p.suffix in (".cu", ".cuh"))
    assert {"develop.cu", "develop_scaled.cu", "finish.cuh"} <= set(names)
    shutil.copytree(csrc, tmp_path / "csrc")
    copy = tmp_path / "csrc"
    base = library.build_key(copy)
    assert base == library.build_key(csrc)
    keys = {base}
    for name in names:
        f = copy / name
        data = f.read_bytes()
        f.write_bytes(data + b"\n// edit\n")
        keys.add(library.build_key(copy))
        f.write_bytes(data)
        assert library.build_key(copy) == base
    (copy / "extra.cuh").write_text("#pragma once\n")
    keys.add(library.build_key(copy))
    assert len(keys) == len(names) + 2


# -- on the card ----------------------------------------------------------

def _rotated():
    raw = synthetic_bayer(600, 400, seed=8)
    raw.orientation = Orientation.Rotate90
    return raw


def _cropped(make=synthetic_bayer):
    raw = make(606, 410, seed=9)
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
    "bayer-33": (lambda: synthetic_bayer(600, 400), 33, 8),      # a 1-column block tile
    "xtrans-cropped-20": (lambda: _cropped(synthetic_xtrans), 20, 8),
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
    from imagepipe_tpu_torch import raw as traw
    from imagepipe_tpu_torch.sources import ImageSource as PortSource

    make = {"bayer": traw.synthetic_bayer, "xtrans": traw.synthetic_xtrans,
            "mono": traw.synthetic_mono, "rgb": traw.synthetic_linear}[kind]
    src = PortSource.from_raw(make(480, 320))
    card = tip.Pipeline.new_from_source(src, device="cuda")
    cpu = tip.Pipeline.new_from_source(src, device="cpu")
    for p in (card, cpu):
        p.globals.settings.maxwidth = maxwidth
    full, before = kdev.LAUNCHES, kds.LAUNCHES
    got = card.output_8bit().data
    assert (kds.LAUNCHES - before, kdev.LAUNCHES - full) == (scaled, 0)
    # The CPU pipeline runs 'lut' numerics, the card 'direct': <= 1 LSB apart.
    _assert_contract(got, cpu.output_8bit().data)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bayer-100", "bayer-16", "bayer-100-16bit", "xtrans-100",
                                  "rotate90-100", "bayer-33", "xtrans-cropped-20"])
def test_batch_kernel_matches_single_launches_on_card(case):
    """One batched launch (shared geometry, per-image calibration) equals B
    single launches bit for bit and holds the plain version's contract."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    make, maxwidth, bits = CARD_CASES[case]
    raws = [make() for _ in range(3)]
    for i, raw in enumerate(raws):
        raw.wb_coeffs = (1.0 + 0.15 * i, 1.0, 2.0 + 0.3 * i, float("nan"))
    plans = [tengine.plan_from_jax(_jax_plan(raw, maxwidth, bits), "cuda") for raw in raws]
    planes = torch.from_numpy(np.stack([raw.data for raw in raws])).cuda()
    before = kds.BATCH_LAUNCHES
    got = kds.develop_scaled_batch(plans, planes)
    torch.cuda.synchronize()
    assert kds.BATCH_LAUNCHES == before + 1
    for i, plan in enumerate(plans):
        assert torch.equal(got[i], kds.develop_scaled(plan, planes[i]))
    _assert_contract(got, kds.develop_scaled_batch_plain(plans, planes))
    assert not torch.equal(got[0], got[2])
