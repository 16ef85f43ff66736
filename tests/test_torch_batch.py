"""PyTorch port: the batch engine and the batched kernels' wrappers on the CPU.

* `imagepipe_tpu_torch.parallel.BatchEngine(devices=["cpu"])` against
  `imagepipe_tpu.parallel.BatchEngine` on the same inputs (both packages'
  synthetic generators give the same RawImage for a seed; files are written
  once and decoded by each package): sharded and odd-count batches, files,
  the error policy, the inflight bound, executor routing, decode/compute
  overlap, thumbnails and per-image calibration, as tests/test_engine.py
  runs the JAX engine.
* `develop_batch` / `develop_scaled_batch` on CPU tensors (their plain
  versions) against the JAX package's batched Pallas kernels in interpret
  mode with per-image plans, as tests/test_pallas.py and tests/test_scaled.py
  run them; `engine.develop_batch_perimage` against
  `_develop_batch_perimage_jit`.

Contract: max |diff| <= 1 LSB and under 2% of values differing against the
JAX package; bit-equal to the port's own single-image develop on the CPU.
The kernels themselves are compared on the card by the `cuda`-marked tests
of tests/test_torch_develop_kernel.py and test_torch_scaled.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource as JSource
from imagepipe_tpu import Pipeline as JPipeline
from imagepipe_tpu import raw as jraw
from imagepipe_tpu.decode import save_synraw
from imagepipe_tpu.engine import _develop_batch_perimage_jit, make_develop_plan, stack_params
from imagepipe_tpu.kernels import develop_pallas as jdp
from imagepipe_tpu.kernels import develop_scaled as jds
from imagepipe_tpu.parallel import BatchEngine as JBatchEngine
from imagepipe_tpu.parallel import make_batch_mesh
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds
from imagepipe_tpu_torch.parallel import BatchEngine, BatchError
from imagepipe_tpu_torch.sources import ImageSource as TSource

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _pair(make, width, height, seed, wb=None, orientation=None, crops=None):
    """The same RawImage from the JAX package's generator and the port's."""
    raws = getattr(jraw, make)(width, height, seed=seed), getattr(traw, make)(width, height, seed=seed)
    for r, mod in zip(raws, (jraw, traw)):
        if wb is not None:
            r.wb_coeffs = wb
        if orientation is not None:
            r.orientation = mod.Orientation(orientation)
        if crops is not None:
            r.crops = crops
    return raws


def _assert_contract(got, want):
    maxd, frac = kdev.compare(got, want)
    assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)


def _port_single(raw, bits=8, maxwidth=0, maxheight=0):
    """The port's single-image develop of `raw` on the CPU, [H', W', 3]."""
    p = tip.Pipeline.new_from_source(TSource.from_raw(raw), device="cpu")
    p.globals.settings.maxwidth, p.globals.settings.maxheight = maxwidth, maxheight
    return (p.output_8bit() if bits == 8 else p.output_16bit()).data


def _check_against_both(outs, jouts, traws, bits=8, maxwidth=0, maxheight=0):
    assert len(outs) == len(jouts) == len(traws)
    for out, jout, raw in zip(outs, jouts, traws):
        _assert_contract(out, jout)
        np.testing.assert_array_equal(out, _port_single(raw, bits, maxwidth, maxheight))


class _DirectPort(BatchEngine):
    def _plan_for(self, source):
        pipe = tip.Pipeline.new_from_source(source, device="cpu")
        pipe.globals.settings.maxwidth, pipe.globals.settings.maxheight = self.maxwidth, self.maxheight
        return tengine.make_develop_plan(pipe, out_bits=self.out_bits, numerics="direct")


class _DirectJax(JBatchEngine):
    def _plan_for(self, source):
        pipe = JPipeline.new_from_source(source)
        pipe.globals.settings.maxwidth, pipe.globals.settings.maxheight = self.maxwidth, self.maxheight
        return make_develop_plan(pipe, out_bits=self.out_bits, numerics="direct")


# -- the engine against the JAX package's --------------------------------

@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]], ids=["one", "round-robin"])
def test_batch_engine_sharded_develop(devices):
    """An odd count over max_batch 4, on one device and round-robin over
    two: equal to the JAX engine on its 8-device mesh within the contract,
    and bit-equal to single-image develops."""
    pairs = [_pair("synthetic_bayer", 96, 64, s) for s in range(9)]
    outs = BatchEngine(devices=devices, max_batch=4).develop_sources(
        [TSource.from_raw(t) for _, t in pairs])
    jouts = JBatchEngine(make_batch_mesh(), max_batch=4).develop_sources(
        [JSource.from_raw(j) for j, _ in pairs])
    _check_against_both(outs, jouts, [t for _, t in pairs])
    assert not any(np.shares_memory(a, b) for a, b in zip(outs, outs[1:]))


@pytest.mark.parametrize("bits", [8, 16])
def test_batch_engine_files(tmp_path, bits):
    paths = []
    for s in range(3):
        path = str(tmp_path / f"r{s}.synraw.npz")
        save_synraw(path, jraw.synthetic_bayer(96, 64, seed=10 + s))
        paths.append(path)
    outs = BatchEngine(devices=["cpu"], max_batch=8, out_bits=bits).develop_files(paths)
    jouts = JBatchEngine(max_batch=8, out_bits=bits).develop_files(paths)
    assert all(o.shape == (64, 96, 3) and o.dtype == (np.uint8 if bits == 8 else np.uint16)
               for o in outs)
    assert not np.array_equal(outs[0], outs[1])
    _check_against_both(outs, jouts, [traw.synthetic_bayer(96, 64, seed=10 + s)
                                      for s in range(3)], bits)


def test_batch_engine_error_policy(tmp_path):
    """One corrupt file among good ones: errors='skip' marks its slot with a
    falsy BatchError and completes the rest; errors='raise' aborts."""
    paths = []
    for s in range(3):
        path = str(tmp_path / f"g{s}.synraw.npz")
        save_synraw(path, jraw.synthetic_bayer(96, 64, seed=20 + s))
        paths.append(path)
    bad = tmp_path / "corrupt.synraw.npz"
    bad.write_bytes(b"not a raw file at all")
    paths.insert(1, str(bad))

    eng = BatchEngine(devices=["cpu"], max_batch=2)
    eng._events = []
    outs = eng.develop_files(paths, errors="skip")
    jouts = JBatchEngine(max_batch=2).develop_files(paths, errors="skip")
    assert len(outs) == 4
    assert isinstance(outs[1], BatchError) and not outs[1]
    assert outs[1].path == str(bad) and "BatchError" in repr(outs[1])
    assert not jouts[1]
    assert [k for k, _ in eng._events].count("error") == 1
    for i in (0, 2, 3):
        assert isinstance(outs[i], np.ndarray) and outs[i].shape == (64, 96, 3)
        _assert_contract(outs[i], jouts[i])

    with pytest.raises(Exception):
        BatchEngine(devices=["cpu"], max_batch=2).develop_files(paths)  # default: raise
    with pytest.raises(ValueError, match="errors"):
        eng.develop_files(paths, errors="ignore")


@pytest.mark.parametrize("inflight", [1, 2])
def test_batch_engine_inflight_bound(inflight):
    """Dispatched-but-unfetched chunks never exceed inflight_batches (+1,
    the one just dispatched), for full buckets and the mixed-shape tail."""
    sources = [TSource.from_raw(traw.synthetic_bayer(48 + 24 * (s % 3), 48, seed=s))
               for s in range(9)]
    eng = BatchEngine(devices=["cpu"], max_batch=2, inflight_batches=inflight)
    eng._events = []
    outs = eng.develop_sources(sources)
    assert all(o is not None for o in outs)
    live = peak = 0
    for event, _ in eng._events:
        if event == "dispatch":
            live += 1
            peak = max(peak, live)
        elif event == "collected":
            live -= 1
    assert live == 0
    assert peak == inflight + 1, peak
    assert [k for k, _ in eng._events].count("dispatch") == 6   # 3 shapes x ceil(3/2)


ROUTES = {   # (executor, numerics, kind, maxwidth of a 192x128 frame) -> batched kernel?
    "auto-bayer": ("auto", "direct", "synthetic_bayer", 0, True),
    "auto-xtrans": ("auto", "direct", "synthetic_xtrans", 0, True),
    "auto-mono": ("auto", "direct", "synthetic_mono", 0, True),
    "auto-rgb": ("auto", "direct", "synthetic_linear", 0, False),
    "auto-scaled": ("auto", "direct", "synthetic_bayer", 64, True),
    "auto-fulldown": ("auto", "direct", "synthetic_bayer", 150, False),
    "kernel-scaled": ("kernel", "direct", "synthetic_bayer", 64, True),
    "eager-bayer": ("eager", "direct", "synthetic_bayer", 0, False),
    "auto-lut": ("auto", "lut", "synthetic_bayer", 0, False),
}
_JAX_EXECUTOR = {"auto": "auto", "kernel": "pallas", "eager": "xla"}


@pytest.mark.parametrize("case", list(ROUTES))
def test_batch_engine_executor_routing(case):
    """Routing by plan, as `_use_pallas` of the JAX package routes."""
    executor, numerics, make, maxwidth, want = ROUTES[case]
    j, t = _pair(make, 192, 128, 1)
    port = (_DirectPort if numerics == "direct" else BatchEngine)(
        devices=["cpu"], executor=executor, maxwidth=maxwidth)
    jeng = (_DirectJax if numerics == "direct" else JBatchEngine)(
        make_batch_mesh(), executor=_JAX_EXECUTOR[executor], maxwidth=maxwidth)
    plan = port._plan_for(TSource.from_raw(t))
    assert plan.numerics == numerics
    assert port._use_kernel(plan) == want
    assert jeng._use_pallas(jeng._plan_for(JSource.from_raw(j))) == want


def test_batch_engine_kernel_executor_matches_pallas():
    """The kernel route on the CPU (the batched wrappers' plain versions)
    against the JAX engine's Pallas executor in interpret mode, with
    per-image calibration."""
    pairs = [_pair("synthetic_bayer", 96, 64, 60 + s) for s in range(4)]
    pairs[3] = _pair("synthetic_bayer", 96, 64, 63, wb=(1.0, 1.0, 2.8, float("nan")))
    port = _DirectPort(devices=["cpu"], max_batch=8, executor="kernel")
    assert port._use_kernel(port._plan_for(TSource.from_raw(pairs[0][1])))
    outs = port.develop_sources([TSource.from_raw(t) for _, t in pairs])
    jouts = _DirectJax(make_batch_mesh(), max_batch=8, executor="pallas").develop_sources(
        [JSource.from_raw(j) for j, _ in pairs])
    for out, jout, (_, t) in zip(outs, jouts, pairs):
        _assert_contract(out, jout)
        plan = port._plan_for(TSource.from_raw(t))
        want = kdev.develop(plan, torch.from_numpy(t.data))
        np.testing.assert_array_equal(out, want.permute(1, 2, 0).numpy())
    assert not np.array_equal(outs[0], outs[3])


def test_batch_engine_decode_compute_overlap(tmp_path):
    """develop_files streams: full buckets are dispatched while later files
    are still decoding, and results come back in input order."""
    paths = []
    for s in range(6):
        path = str(tmp_path / f"r{s}.synraw.npz")
        save_synraw(path, jraw.synthetic_bayer(96, 64, seed=50 + s))
        paths.append(path)
    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=2)
    eng._events = []
    outs = eng.develop_files(paths)
    kinds = [k for k, _ in eng._events]
    assert kinds.count("decoded") == 6 and kinds.count("dispatch") == 3
    first_dispatch = kinds.index("dispatch")
    last_decode = len(kinds) - 1 - kinds[::-1].index("decoded")
    assert first_dispatch < last_decode, kinds
    for s, out in enumerate(outs):
        np.testing.assert_array_equal(out, _port_single(traw.synthetic_bayer(96, 64, seed=50 + s)))
    assert set(eng.timings) >= {"decode", "plan", "stage", "dispatch", "wait", "scatter"}


@pytest.mark.parametrize("maxsize", [(64, 64), (0, 50)])
def test_batch_engine_thumbnails(maxsize):
    """Batched maxsize-constrained develop ('scaled' plans)."""
    pairs = [_pair("synthetic_bayer", 192, 128, 20 + s) for s in range(5)]
    outs = BatchEngine(devices=["cpu"], max_batch=4, maxwidth=maxsize[0],
                       maxheight=maxsize[1]).develop_sources([TSource.from_raw(t) for _, t in pairs])
    jouts = JBatchEngine(make_batch_mesh(), max_batch=4, maxwidth=maxsize[0],
                         maxheight=maxsize[1]).develop_sources([JSource.from_raw(j) for j, _ in pairs])
    assert all(o.shape[1] <= (maxsize[0] or 192) and o.shape[0] <= (maxsize[1] or 128)
               for o in outs)
    _check_against_both(outs, jouts, [t for _, t in pairs], 8, *maxsize)


@pytest.mark.parametrize("orientation", ["Normal", "Rotate90"])
def test_batch_engine_per_image_calibration(orientation):
    """Same-shape images with different white balance each develop with
    their own calibration."""
    pairs = [_pair("synthetic_bayer", 96, 64, 40, orientation=orientation),
             _pair("synthetic_bayer", 96, 64, 40, orientation=orientation,
                   wb=(1.0, 1.0, 3.0, float("nan")))]
    outs = BatchEngine(devices=["cpu"], max_batch=4).develop_sources(
        [TSource.from_raw(t) for _, t in pairs])
    jouts = JBatchEngine(make_batch_mesh(), max_batch=4).develop_sources(
        [JSource.from_raw(j) for j, _ in pairs])
    assert not np.array_equal(outs[0], outs[1])
    _check_against_both(outs, jouts, [t for _, t in pairs])


def test_jax_engine_fails_on_mixed_sensor_sizes():
    """Two sensor sizes whose crops give equal statics: the JAX engine's XLA
    route stacks them into one array and fails (ROADMAP C); the port keys
    its buckets by the plane's shape too and develops both."""
    pairs = [_pair("synthetic_bayer", 96, 64, 1),
             _pair("synthetic_bayer", 100, 64, 2, crops=(0, 4, 0, 0))]
    jeng = JBatchEngine(make_batch_mesh(), max_batch=4)
    jplans = [jeng._plan_for(JSource.from_raw(j)) for j, _ in pairs]
    assert jplans[0].statics() == jplans[1].statics()
    with pytest.raises(ValueError, match="same shape"):
        jeng.develop_sources([JSource.from_raw(j) for j, _ in pairs])
    eng = BatchEngine(devices=["cpu"], max_batch=4)
    eng._events = []
    outs = eng.develop_sources([TSource.from_raw(t) for _, t in pairs])
    assert [k for k, _ in eng._events].count("dispatch") == 2
    for out, (_, t) in zip(outs, pairs):
        np.testing.assert_array_equal(out, _port_single(t))


def test_batch_engine_needs_a_device_or_cuda():
    """No devices given means every CUDA device; without one it raises. A
    spatial axis raises naming ROADMAP A11; devices of mixed types and an
    unknown executor are refused."""
    if torch.cuda.is_available():
        assert BatchEngine().devices == [torch.device("cuda", i)
                                         for i in range(torch.cuda.device_count())]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchEngine()
    assert BatchEngine(devices=["cpu"]).numerics == "lut"
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        BatchEngine(devices=["cpu"], spatial=2)
    with pytest.raises(ValueError, match="one type"):
        BatchEngine(devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="executor"):
        BatchEngine(devices=["cpu"], executor="xla")


def test_entry_points_default_to_cuda(tmp_path):
    """`default_device()` is the first CUDA device and never the CPU: with
    no CUDA device the entry points raise unless given device='cpu'."""
    from imagepipe_tpu_torch import cli, dng

    path = str(tmp_path / "f.dng")
    dng.write_dng(path, traw.synthetic_bayer(64, 48, seed=3))
    if torch.cuda.is_available():
        assert tip.default_device() == torch.device("cuda", 0)
    else:
        for call in (tip.default_device, lambda: tip.Pipeline.new_from_file(path),
                     lambda: tip.simple_decode_8bit(path),
                     lambda: tip.Pipeline.new_from_source(TSource.from_raw(traw.synthetic_bayer(64, 48)))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        assert cli.main(["converter", path]) == 2
    assert tip.Pipeline.new_from_file(path, device="cpu").device == torch.device("cpu")
    assert tip.simple_decode_8bit(path, device="cpu").data.shape == (48, 64, 3)
    assert cli.main(["converter", path], device="cpu") == 0


# -- the batched kernels' wrappers and the eager batch --------------------

def _jax_plans(raws, bits=8, maxwidth=0, numerics="direct"):
    plans = []
    for r in raws:
        p = JPipeline.new_from_source(JSource.from_raw(r))
        p.globals.settings.maxwidth = maxwidth
        p.globals.settings.linear = bits == 16
        plans.append(make_develop_plan(p, out_bits=bits, numerics=numerics))
    return plans


BATCH_CASES = {   # (generator, orientation, bits) of three 168x112 frames
    "bayer8": ("synthetic_bayer", None, 8),
    "bayer16": ("synthetic_bayer", None, 16),
    "xtrans8": ("synthetic_xtrans", None, 8),
    "rotate90": ("synthetic_bayer", "Rotate90", 8),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_develop_batch_matches_pallas_batch(case):
    make, orientation, bits = BATCH_CASES[case]
    pairs = [_pair(make, 168, 112, s, orientation=orientation) for s in range(3)]
    pairs[2] = _pair(make, 168, 112, 2, orientation=orientation, wb=(1.1, 1.0, 2.6, float("nan")))
    jplans = _jax_plans([j for j, _ in pairs], bits)
    batch = np.stack([j.data for j, _ in pairs])
    want = np.asarray(jdp.develop_pallas_batch(jplans[0], batch, interpret=True,
                                               param_plans=jplans))
    plans = [tengine.plan_from_jax(p, "cpu") for p in jplans]
    planes = torch.from_numpy(batch)
    before = kdev.BATCH_LAUNCHES
    got = kdev.develop_batch(plans, planes)
    assert kdev.BATCH_LAUNCHES == before          # on the CPU: the plain version
    assert got.shape == want.shape
    _assert_contract(got, want)
    for i, plan in enumerate(plans):
        np.testing.assert_array_equal(got[i].numpy(), kdev.develop(plan, planes[i]).numpy())
    assert not np.array_equal(got[1].numpy(), got[2].numpy())


SCALED_CASES = {   # (generator, bits, maxwidth) of two 600x400 frames
    "bayer-96": ("synthetic_bayer", 8, 96),
    "xtrans-96": ("synthetic_xtrans", 8, 96),
    "bayer-96-16bit": ("synthetic_bayer", 16, 96),
}


@pytest.mark.parametrize("case", list(SCALED_CASES))
def test_develop_scaled_batch_matches_pallas_batch(case):
    make, bits, maxwidth = SCALED_CASES[case]
    pairs = [_pair(make, 600, 400, 30), _pair(make, 600, 400, 31, wb=(1.2, 1.0, 2.4, float("nan")))]
    jplans = _jax_plans([j for j, _ in pairs], bits, maxwidth)
    assert jplans[0].dem_path == "scaled" and jds.scaled_plan_for(jplans[0]) is not None
    batch = np.stack([j.data for j, _ in pairs])
    want = np.asarray(jds.develop_scaled_batch(jplans[0], batch, interpret=True,
                                               param_plans=jplans))
    plans = [tengine.plan_from_jax(p, "cpu") for p in jplans]
    planes = torch.from_numpy(batch)
    before = kds.BATCH_LAUNCHES
    got = kds.develop_scaled_batch(plans, planes)
    assert kds.BATCH_LAUNCHES == before
    assert got.shape == want.shape
    _assert_contract(got, want)
    for i, plan in enumerate(plans):
        np.testing.assert_array_equal(got[i].numpy(),
                                      kds.develop_scaled(plan, planes[i]).numpy())


PERIMAGE_CASES = {   # (generator, width, height, maxwidth, numerics) -> dem_path
    "full-bayer-lut": ("synthetic_bayer", 168, 112, 0, "lut", "full"),
    "full-xtrans-direct": ("synthetic_xtrans", 168, 112, 0, "direct", "full"),
    "full-rgb-lut": ("synthetic_linear", 168, 112, 0, "lut", "full"),
    "scaled-bayer-lut": ("synthetic_bayer", 480, 320, 96, "lut", "scaled"),
    "fulldown-bayer-direct": ("synthetic_bayer", 480, 320, 300, "direct", "fulldown"),
    "plaindown-mono-lut": ("synthetic_mono", 480, 320, 200, "lut", "plaindown"),
}


@pytest.mark.parametrize("case", list(PERIMAGE_CASES))
def test_develop_batch_perimage_matches_jax(case):
    make, width, height, maxwidth, numerics, dem_path = PERIMAGE_CASES[case]
    raws = [getattr(jraw, make)(width, height, seed=s) for s in range(2)]
    raws[1].wb_coeffs = (1.3, 1.0, 2.2, float("nan"))
    jplans = _jax_plans(raws, 8, maxwidth, numerics)
    assert jplans[0].dem_path == dem_path
    plans = [tengine.plan_from_jax(p, "cpu") for p in jplans]
    batch = np.stack([tengine.normalize_plane_np(plans[0], r.data) for r in raws])
    want = np.asarray(_develop_batch_perimage_jit(
        jnp.asarray(batch), stack_params([p.params for p in jplans]), **jplans[0].statics()))
    planes = torch.from_numpy(batch)
    got = tengine.develop_batch_perimage(plans, planes)
    _assert_contract(got, want)
    for i, plan in enumerate(plans):
        np.testing.assert_array_equal(got[i].numpy(),
                                      tengine.develop_fused(plan, planes[i]).numpy())


@pytest.mark.parametrize("make,maxwidth", [("synthetic_bayer", 0), ("synthetic_xtrans", 64),
                                           ("synthetic_linear", 100)])
def test_statics_match_jax(make, maxwidth):
    j, t = _pair(make, 192, 128, 4, orientation="Rotate270", crops=(2, 4, 6, 8))
    jp = JPipeline.new_from_source(JSource.from_raw(j))
    tp = tip.Pipeline.new_from_source(TSource.from_raw(t), device="cpu")
    for p in (jp, tp):
        p.globals.settings.maxwidth = maxwidth
        p.ops.basecurve.exposure = 0.4
    want = make_develop_plan(jp, out_bits=8, numerics="direct").statics()
    got = tengine.make_develop_plan(tp, out_bits=8, numerics="direct").statics()
    assert got == dict(want, orientation_flips=tuple(want["orientation_flips"]))


def test_normalize_plane_np_flat_rgb():
    t = traw.synthetic_linear(48, 32, seed=5)
    plan = tengine.make_develop_plan(
        tip.Pipeline.new_from_source(TSource.from_raw(t), device="cpu"))
    flat = np.arange(32 * 48 * 3, dtype=np.uint16).reshape(32, 48 * 3)
    np.testing.assert_array_equal(tengine.normalize_plane_np(plan, flat), flat.reshape(32, 48, 3))
    mono = tengine.make_develop_plan(tip.Pipeline.new_from_source(
        TSource.from_raw(traw.synthetic_mono(48, 32)), device="cpu"))
    assert tengine.normalize_plane_np(mono, flat) is flat


def test_batch_wrappers_reject_what_the_kernels_do_not_take():
    pairs = [_pair("synthetic_bayer", 96, 64, s) for s in range(2)]
    plans = [tengine.plan_from_jax(p, "cpu") for p in _jax_plans([j for j, _ in pairs])]
    meta = torch.empty((2, 64, 96), dtype=torch.uint16, device="meta")
    for wrapper in (kdev.develop_batch, kds.develop_scaled_batch):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(plans, meta)
        with pytest.raises(ValueError, match="share their statics"):
            other = tengine.plan_from_jax(_jax_plans([pairs[1][0]], bits=16)[0], "cpu")
            wrapper([plans[0], other], meta)
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(plans, meta.transpose(1, 2))
        with pytest.raises(ValueError, match="3 plans for 2 planes"):
            wrapper(plans + plans[:1], meta)
    with pytest.raises(ValueError, match="share their statics"):
        tengine.develop_batch_perimage([plans[0], other], torch.zeros((2, 64, 96)))
