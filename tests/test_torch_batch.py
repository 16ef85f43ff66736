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
* The results' memory over passes of `develop_files` on small DNGs: on the
  CPU each result a copy of its own; on the card (`cuda`-marked) each a
  view of its own pooled pinned block, bit-equal to the chunk-wide copy,
  on the full-size, thumbnail, width-sharded and eager routes, with the
  counters `output.pinned` and `output.pinned_grew`; and the one budget of
  pinned results (`engine.host_results`) over pipeline and batch results.
* The decode pool of `develop_files`: worker processes kept across calls,
  planes handed back through reused shared-memory slots (counters
  `batch.decode_slots`, `batch.decode_slots_grew`), results bit-equal to
  `develop_sources` on the same decoded files (on the card as well, under
  an open profiler too), a worker's error type kept, a bounded number of
  slots, and nothing left once the engine is collected.

Contract: max |diff| <= 1 LSB and under 2% of values differing against the
JAX package; bit-equal to the port's own single-image develop on the CPU.
The kernels themselves are compared on the card by the `cuda`-marked tests
of tests/test_torch_develop_kernel.py and test_torch_scaled.py.
"""

import contextlib
import os

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
from imagepipe_tpu_torch import profiling
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
    """No devices given means every CUDA device; without one it raises. The
    spatial axis takes rows of `spatial` devices and refuses a device count
    that is not a multiple of it, or spatial < 1; devices of mixed types and
    an unknown executor are refused."""
    if torch.cuda.is_available():
        assert BatchEngine().devices == [torch.device("cuda", i)
                                         for i in range(torch.cuda.device_count())]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchEngine()
    assert BatchEngine(devices=["cpu"]).numerics == "lut"
    eng = BatchEngine(devices=["cpu"] * 4, spatial=2)
    assert eng.rows == [[torch.device("cpu")] * 2] * 2
    for devices, spatial in ((["cpu"] * 3, 2), (["cpu"], 0), (["cpu"], -1)):
        with pytest.raises(ValueError, match="rows of spatial"):
            BatchEngine(devices=devices, spatial=spatial)
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


# -- the results' memory --------------------------------------------------

@pytest.fixture(scope="module")
def dngs(tmp_path_factory):
    """Six small DNGs, Normal and Rotate90 in turn: two buckets of three,
    so max_batch 2 gives a full and a partial chunk of each."""
    from imagepipe_tpu_torch.dng import write_dng

    d = tmp_path_factory.mktemp("dngs")
    paths = []
    for s, orientation in enumerate(["Normal", "Rotate90"] * 3):
        raw = traw.synthetic_bayer(96, 64, seed=80 + s)
        raw.orientation = traw.Orientation(orientation)
        paths.append(str(d / f"f{s}.dng"))
        write_dng(paths[-1], raw)
    return paths


def _recorded(fn):
    """(fn's result, the recorder's counters) with a profiler recording."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        got = fn()
        counters = profiling.counters()
    profiling.reset()
    return got, counters


def _pinned_view(result) -> bool:
    """Whether `result` is a view of a pinned block (the base array of a
    tensor's `numpy()`), not a copy in ordinary memory."""
    return isinstance(result.base, np.ndarray) and isinstance(result.base.base, torch.Tensor) \
        and result.base.base.is_pinned()


def _shares(results, others=None) -> bool:
    """Whether any result shares memory with another of `results`, or with
    any of `others` where given."""
    if others is None:
        return any(np.shares_memory(a, b) for i, a in enumerate(results)
                   for b in results[i + 1:])
    return any(np.shares_memory(a, b) for a in results for b in others)


@pytest.mark.parametrize("bits", [8, 16])
def test_batch_engine_cpu_results_are_separate_copies(dngs, bits):
    """On the CPU each result is a copy of its own: none shares memory with
    another of its pass or of the next, a kept result holds its values over
    two more passes, the scatter is timed and no pinned block is counted."""
    eng = BatchEngine(devices=["cpu"], max_batch=2, out_bits=bits, decode_workers=2)
    first, counters = _recorded(lambda: eng.develop_files(dngs))
    kept = [o.copy() for o in first]
    second = eng.develop_files(dngs)
    eng.develop_files(dngs)
    assert [o.shape for o in first] == [(64, 96, 3), (96, 64, 3)] * 3
    assert all(o.dtype == (np.uint8 if bits == 8 else np.uint16) for o in first)
    assert not _shares(first) and not _shares(second) and not _shares(first, second)
    for a, b, k in zip(first, second, kept):
        np.testing.assert_array_equal(a, k)
        np.testing.assert_array_equal(b, k)
    assert eng.timings["scatter"] > 0
    assert "output.pinned" not in counters and "output.pinned_grew" not in counters


CARD_ROUTES = {   # name -> (devices repeated, spatial, maxwidth, executor)
    "full": (1, 1, 0, "auto"),
    "thumb": (1, 1, 40, "auto"),
    "spatial2": (2, 2, 0, "auto"),
    "eager": (1, 1, 0, "eager"),
}


def _card_engine(route, bits):
    """A BatchEngine on the card for `route`, and the dict it fills on each
    pass with what the chunk-wide copy gave: each image of the chunk's
    device output copied to fresh contiguous host memory, by result index."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pooled pinned results come only from CUDA")
    repeat, spatial, maxwidth, executor = CARD_ROUTES[route]
    eng = BatchEngine(devices=["cuda:0"] * repeat, spatial=spatial, max_batch=2, out_bits=bits,
                      maxwidth=maxwidth, executor=executor, decode_workers=2)
    want, outs = {}, []
    develop, dispatch = eng._develop, eng._dispatch_chunk

    def develop_spy(plans, staged, row):
        out = develop(plans, staged, row)
        outs.append([np.moveaxis(img.contiguous().cpu().numpy(), 0, -1) for img in out])
        return out

    def dispatch_spy(chunk):
        got = dispatch(chunk)
        for (idx, _, _), img in zip(chunk, outs.pop()):
            want[idx] = img
        return got

    eng._develop, eng._dispatch_chunk = develop_spy, dispatch_spy
    return eng, want


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(CARD_ROUTES))
@pytest.mark.parametrize("bits", [8, 16])
def test_batch_engine_card_results_are_views_of_their_own_pinned_blocks(dngs, bits, route):
    """On the card each result equals the chunk-wide copy bit for bit, in
    its strides too (contiguous [3, H', W'] with the channels moved last,
    Rotate90 as well), and is a view of a pinned block of its own: no two
    results of a pass share memory, nor a result with one of a later pass,
    and a kept result holds its values over three more passes."""
    eng, want = _card_engine(route, bits)
    first = eng.develop_files(dngs)
    assert sorted(want) == list(range(len(dngs)))
    for got, ref in zip(first, [want[i] for i in range(len(dngs))]):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.strides == ref.strides
        np.testing.assert_array_equal(got, ref)
        assert _pinned_view(got)
    assert not _shares(first)
    kept = [o.copy() for o in first]
    for _ in range(3):
        later = eng.develop_files(dngs)
        assert not _shares(later) and not _shares(first, later)
    for got, k in zip(first, kept):
        np.testing.assert_array_equal(got, k)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(CARD_ROUTES))
def test_batch_engine_card_counts_pinned_and_stops_growing(dngs, route):
    """While a profiler records, every image counts `output.pinned`; once
    each pass drops the results of the pass before last, the pool holds
    enough blocks and `output.pinned_grew` stops."""
    eng, _ = _card_engine(route, 8)

    def passes():
        kept, counts = [], []
        for _ in range(8):
            kept.append(eng.develop_files(dngs))
            if len(kept) > 2:
                kept.pop(0)
            counts.append(profiling.counters())
        return counts

    counts, _ = _recorded(passes)
    assert [c.get("output.pinned", 0) for c in counts] == [len(dngs) * (k + 1) for k in range(8)]
    grew = [c.get("output.pinned_grew", 0) for c in counts]
    assert grew[4:] == [grew[4]] * 4, grew


@pytest.mark.parametrize("first", ["pipeline", "batch"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_result_views_stop_at_the_pinned_bound(monkeypatch, dtype, first):
    """`engine.host_results`, which makes every CUDA host result, makes
    views of blocks while the blocks that live results hold, counted as the
    pool's power-of-two blocks, stay within `PINNED_RESULTS_BYTES`; past it
    a result is a copy with the same values and strides. A pipeline's
    block (one [3, H, W] output, transposed as a Rotate90 output is) and a
    batch's blocks (contiguous images) draw on the one budget, whichever
    comes first. Collecting a view gives its share back. Host tensors stand
    in for the pinned blocks: the budget is host bookkeeping."""
    import gc

    def block(k):
        return torch.from_numpy((np.arange(3 * 20 * 30) + k).astype(dtype).reshape(3, 20, 30))

    pipe = block(0).transpose(-1, -2)
    chunk = [block(k) for k in (1, 2, 3)]
    size = 1 << (pipe.numpy().nbytes - 1).bit_length()
    base = tengine._pinned_held
    monkeypatch.setattr(tengine, "PINNED_RESULTS_BYTES", base + 2 * size)
    if first == "pipeline":
        blocks = [pipe] + chunk[:2]
        got = tengine.host_results([pipe]) + tengine.host_results(chunk[:2])
    else:
        blocks = chunk[:2] + [pipe]
        got = tengine.host_results(chunk[:2]) + tengine.host_results([pipe])
    assert [np.shares_memory(g, b.numpy()) for g, b in zip(got, blocks)] == [True, True, False]
    for g, b in zip(got, blocks):
        want = np.moveaxis(b.numpy(), 0, -1)
        assert g.strides == want.strides
        np.testing.assert_array_equal(g, want)
    assert tengine._pinned_held == base + 2 * size
    del got[0]
    gc.collect()
    assert tengine._pinned_held == base + size
    got += tengine.host_results([chunk[2]])
    assert np.shares_memory(got[-1], chunk[2].numpy())
    del got
    gc.collect()
    assert tengine._pinned_held == base


@pytest.mark.cuda
def test_batch_engine_card_results_past_the_pinned_bound_are_copies(dngs, monkeypatch):
    """With room for three blocks, three results of a pass are pinned views
    and three are copies in ordinary memory, all bit-equal to the chunk-wide
    copy; once the pass's results are dropped the room comes back."""
    import gc

    eng, want = _card_engine("full", 8)
    size = 1 << (3 * 64 * 96 - 1).bit_length()
    monkeypatch.setattr(tengine, "PINNED_RESULTS_BYTES", tengine._pinned_held + 3 * size)
    for _ in range(2):
        got = eng.develop_files(dngs)
        assert sorted(map(_pinned_view, got)) == [False] * 3 + [True] * 3
        for i, g in enumerate(got):
            assert g.strides == want[i].strides
            np.testing.assert_array_equal(g, want[i])
        assert not _shares(got)
        del got
        gc.collect()


# -- the decode pool -------------------------------------------------------

def _worker_pids(eng) -> set:
    return set(eng._decode.executor._processes)


def test_develop_files_keeps_its_workers_and_slots(dngs):
    """Two calls decode in the same worker processes, the second through
    the slots the first made: every file comes back through a slot, and
    none is made."""
    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=2)

    def passes():
        got = []
        for _ in range(2):
            profiling.reset()
            eng.develop_files(dngs)
            decodes = [s for s in profiling.spans() if s["name"] == "batch.decode"]
            got.append(({s["thread"] for s in decodes}, profiling.counters()))
        return got

    (first, counts1), (second, counts2) = _recorded(passes)[0]
    assert first == second == _worker_pids(eng) and len(first) <= 2
    assert counts1["batch.decode_slots"] == counts2["batch.decode_slots"] == len(dngs)
    assert counts1["batch.decode_slots_grew"] == len(eng._decode.slots) > 0
    assert "batch.decode_slots_grew" not in counts2


@pytest.mark.parametrize("maxwidth", [0, 40], ids=["full", "thumb"])
@pytest.mark.parametrize("bits", [8, 16])
def test_develop_files_matches_develop_sources(dngs, bits, maxwidth):
    """Planes handed back through slots develop bit for bit as the same
    files decoded here, Normal and Rotate90, over two passes (the second
    reusing the slots)."""
    from imagepipe_tpu_torch.decode import decode_file

    eng = BatchEngine(devices=["cpu"], max_batch=2, out_bits=bits, maxwidth=maxwidth,
                      decode_workers=2)
    want = BatchEngine(devices=["cpu"], max_batch=2, out_bits=bits, maxwidth=maxwidth
                       ).develop_sources([decode_file(p) for p in dngs])
    for _ in range(2):
        got = eng.develop_files(dngs)
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_develop_files_worker_errors_keep_their_type(dngs, tmp_path):
    """A corrupt file fails in a worker with the error decoding it here
    raises: under errors='skip' its BatchError carries that type and the
    rest develops; under errors='raise' that type is raised, and the
    engine's next pass still develops every file."""
    from imagepipe_tpu_torch.decode import decode_file

    bad = tmp_path / "corrupt.dng"
    bad.write_bytes(b"II*\x00 not a raw file at all")
    with pytest.raises(Exception) as here:
        decode_file(str(bad))
    paths = dngs[:2] + [str(bad)] + dngs[2:]
    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=2)
    outs = eng.develop_files(paths, errors="skip")
    assert isinstance(outs[2], BatchError) and type(outs[2].error) is here.type
    assert str(outs[2].error) == str(here.value)
    assert all(isinstance(o, np.ndarray) for i, o in enumerate(outs) if i != 2)
    with pytest.raises(here.type):
        eng.develop_files(paths)
    assert all(isinstance(o, np.ndarray) for o in eng.develop_files(dngs))
    assert eng._decode.nfree == len(eng._decode.slots)


def test_develop_files_holds_a_bounded_number_of_slots(dngs):
    """40 files at max_batch 2 over two buckets hold at most the pool's
    window of 2 x decode_workers, the file being planned and a partial
    bucket each: not one slot a file."""
    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=2)
    paths = (dngs * 7)[:40]
    outs, counts = _recorded(lambda: eng.develop_files(paths))
    bound = 2 * 2 + 1 + 2 * (2 - 1)
    assert all(isinstance(o, np.ndarray) for o in outs)
    assert counts["batch.decode_slots"] == 40
    assert eng._decode.peak <= bound and counts["batch.decode_slots_grew"] <= bound
    assert len(eng._decode.slots) <= bound


def test_develop_files_mixed_sizes_with_more_workers_than_cores(tmp_path):
    """Three plane sizes interleaved, under new paths each pass (links to
    the same files), so that a slot's size is a guess that misses, and more
    workers than cores: every pass bit-equal to `develop_sources` over the
    files decoded here, and the slots within twice a pass's peak."""
    from imagepipe_tpu_torch.decode import decode_file
    from imagepipe_tpu_torch.dng import write_dng

    files = []
    for s in range(24):
        w, h = [(96, 64), (48, 32), (64, 48)][s % 3]
        files.append(str(tmp_path / f"m{s}.dng"))
        write_dng(files[-1], traw.synthetic_bayer(w, h, seed=200 + s))
    want = BatchEngine(devices=["cpu"], max_batch=3).develop_sources(
        [decode_file(p) for p in files])
    eng = BatchEngine(devices=["cpu"], max_batch=3, decode_workers=(os.cpu_count() or 4) + 2)
    for k in range(3):
        links = []
        for i, f in enumerate(files):
            links.append(str(tmp_path / f"pass{k}_{i}.dng"))
            os.symlink(f, links[-1])
        got = eng.develop_files(links)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert eng._decode.nfree == len(eng._decode.slots) <= 2 * eng._decode.peak


def test_a_dead_worker_breaks_the_pass_and_the_next_starts_anew(dngs):
    """A worker killed between calls fails the next call with
    BrokenProcessPool, whatever `errors` says; the call after it forks new
    workers and develops every file."""
    import signal
    from concurrent.futures.process import BrokenProcessPool

    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=2)
    want = eng.develop_files(dngs)
    old = _worker_pids(eng)
    os.kill(next(iter(old)), signal.SIGKILL)
    with pytest.raises(BrokenProcessPool):
        for _ in range(50):     # until the pool has seen its worker die
            eng.develop_files(dngs, errors="skip")
    got = eng.develop_files(dngs)
    assert not old & _worker_pids(eng)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_collected_engine_leaves_no_worker_and_no_slot(dngs):
    """Once the engine is collected its workers have exited and every
    shared-memory block of its pool, the workers' included, is unlinked."""
    import gc
    import glob

    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=2)
    eng.develop_files(dngs)
    pids, prefix = _worker_pids(eng), eng._decode.prefix
    assert len(glob.glob(f"/dev/shm/{prefix}*")) == len(eng._decode.slots) > 0
    del eng
    gc.collect()
    assert glob.glob(f"/dev/shm/{prefix}*") == []
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_an_engine_made_in_another_process_refuses_to_decode(dngs):
    """A process forked after the engine was made does not reach the
    parent's pool: `develop_files` raises rather than wait on it."""
    eng = BatchEngine(devices=["cpu"], max_batch=2, decode_workers=1)
    eng._decode.pid += 1
    with pytest.raises(RuntimeError, match="make an engine in this process"):
        eng.develop_files(dngs)


def test_a_process_that_multiprocessing_started_exits_with_its_engine_alive(dngs):
    """multiprocessing ends a process it started by joining that process's
    children, and runs no `atexit` hook: the engine's pool closes first, so
    a process that ends with an engine still alive exits."""
    import multiprocessing
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import torch_fleet

    proc = multiprocessing.get_context("spawn").Process(target=torch_fleet.develop_and_keep,
                                                        args=(dngs,))
    proc.start()
    proc.join(60)
    hung = proc.is_alive()
    if hung:
        proc.kill()
        proc.join()
    assert not hung and proc.exitcode == 0


@pytest.mark.cuda
@pytest.mark.parametrize("profiled", [False, True], ids=["plain", "profiler"])
def test_batch_engine_card_decode_pool_matches_develop_sources(dngs, profiled):
    """On the card the pool is forked from a process that holds a CUDA
    context, once under an open profiler (CPU and CUDA activity) that the
    engine is made in: both passes bit-equal to `develop_sources` on the
    same files decoded here, every file through a slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fork from a CUDA context")
    from torch.profiler import ProfilerActivity, profile

    from imagepipe_tpu_torch.decode import decode_file

    torch.zeros(1, device="cuda:0")
    kw = dict(devices=["cuda:0"], max_batch=2, decode_workers=2)
    want = BatchEngine(**kw).develop_sources([decode_file(p) for p in dngs])
    with contextlib.ExitStack() as stack:
        if profiled:
            stack.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA]))
            profiling.reset()
        eng = BatchEngine(**kw)
        passes = [eng.develop_files(dngs) for _ in range(2)]
        counts = profiling.counters()
    profiling.reset()
    for got in passes:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    if profiled:
        assert counts["batch.decode_slots"] == 2 * len(dngs)


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
