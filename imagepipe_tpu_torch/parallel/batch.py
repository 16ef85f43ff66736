"""Batched multi-device develop engine.

Counterpart of `imagepipe_tpu/parallel/batch.py`. A file list is decoded by
a pool of host processes, bucketed by shape class, and each bucket is
developed `max_batch` images at a time, every image with its own
calibration:

  * Routing by plan, never a fallback on failure: full-size cfa/mono plans
    and 'scaled' cfa plans in 'direct' numerics go to the batched kernels
    (`kernels.develop.develop_batch`, `kernels.develop_scaled.
    develop_scaled_batch`, one launch per chunk); every other plan goes to
    the eager engine (`engine.develop_batch_perimage`). On the CPU the
    kernel wrappers run their plain versions.
  * A bucket is keyed by the plan's statics plus the sensor plane's shape
    and dtype: a batched launch takes one row stride.
  * Devices form a grid (`make_batch_mesh`): rows of `spatial` devices.
    Data parallel: chunks go round-robin over the rows, each chunk whole
    on one row, so nothing is padded. Spatial: with `spatial` > 1 a chunk
    of full-size kernel plans is width-sharded across its row
    (`kernels.develop.develop_sp_batch`: one launch per column shard, a
    1-column halo exchange between the shards, the output assembled on the
    row's first device), the counterpart of the sp branch of the JAX
    package's `_dispatch_pallas`; and every chunk the eager engine develops
    is width-sharded by `engine.develop_batch_perimage_sp` (full-size
    plans by crop columns with 1-column halos, resize plans by output
    columns, each shard staged with the source span its windows read),
    the counterpart of GSPMD partitioning the JAX package's XLA engine
    over its 'spatial' axis. Both are bit-equal to spatial=1. 'scaled'
    plans that the scaled kernel takes develop whole on the row's first
    device (`develop_scaled_batch`): their outputs are small, and the
    kernel has no shard form. The JAX package XLA-shards those plans
    instead, because its Pallas scaled kernel has no shard form either;
    both agree within the cross-path contract.

Decode/compute overlap: `develop_files` dispatches a bucket the moment it
fills while the pool keeps decoding. Dispatch does not wait for the card:
the chunk is staged into a pinned host buffer [B, H0, W0], copied to the
card with `non_blocking=True` on the device's current stream, developed,
and each image of its output copied back without blocking into a
contiguous [3, H', W'] block of its own from torch's caching pinned host
allocator, as on the CPU (`engine.start_host_copy`, which every CUDA host
output goes through); a CUDA event marks the end. `_collect` waits on the
oldest event and makes each result a view of its image's block, with no
host copy (`engine.host_results`); it leaves at most `inflight_batches`
chunks unfetched, so the engine's own pinned staging and device memory is
bounded by that and not by the length of the file list. A result is the
only reference to its block: no result aliases another, a result of
another pass, or a buffer the engine reuses, and the block goes back to
the pool when the caller drops the result. The blocks that live results
hold, over every engine and pipeline of the process, stay within
`engine.PINNED_RESULTS_BYTES`: past it a result is a copy in ordinary
memory, as on the CPU. So a caller may keep any number of results without
locking more host memory than that; a caller with a long list still
passes it in parts, so that it holds no more results than it writes at
once. On the CPU each result is a copy of its image out of the chunk's
output.

Decode runs in worker processes, so that the calling thread's plan,
staging and dispatch do not wait for the interpreter lock behind the
decoders. The pool (`_DecodePool`) is forked at the engine's first
`develop_files` and kept until the engine is collected or the process
exits, as torch's DataLoader forks workers from a process that holds a
CUDA context: a worker runs `decode.decode_file` and numpy only, never
torch. A worker copies its file's sensor plane into a slot, a named
`multiprocessing.shared_memory` block that it attaches once and keeps
attached, and returns the RawImage's other fields; the source is rebuilt
around a view of the slot. A slot is held from its file's decode until
its chunk is staged (`_stage` copies it), then goes back to a free list
by byte size. A file is given a free slot of the size its path's last
decode took (else the last decode's), made only when none is free; where
that guess misses, the worker makes one of its plane's size. So after a
first pass over the same files a pass makes none. At most
`2 * decode_workers` files are decoding or decoded but not yet planned,
so the slots held are bounded by those and the partial buckets, not by
the list. No result and no staged buffer aliases a slot. One engine runs
one `develop_files` at a time. Only the calling thread touches CUDA.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import gc
import itertools
import multiprocessing
import multiprocessing.util
import os
import queue
import secrets
import threading
import time
import warnings
from collections import defaultdict
from concurrent.futures.process import BrokenProcessPool
from multiprocessing import resource_tracker, shared_memory

import numpy as np
import torch

from .. import color as cc
from .. import profiling
from ..decode import decode_file
from ..engine import (develop_batch_perimage, develop_batch_perimage_sp, host_results,
                      make_develop_plan, normalize_plane_np, sp_shards, stage_perimage_sp,
                      stage_sp, start_host_copy)
from ..kernels import develop as kdev
from ..kernels import develop_scaled as kds
from ..pipeline import Pipeline, default_device
from ..sources import ImageSource

__all__ = ["BatchEngine", "BatchError", "default_decode_workers", "make_batch_mesh",
           "shard_batch"]


class BatchError:
    """Marked per-file failure in a batch result list (errors='skip'): the
    slot keeps its input order, carries the path and the decode/plan
    exception, and is falsy so `if result:` skips it naturally."""

    def __init__(self, path: str, error: Exception):
        self.path = path
        self.error = error

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return f"BatchError({self.path!r}, {self.error!r})"


def default_decode_workers() -> int:
    """Host decode is the throughput-limiting stage of a serving job, so one
    decode process per available core (affinity-aware), capped at 16: the
    fujic and DNG decoders spin their own small pools per file."""
    try:
        ncpu = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        ncpu = os.cpu_count() or 4
    return max(1, min(16, ncpu))


def _all_cuda_devices() -> list:
    default_device()    # raises when there is no CUDA device
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_batch_mesh(devices=None, spatial: int = 1) -> list[list[torch.device]]:
    """The devices (default every CUDA device) as rows of `spatial`, row
    major: chunks go round-robin over the rows (the data-parallel axis) and
    a row width-shards each image (the spatial axis). The counterpart of the
    JAX package's `make_batch_mesh` (parallel/batch.py:58-65). A device may
    appear more than once: [cuda:0, cuda:0] with spatial=2 puts both shards
    on one card."""
    devices = [torch.device(d) for d in (_all_cuda_devices() if devices is None else devices)]
    if spatial < 1 or not devices or len(devices) % spatial:
        raise ValueError(f"make_batch_mesh: {len(devices)} devices do not make rows "
                         f"of spatial={spatial}")
    return [devices[i:i + spatial] for i in range(0, len(devices), spatial)]


def shard_batch(rows, planes) -> list[list[torch.Tensor]]:
    """Place [B, H, W] or [B, H, W, C] planes (a host array or a tensor)
    over a grid of devices (`make_batch_mesh`), the counterpart of the JAX
    package's `shard_batch` (parallel/batch.py:68-71): the batch in
    contiguous blocks of ceil(B / len(rows)) images over the rows, and W
    in the column shards of `engine.sp_shards(W, spatial)` over each row's
    devices, with no halo. Returns [row][shard] tensors, each contiguous
    on its device; a row past the batch's end holds empty blocks, and a W
    narrower than the shards gives a row fewer pieces than devices."""
    planes = torch.as_tensor(planes)
    if planes.dim() not in (3, 4) or not rows:
        raise ValueError(f"shard_batch: planes {tuple(planes.shape)} over {len(rows)} rows; "
                         f"want [B, H, W] or [B, H, W, C] over one row or more")
    block = -(-planes.shape[0] // len(rows))
    cols = sp_shards(planes.shape[2], len(rows[0]))
    return [[planes[r * block:(r + 1) * block, :, x:x + w].to(d).contiguous()
             for (x, w), d in zip(cols, row)]
            for r, row in enumerate(rows)]


# In a decode worker: the slots it has attached, by name, and the pool's
# generation they were attached in (a new one once the pool unlinks slots).
_attached: dict = {}
_attached_generation = 0
_made = itertools.count()


def _decode_into_slot(path, slot, size, prefix, generation):
    """A decode worker's task: `decode_file(path)`, its RAW's sensor plane
    copied into the slot named `slot` of `size` bytes or, where none was
    given or the plane takes another size, into a new block named from
    `prefix`. Returns (the source without its plane, (slot, bytes, shape,
    dtype, made here) or None for a raster source, which comes back whole,
    the worker's pid, and its `perf_counter_ns` at the start and the end).
    Touches no torch."""
    global _attached_generation
    start = time.perf_counter_ns()
    if generation != _attached_generation:
        for shm in _attached.values():
            shm.close()
        _attached.clear()
        _attached_generation = generation
    src = decode_file(path)
    if not src.is_raw:
        return src, None, os.getpid(), start, time.perf_counter_ns()
    data = np.asarray(src.raw.data)
    nbytes = max(data.nbytes, 1)
    made = slot is None or size != nbytes
    if made:
        slot = f"{prefix}w{os.getpid()}_{next(_made)}"
        _attached[slot] = shared_memory.SharedMemory(slot, create=True, size=nbytes)
    elif slot not in _attached:
        _attached[slot] = shared_memory.SharedMemory(slot)
    try:
        np.ndarray(data.shape, data.dtype, buffer=_attached[slot].buf)[...] = data
    except BaseException:
        if made:
            _attached.pop(slot).unlink()
        raise
    src.raw.data = None
    return (src, (slot, nbytes, data.shape, data.dtype.str, made), os.getpid(), start,
            time.perf_counter_ns())


def _watch_parent(parent: int) -> None:
    """A decode worker's initializer: a thread that ends the worker once
    its parent has gone without closing the pool (killed), as torch's
    DataLoader workers watch theirs; else the workers would wait on the
    pool's queue for good."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(0)

    threading.Thread(target=watch, name="decode-parent-watch", daemon=True).start()


class _DecodePool:
    """The decode worker processes of one engine and the shared-memory
    slots through which they hand planes back (module docstring). Holds no
    reference to its engine, so that `close` can run as the engine's
    finalizer; used by the engine's calling thread only."""

    def __init__(self, workers: int):
        self.workers = workers
        self.pid = os.getpid()
        self.prefix = f"ipt{self.pid}_{secrets.token_hex(4)}_"
        self.executor = None
        self.broken = False
        self.slots: dict = {}               # name -> SharedMemory, every slot
        self.free = defaultdict(list)       # byte size -> names of free slots
        self.nfree = 0
        self.sizes = collections.OrderedDict()  # path -> bytes of its last plane
        self.last_size = None
        self.generation = 0

    def begin(self) -> None:
        """Start a pass, and the workers at the engine's first. Forked from
        this thread with the collector's objects frozen, so that a worker's
        collections never run a finalizer of the parent's garbage; the
        resource tracker runs first, so that the workers share it."""
        self.done = queue.SimpleQueue()
        self.outstanding: dict = {}         # future -> (index, path, slot given)
        self.held: dict = {}                # index -> slot of a decoded file
        self.unsized = 0                    # decodes out with no slot given
        self.used, self.peak = set(), 0
        if os.getpid() != self.pid:
            raise RuntimeError("BatchEngine: the decode pool belongs to the process that made "
                               "the engine; make an engine in this process")
        if self.executor is not None:
            return
        resource_tracker.ensure_running()
        self.executor = cf.ProcessPoolExecutor(
            self.workers, mp_context=multiprocessing.get_context("fork"),
            initializer=_watch_parent, initargs=(self.pid,))
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "This process .* is multi-threaded",
                                    DeprecationWarning)
            gc.freeze()
            try:
                started = self.executor.submit(os.getpid)
            finally:
                gc.unfreeze()
        started.result()

    def _make(self, size: int) -> str:
        name = f"{self.prefix}m{next(_made)}"
        self.slots[name] = shared_memory.SharedMemory(name, create=True, size=size)
        profiling.count("batch.decode_slots_grew")
        return name

    def submit(self, idx: int, path: str) -> None:
        """Hand `path` to the pool with a free slot of the size its last
        decode (or else the last decode) took, made if none is free."""
        size = self.sizes.get(path, self.last_size)
        slot = None
        if size is not None:
            if self.free[size]:
                slot = self.free[size].pop()
                self.nfree -= 1
            else:
                slot = self._make(size)
        self.unsized += slot is None
        self._count_held()
        try:
            fut = self.executor.submit(_decode_into_slot, path, slot, size, self.prefix,
                                       self.generation)
        except BaseException as e:
            self.broken |= isinstance(e, BrokenProcessPool)
            self.unsized -= slot is None
            self._release(slot)
            raise
        self.outstanding[fut] = (idx, path, slot)
        fut.add_done_callback(self.done.put)

    def next_done(self):
        """The next decode to finish as (index, future), None when none is
        out."""
        if not self.outstanding:
            return None
        fut = self.done.get()
        return self.outstanding[fut][0], fut

    def receive(self, fut):
        """(source, seconds, pid, start_ns, end_ns) of a finished decode,
        its plane a view of the slot it came back in, which the file now
        holds; raises the worker's exception, its slot freed."""
        idx, path, given = self.outstanding.pop(fut)
        self.unsized -= given is None
        try:
            src, slot, pid, start, end = fut.result()
        except BaseException as e:
            self.broken |= isinstance(e, BrokenProcessPool)
            self._release(given)
            raise
        if slot is None:
            self._release(given)
            return src, (end - start) / 1e9, pid, start, end
        name, nbytes, shape, dtype, made = slot
        if made:
            self.slots[name] = shared_memory.SharedMemory(name)
            profiling.count("batch.decode_slots_grew")
            self._release(given)
        self.held[idx] = name
        self._count_held()
        self.used.add(nbytes)
        self.sizes[path] = self.last_size = nbytes
        self.sizes.move_to_end(path)
        if len(self.sizes) > 4096:
            self.sizes.popitem(last=False)
        profiling.count("batch.decode_slots")
        src.raw.data = np.ndarray(shape, np.dtype(dtype), buffer=self.slots[name].buf)
        return src, (end - start) / 1e9, pid, start, end

    def _count_held(self) -> None:
        """The pass's peak of slots held, a decode given none counting as
        one: what a like pass will hold again."""
        self.peak = max(self.peak, len(self.slots) - self.nfree + self.unsized)

    def _release(self, name) -> None:
        if name is not None:
            self.free[self.slots[name].size].append(name)
            self.nfree += 1

    def release(self, idx: int) -> None:
        """The file `idx` is staged (or failed): its slot goes back."""
        self._release(self.held.pop(idx, None))

    def finish(self) -> None:
        """End a pass, on an exception too: wait for the decodes still out
        (their slots are being written) and take back every slot. Past
        twice the pass's peak, free slots are unlinked, of sizes the pass
        did not use first: a slot is made where a file's plane took another
        size than its guess, and this bounds what such files leave. A
        broken pool is dropped, for the next pass to start anew."""
        for fut in list(self.outstanding):
            fut.cancel()
        cf.wait(list(self.outstanding))
        for fut in list(self.outstanding):
            idx = self.outstanding[fut][0]
            try:
                self.receive(fut)
            except Exception:   # cancelled, or the decode failed: its slot is back
                continue
            self.release(idx)
        for idx in list(self.held):
            self.release(idx)
        excess = len(self.slots) - 2 * self.peak if self.used else 0
        for size in sorted(self.free, key=lambda size: size in self.used):
            while excess > 0 and self.free[size]:
                self._unlink(self.free[size].pop())
                self.nfree -= 1
                excess -= 1
        if self.broken:
            self.executor.shutdown(wait=False, cancel_futures=True)
            self.executor, self.broken = None, False

    def _unlink(self, name) -> None:
        shm = self.slots.pop(name)
        try:
            shm.close()
        except BufferError:     # a view outlives the pass (a traceback's frame)
            pass
        shm.unlink()
        self.generation += 1

    def close(self) -> None:
        """Stop the workers and unlink every slot: the engine's finalizer,
        at its collection or the process's exit; a no-op in a fork."""
        if os.getpid() != self.pid:
            return
        if self.executor is not None:
            self.executor.shutdown(wait=True, cancel_futures=True)
            self.executor = None
        for name in list(self.slots):
            self._unlink(name)
        self.free.clear()
        self.nfree = 0


class BatchEngine:
    """Develop many RAW files concurrently on one or more devices.

    devices: the devices, default every CUDA device (raises without one);
    a device may appear more than once. spatial: devices per row of the
    grid (`make_batch_mesh`); chunks go to the rows in turn, and with
    spatial > 1 a row width-shards each chunk but those of the scaled
    kernel, so devices=["cuda:0", "cuda:0"], spatial=2 runs the sharded
    path on one card. out_bits: 8 (sRGB) or 16 (linear). max_batch: images per launch.
    decode_workers: decode processes (default `default_decode_workers()`),
    forked at the first `develop_files` and kept until the engine is
    collected or the process exits.
    maxwidth / maxheight: thumbnail limits, 0 for none. executor: 'auto' or
    'kernel' (the batched kernels for the plans they take; the two are the
    same here, as no plan prefers the eager engine) or 'eager'.
    inflight_batches: chunks left unfetched at most."""

    def __init__(self, devices=None, out_bits: int = 8, max_batch: int = 8,
                 decode_workers: int | None = None, maxwidth: int = 0,
                 maxheight: int = 0, executor: str = "auto",
                 inflight_batches: int = 2, spatial: int = 1):
        if executor not in ("auto", "eager", "kernel"):
            raise ValueError(f"executor {executor!r}: 'auto', 'eager' or 'kernel'")
        self.rows = make_batch_mesh(devices, spatial)
        self.devices = [d for row in self.rows for d in row]
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"devices {self.devices}: one or more of one type")
        self.spatial = spatial
        # 'direct' numerics on CUDA (the kernels' form), 'lut' on the CPU.
        self.numerics = cc.device_numerics("auto", self.devices[0])
        self.out_bits = out_bits
        self.max_batch = max_batch
        self.decode_workers = (default_decode_workers() if decode_workers is None
                               else decode_workers)
        self.maxwidth = maxwidth
        self.maxheight = maxheight
        # Bound on dispatched-but-unfetched chunks: enough to keep the card
        # busy under the host's fetch, without memory growing with the list.
        self.inflight_batches = max(1, int(inflight_batches))
        # 'auto' and 'kernel': the batched kernels for the plans they take,
        # the eager engine for the rest; 'eager': the eager engine only.
        self.executor = executor
        # Host seconds by stage (the sums of the `batch.<stage>` spans)
        # over calls: decode (the workers' seconds a file, decode and the
        # copy into its slot), submit (the calling thread handing the pool
        # the first files of a pass, and starting it at the first),
        # decode_wait (the calling thread taking the pool's next decoded
        # file, blocked until there is one, and handing it the next path),
        # plan, stage (into pinned buffers), dispatch (enqueue of copies and launches),
        # wait (for the card, in _collect), scatter (out of pinned buffers
        # into the results: on CUDA views of each image's pinned block).
        self.timings = collections.Counter()
        # Test/observability hook: when set to a list, (event, payload)
        # tuples are appended on every decode, dispatch, collect and error.
        self._events: list | None = None
        self._next_row = 0
        # Closed when the engine is collected, and at the process's exit
        # before multiprocessing joins its children and closes the pool's
        # queues (their finalizers' priority is 10): also in a process that
        # multiprocessing started, where neither `atexit` nor the pool's
        # own exit hook runs.
        self._decode = _DecodePool(self.decode_workers)
        multiprocessing.util.Finalize(self, self._decode.close, exitpriority=100)

    def _note(self, event: str, payload) -> None:
        if self._events is not None:
            self._events.append((event, payload))

    def _plan_for(self, source: ImageSource):
        """The source's develop plan, its params on the host: a chunk's
        calibration reaches the card with its planes."""
        pipe = Pipeline.new_from_source(source, device="cpu")
        pipe.globals.settings.maxwidth = self.maxwidth
        pipe.globals.settings.maxheight = self.maxheight
        if self.out_bits == 16:
            pipe.globals.settings.linear = True
        return make_develop_plan(pipe, out_bits=self.out_bits, numerics=self.numerics)

    def _use_kernel(self, plan) -> bool:
        """The batched kernels take full-size cfa/mono plans and 'scaled'
        cfa plans in 'direct' numerics (mirrors `_use_pallas` of the JAX
        package); the eager engine takes the rest."""
        if self.executor == "eager" or plan.numerics != "direct":
            return False
        return kdev.kernel_supported(plan) or kds.scaled_supported(plan)

    @staticmethod
    def _bucket_key(src: ImageSource, plan) -> tuple:
        data = src.raw.data
        return tuple(sorted(plan.statics().items())), data.shape, data.dtype.str

    def _sharded(self, plan) -> bool:
        """With spatial > 1 a chunk is width-sharded across its row, unless
        the scaled kernel takes it: full-size kernel plans by the shard
        launches, every plan of the eager engine by its sharded form. The
        JAX package shards every plan but its Pallas 'scaled' ones, which
        its XLA engine shards instead (parallel/batch.py:142-143 there)."""
        if self.spatial == 1:
            return False
        return not self._use_kernel(plan) or kdev.kernel_supported(plan)

    def _develop(self, plans, staged, row) -> torch.Tensor:
        """Upload a staged chunk and develop it: its shards across the row,
        or whole on the row's first device."""
        if isinstance(staged, list):
            if self._use_kernel(plans[0]):
                return kdev.develop_sp_batch(plans, staged, row)
            return develop_batch_perimage_sp(plans, staged, row)
        planes = staged.to(row[0], non_blocking=True)
        if not self._use_kernel(plans[0]):
            return develop_batch_perimage([p.to(planes.device) for p in plans], planes)
        if plans[0].dem_path == "scaled":
            return kds.develop_scaled_batch(plans, planes)
        return kdev.develop_batch(plans, planes)

    def _stage(self, chunk, pin: bool):
        """The chunk's normalized sensor planes on the host: stacked
        [B, H0, W0], or cut into its row's width shards (`stage_sp` for
        the shard launches, `stage_perimage_sp` for the eager engine)."""
        plan = chunk[0][2]
        planes = [normalize_plane_np(p, src.raw.data) for _, src, p in chunk]
        if self._sharded(plan):
            stage = stage_sp if self._use_kernel(plan) else stage_perimage_sp
            return stage(plan, planes, self.spatial, pin=pin)
        dtype = torch.from_numpy(planes[0][:0]).dtype
        buf = torch.empty((len(chunk), *planes[0].shape), dtype=dtype, pin_memory=pin)
        host = buf.numpy()
        for i, plane in enumerate(planes):
            host[i] = plane
        return buf

    def _dispatch_chunk(self, chunk):
        """Stage one bucket chunk and enqueue its develop on the next row.
        Returns (output on the host, event or None). On the CPU the output
        is the chunk's [B, 3, H', W'] tensor. On CUDA it is
        `engine.start_host_copy`'s list of one contiguous pinned block per
        image, complete once the event has fired."""
        row = self.rows[self._next_row % len(self.rows)]
        self._next_row += 1
        device = row[0]
        plans = [plan for _, _, plan in chunk]
        if device.type != "cuda":
            with profiling.span("batch.stage", into=self.timings, key="stage"):
                staged = self._stage(chunk, pin=False)
            with profiling.span("batch.dispatch", into=self.timings, key="dispatch"):
                out, done = self._develop(plans, staged, row), None
        else:
            with torch.cuda.device(device):
                with profiling.span("batch.stage", into=self.timings, key="stage"):
                    staged = self._stage(chunk, pin=True)
                with profiling.span("batch.dispatch", into=self.timings, key="dispatch"):
                    out, done = start_host_copy(self._develop(plans, staged, row))
        self._note("dispatch", len(chunk))
        return out, done

    def _collect(self, inflight, results, keep: int = 0):
        """Fetch finished outputs (oldest first) into `results` in input
        order, leaving at most `keep` chunks in flight. Each result is an
        [H', W', 3] view of planar memory of its own, as the JAX package's
        `planar_to_hwc` returns: a contiguous HWC copy is a strided
        transpose, several times slower than the plain copy. On CUDA that
        memory is the image's pooled pinned block from `_dispatch_chunk`,
        with no host copy, within `engine.PINNED_RESULTS_BYTES`
        (`engine.host_results`); past it, and on the CPU, it is a copy. The
        span `batch.scatter` is the making of the results."""
        while len(inflight) > keep:
            chunk, (out, done) = inflight.pop(0)
            with profiling.span("batch.wait", into=self.timings, key="wait"):
                if done is not None:
                    done.synchronize()
            with profiling.span("batch.scatter", into=self.timings, key="scatter"):
                if done is not None:
                    images = host_results(out)
                else:
                    images = [np.moveaxis(img.copy(), 0, -1) for img in out.numpy()]
                for (idx, _, _), img in zip(chunk, images):
                    results[idx] = img
            self._note("collected", len(chunk))

    def _plan_timed(self, src):
        with profiling.span("batch.plan", into=self.timings, key="plan"):
            return self._plan_for(src)

    def develop_sources(self, sources: list[ImageSource]):
        """Develop a list of RAW sources; returns [H', W', 3] numpy outputs
        in input order. Sources are bucketed by shape class."""
        results: list = [None] * len(sources)
        buckets: dict = defaultdict(list)
        with profiling.request("batch.develop_sources"):
            for idx, src in enumerate(sources):
                plan = self._plan_timed(src)
                buckets[self._bucket_key(src, plan)].append((idx, src, plan))

            inflight = []
            for entries in buckets.values():
                for start in range(0, len(entries), self.max_batch):
                    chunk = entries[start:start + self.max_batch]
                    inflight.append((chunk, self._dispatch_chunk(chunk)))
                    self._collect(inflight, results, keep=self.inflight_batches)
            self._collect(inflight, results)
        return results

    def develop_files(self, paths: list[str], errors: str = "raise"):
        """Streaming decode -> batched develop with decode/compute overlap:
        every bucket is dispatched the moment it reaches max_batch while the
        pool keeps decoding the remaining files; partial buckets go out
        after the last decode. At most `inflight_batches` outputs stay
        unfetched.

        errors: 'raise' aborts the job on the first undecodable file;
        'skip' records a BatchError in that file's slot and the rest
        completes (one corrupt file must not discard a directory's work).
        Either way a decode error has the type the worker raised, and a
        worker that dies raises `BrokenProcessPool`; the next call then
        starts a new pool."""
        if errors not in ("raise", "skip"):
            raise ValueError(f"errors {errors!r}: 'raise' or 'skip'")
        with profiling.request("batch.develop_files"):
            return self._develop_files(paths, errors)

    def _develop_files(self, paths, errors):
        """`develop_files` inside its request span, so that the span also
        holds the end of the pass: the slots taken back."""
        results: list = [None] * len(paths)
        buckets: dict = defaultdict(list)
        inflight = []
        rid = profiling.current_request()
        pool = self._decode
        todo = enumerate(paths)
        try:
            with profiling.span("batch.submit", into=self.timings, key="submit"):
                pool.begin()
                for idx, path in itertools.islice(todo, 2 * self.decode_workers):
                    pool.submit(idx, path)
            while True:
                with profiling.span("batch.decode_wait", into=self.timings, key="decode_wait"):
                    done = pool.next_done()
                    if done is not None:
                        for idx, path in itertools.islice(todo, 1):
                            pool.submit(idx, path)
                if done is None:
                    break
                idx, fut = done
                try:
                    src, seconds, pid, start, end = pool.receive(fut)
                    self.timings["decode"] += seconds
                    profiling.add_span("batch.decode", start, end, thread=pid, request_id=rid)
                    self._note("decoded", idx)
                    plan = self._plan_timed(src)
                except BrokenProcessPool:
                    raise
                except Exception as e:
                    if errors == "raise":
                        raise
                    pool.release(idx)
                    results[idx] = BatchError(paths[idx], e)
                    self._note("error", idx)
                    continue
                key = self._bucket_key(src, plan)
                buckets[key].append((idx, src, plan))
                if len(buckets[key]) >= self.max_batch:
                    self._dispatch_files(buckets.pop(key), inflight, results)
            for chunk in buckets.values():
                self._dispatch_files(chunk, inflight, results)
        finally:
            pool.finish()
        self._collect(inflight, results)
        return results

    def _dispatch_files(self, chunk, inflight, results):
        """Dispatch a chunk of decoded files, give their slots back once
        staged, and collect down to `inflight_batches`."""
        inflight.append((chunk, self._dispatch_chunk(chunk)))
        for idx, _, _ in chunk:
            self._decode.release(idx)
        self._collect(inflight, results, keep=self.inflight_batches)
