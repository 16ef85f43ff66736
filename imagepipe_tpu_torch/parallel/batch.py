"""Batched multi-device develop engine.

Counterpart of `imagepipe_tpu/parallel/batch.py`. A file list is decoded by
a host thread pool, bucketed by shape class, and each bucket is developed
`max_batch` images at a time, every image with its own calibration:

  * Routing by plan, never a fallback on failure: full-size cfa/mono plans
    and 'scaled' cfa plans in 'direct' numerics go to the batched kernels
    (`kernels.develop.develop_batch`, `kernels.develop_scaled.
    develop_scaled_batch`, one launch per chunk); every other plan goes to
    the eager engine (`engine.develop_batch_perimage`). On the CPU the
    kernel wrappers run their plain versions.
  * A bucket is keyed by the plan's statics plus the sensor plane's shape
    and dtype: a batched launch takes one row stride.
  * Data parallel: chunks go round-robin over `devices`, every CUDA device
    by default. Each chunk runs whole on one device, so nothing is padded.
    There is no spatial (width-sharded) axis: ROADMAP A11.

Decode/compute overlap: `develop_files` dispatches a bucket the moment it
fills while the pool keeps decoding. Dispatch does not wait for the card:
the chunk is staged into a pinned host buffer [B, H0, W0], copied to the
card with `non_blocking=True` on the device's current stream, developed,
and its output copied back into pinned memory with `non_blocking=True`,
where a CUDA event marks the end. `_collect` waits on the oldest event,
copies the images out of pinned memory into the results (no result aliases
a pinned buffer) and leaves at most `inflight_batches` chunks unfetched, so
the pinned and device memory held is bounded by that and not by the length
of the file list. Only the calling thread touches CUDA; decode threads
return numpy.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import time
from collections import defaultdict

import numpy as np
import torch

from .. import color as cc
from ..decode import decode_file
from ..engine import develop_batch_perimage, make_develop_plan, normalize_plane_np
from ..kernels import develop as kdev
from ..kernels import develop_scaled as kds
from ..pipeline import Pipeline, default_device
from ..sources import ImageSource

__all__ = ["BatchEngine", "BatchError", "default_decode_workers"]


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
    worker per available core (affinity-aware), capped at 16: the fujic and
    DNG decoders spin their own small pools per file."""
    try:
        ncpu = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        ncpu = os.cpu_count() or 4
    return max(1, min(16, ncpu))


def _all_cuda_devices() -> list:
    default_device()    # raises when there is no CUDA device
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _timed_decode(path):
    t = time.perf_counter()
    src = decode_file(path)
    return src, time.perf_counter() - t


class BatchEngine:
    """Develop many RAW files concurrently on one or more devices.

    devices: the devices chunks go to in turn; default every CUDA device
    (raises without one). out_bits: 8 (sRGB) or 16 (linear). max_batch:
    images per launch. decode_workers: decode threads (default
    `default_decode_workers()`). maxwidth / maxheight: thumbnail limits, 0
    for none. executor: 'auto' or 'kernel' (the batched kernels for the
    plans they take; the two are the same here, as no plan prefers the
    eager engine) or 'eager'. inflight_batches: chunks left unfetched at
    most. spatial: only 1 (a width-sharded axis is ROADMAP A11)."""

    def __init__(self, devices=None, out_bits: int = 8, max_batch: int = 8,
                 decode_workers: int | None = None, maxwidth: int = 0,
                 maxheight: int = 0, executor: str = "auto",
                 inflight_batches: int = 2, spatial: int = 1):
        if spatial != 1:
            raise NotImplementedError("BatchEngine spatial (width-sharded) axis: ROADMAP A11")
        if executor not in ("auto", "eager", "kernel"):
            raise ValueError(f"executor {executor!r}: 'auto', 'eager' or 'kernel'")
        self.devices = [torch.device(d) for d in
                        (_all_cuda_devices() if devices is None else devices)]
        if not self.devices or len({d.type for d in self.devices}) != 1:
            raise ValueError(f"devices {self.devices}: one or more of one type")
        # 'direct' numerics on CUDA (the kernels' form), 'lut' on the CPU.
        self.numerics = cc.resolve_numerics("auto", self.devices[0])
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
        # Host seconds by stage, summed over calls: decode (in the pool's
        # threads), plan, stage (into pinned buffers), dispatch (enqueue of
        # copies and launches), wait (for the card, in _collect), scatter
        # (out of pinned buffers into the results).
        self.timings = collections.Counter()
        # Test/observability hook: when set to a list, (event, payload)
        # tuples are appended on every decode, dispatch, collect and error.
        self._events: list | None = None
        self._next_device = 0

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

    def _develop(self, plans, planes: torch.Tensor) -> torch.Tensor:
        if not self._use_kernel(plans[0]):
            return develop_batch_perimage([p.to(planes.device) for p in plans], planes)
        if plans[0].dem_path == "scaled":
            return kds.develop_scaled_batch(plans, planes)
        return kdev.develop_batch(plans, planes)

    def _stage(self, chunk, pin: bool) -> torch.Tensor:
        """The chunk's normalized sensor planes stacked on the host."""
        first = normalize_plane_np(chunk[0][2], chunk[0][1].raw.data)
        dtype = torch.from_numpy(first[:0]).dtype
        buf = torch.empty((len(chunk), *first.shape), dtype=dtype, pin_memory=pin)
        host = buf.numpy()
        for i, (_, src, plan) in enumerate(chunk):
            host[i] = normalize_plane_np(plan, src.raw.data)
        return buf

    def _dispatch_chunk(self, chunk):
        """Stage one bucket chunk and enqueue its develop on the next device.
        Returns (output on the host, event or None): on CUDA the output is a
        pinned buffer that is complete once the event has fired."""
        device = self.devices[self._next_device % len(self.devices)]
        self._next_device += 1
        plans = [plan for _, _, plan in chunk]
        t0 = time.perf_counter()
        if device.type != "cuda":
            planes = self._stage(chunk, pin=False).to(device)
            t1 = time.perf_counter()
            out, done = self._develop(plans, planes), None
        else:
            with torch.cuda.device(device):
                staged = self._stage(chunk, pin=True)
                t1 = time.perf_counter()
                planes = staged.to(device, non_blocking=True)
                dev_out = self._develop(plans, planes)
                out = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
                out.copy_(dev_out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        self.timings["stage"] += t1 - t0
        self.timings["dispatch"] += time.perf_counter() - t1
        self._note("dispatch", len(chunk))
        return out, done

    def _collect(self, inflight, results, keep: int = 0):
        """Fetch finished outputs (oldest first) into `results` in input
        order, leaving at most `keep` chunks in flight. Each result is an
        [H', W', 3] view of its own planar copy, as the JAX package's
        `planar_to_hwc` returns: a contiguous HWC copy is a strided
        transpose, several times slower than the plain copy."""
        while len(inflight) > keep:
            chunk, (out, done) = inflight.pop(0)
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            t1 = time.perf_counter()
            planar = out.numpy()
            for (idx, _, _), img in zip(chunk, planar):
                results[idx] = np.moveaxis(img.copy(), 0, -1)
            self.timings["wait"] += t1 - t0
            self.timings["scatter"] += time.perf_counter() - t1
            self._note("collected", len(chunk))

    def _plan_timed(self, src):
        t = time.perf_counter()
        plan = self._plan_for(src)
        self.timings["plan"] += time.perf_counter() - t
        return plan

    def develop_sources(self, sources: list[ImageSource]):
        """Develop a list of RAW sources; returns [H', W', 3] numpy outputs
        in input order. Sources are bucketed by shape class."""
        results: list = [None] * len(sources)
        buckets: dict = defaultdict(list)
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
        completes (one corrupt file must not discard a directory's work)."""
        if errors not in ("raise", "skip"):
            raise ValueError(f"errors {errors!r}: 'raise' or 'skip'")
        results: list = [None] * len(paths)
        buckets: dict = defaultdict(list)
        inflight = []
        with cf.ThreadPoolExecutor(self.decode_workers) as pool:
            futs = {pool.submit(_timed_decode, p): i for i, p in enumerate(paths)}
            for fut in cf.as_completed(futs):
                idx = futs[fut]
                try:
                    src, seconds = fut.result()
                    self.timings["decode"] += seconds
                    self._note("decoded", idx)
                    plan = self._plan_timed(src)
                except Exception as e:
                    if errors == "raise":
                        raise
                    results[idx] = BatchError(paths[idx], e)
                    self._note("error", idx)
                    continue
                key = self._bucket_key(src, plan)
                buckets[key].append((idx, src, plan))
                if len(buckets[key]) >= self.max_batch:
                    chunk = buckets.pop(key)
                    inflight.append((chunk, self._dispatch_chunk(chunk)))
                    self._collect(inflight, results, keep=self.inflight_batches)
            for chunk in buckets.values():
                inflight.append((chunk, self._dispatch_chunk(chunk)))
                self._collect(inflight, results, keep=self.inflight_batches)
        self._collect(inflight, results)
        return results
