"""Timing helpers and the port's spans (counterpart of
`imagepipe_tpu/profiling.py:26-68`).

* `span(name, into=...)` times a phase of the program. With `into` (a dict
  or Counter) it adds the phase's host seconds under `key` (default: the
  span's name), always: `BatchEngine.timings` and `Pipeline.stage_ms` are
  sums of spans. While a `torch.profiler` records (`trace(...)`, or any
  other profiler open on the calling thread), a span also opens a
  `record_function` of its name, so it sits in the profiler's trace on the
  device operations' clock, and it appends an entry to the recorder: name,
  start and end (`perf_counter_ns`), thread, parent span and request id;
  with `device=` a pair of CUDA events on the current stream, resolved to
  device ms by `spans()`. With no profiler recording, a span costs one
  flag check, and a span without `into` is one shared no-op context.
* `request(name)` is a span that starts a request: a fresh id that its
  child spans inherit (a request inside a request is an ordinary child).
  A span run for a request on another thread (a decode worker) is given
  that request's id (`request_id=`, from `current_request()`) and goes to
  the recorder only: a profiler records the thread that opened it. A span
  that ran in another process (a decode worker) is added afterwards from
  its own clock readings (`add_span`).
* `count(name, n)` adds to a counter while a profiler records;
  `recording()` says whether one does.
* `spans()`, `counters()` and `reset()` read and clear the recorder; it
  holds what was recorded since the last `reset()` or `trace()`, at most
  `MAX_SPANS` spans (the rest are counted under "profiling.dropped").
* `trace(logdir)` records a torch.profiler trace (CPU and, where there is
  one, CUDA activity) and writes `trace.json`: open it in Perfetto or
  chrome://tracing.
* `timed_sync(fn)` times calls of `fn` with a device synchronize before the
  clock stops, so the time includes the device work the calls enqueued.

The JAX package's VPU pass census and floor model are TPU-only and not
ported.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time

import torch

__all__ = ["trace", "timed_sync", "device_fence", "span", "request", "current_request",
           "add_span", "recording", "count", "spans", "counters", "reset", "MAX_SPANS"]

MAX_SPANS = 1 << 18

_recording = torch.autograd._profiler_enabled
_request = contextvars.ContextVar("imagepipe_tpu_torch.request", default=None)
_parent = contextvars.ContextVar("imagepipe_tpu_torch.span", default=None)
_request_ids = itertools.count(1)


class _Recorder:
    """The spans and counters recorded while a profiler records. Opening a
    span takes no lock (an id from a counter, one list append): a lock that
    a decode thread holds would hand the interpreter lock to the decoders
    between the calling thread's spans."""

    def __init__(self):
        self.lock = threading.Lock()    # the counters, and a reset
        self.ids = itertools.count()
        self.entries: list[dict] = []
        self.counters = collections.Counter()
        self.roots: dict[int, int] = {}    # request id -> its first span

    def open(self, name, request_id, parent, events) -> dict | None:
        if len(self.entries) >= MAX_SPANS:
            with self.lock:
                self.counters["profiling.dropped"] += 1
            return None
        if parent is None and request_id is not None:
            parent = self.roots.get(request_id)
        entry = {"id": next(self.ids), "name": name, "start_ns": time.perf_counter_ns(),
                 "end_ns": None, "thread": threading.get_ident(), "parent": parent,
                 "request": request_id, "device_ms": None, "_events": events}
        self.entries.append(entry)
        if request_id is not None:
            self.roots.setdefault(request_id, entry["id"])
        return entry


_REC = _Recorder()


class _NoSpan:
    """The span of a phase with nothing to record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _Timer:
    """A span with no profiler recording: its host seconds into `into`."""

    __slots__ = ("into", "key", "t0")

    def __init__(self, into, key):
        self.into, self.key = into, key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.into[self.key] = self.into.get(self.key, 0.0) + time.perf_counter() - self.t0
        return False


class _Span:
    """A span while a profiler records (or one run for a request on another
    thread): the timer, the recorder's entry, and on the opening thread a
    `record_function`."""

    __slots__ = ("name", "into", "key", "device", "request_id", "fresh", "t0", "entry", "rf",
                 "tokens")

    def __init__(self, name, into, key, device, request_id, fresh):
        self.name, self.into, self.key = name, into, key
        self.device, self.request_id, self.fresh = device, request_id, fresh

    def __enter__(self):
        # The clock and the recorder's entry enclose the record_function:
        # entering and leaving it runs a torch op, which can let go of the
        # interpreter lock, and the wait to take it back (behind the decode
        # threads) belongs to this span.
        self.t0 = time.perf_counter()
        self.tokens = []
        worker = self.request_id is not None
        rid = self.request_id if worker else _request.get()
        if rid is None and self.fresh:
            rid = next(_request_ids)
            self.tokens.append((_request, _request.set(rid)))
        events = _events(self.device)
        if events:
            events[1].record(events[0])
        self.entry = _REC.open(self.name, rid, None if worker else _parent.get(), events)
        if self.entry is not None:
            self.tokens.append((_parent, _parent.set(self.entry["id"])))
        self.rf = None
        if not worker:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.entry is not None:
            if self.entry["_events"]:
                stream, _, end = self.entry["_events"]
                end.record(stream)
            self.entry["end_ns"] = time.perf_counter_ns()
        for var, token in reversed(self.tokens):
            var.reset(token)
        if self.into is not None:
            key = self.name if self.key is None else self.key
            self.into[key] = self.into.get(key, 0.0) + time.perf_counter() - self.t0
        return False


def _events(device):
    """(stream, start, end): the current stream of `device` (True: of the
    current CUDA device) and two timing events for it; None for no device
    or one that is not CUDA."""
    if not device:
        return None
    if device is True:
        if not torch.cuda.is_initialized():
            return None
        device = None
    elif torch.device(device).type != "cuda":
        return None
    return (torch.cuda.current_stream(device), torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def span(name: str, *, into=None, key: str | None = None, device=False,
         request_id: int | None = None):
    """Context manager timing one phase named `name` (module docstring).
    into: a dict or Counter that gets the phase's host seconds under `key`
    (default `name`). device: record CUDA events on the current stream of
    this device (True: the current one) while a profiler records.
    request_id: the span runs on another thread for this request (from
    `current_request()`; None there means nothing is recorded)."""
    if request_id is None and not _recording():
        return _NO_SPAN if into is None else _Timer(into, name if key is None else key)
    return _Span(name, into, key, device, request_id, False)


def request(name: str):
    """A span that opens a request with a fresh id, inherited by the spans
    opened inside it; inside another request, an ordinary child span."""
    if not _recording():
        return _NO_SPAN
    return _Span(name, None, None, False, None, True)


def current_request() -> int | None:
    """The id of the request open in this context while a profiler
    records, for the spans another thread runs for it; else None."""
    return _request.get() if _recording() else None


def add_span(name: str, start_ns: int, end_ns: int, *, thread: int,
             request_id: int | None) -> None:
    """Record a span that ran in another process for the request
    `request_id` (from `current_request()`; None records nothing), from
    `start_ns` to `end_ns` of that process's `time.perf_counter_ns`. On
    Linux that is CLOCK_MONOTONIC, one clock for every process of the
    host, so the span sits on the recorder's clock. `thread` names the
    process (its pid); the parent is the request's first span."""
    if request_id is None:
        return
    entry = _REC.open(name, request_id, None, None)
    if entry is not None:
        entry.update(start_ns=start_ns, end_ns=end_ns, thread=thread)


def recording() -> bool:
    """True while a profiler records: spans and counters are kept."""
    return _recording()


def count(name: str, n: int = 1) -> None:
    """Add `n` to the recorder's counter `name` while a profiler records."""
    if _recording():
        with _REC.lock:
            _REC.counters[name] += n


def spans() -> list[dict]:
    """The recorded spans in the order they opened: id, name, start_ns,
    end_ns (None while open), thread, parent (a span id or None), request
    (an id or None) and device_ms (the device time between the span's
    CUDA events, else None). Waits for the device work those events
    mark."""
    entries = sorted(_REC.entries, key=lambda e: e["id"])
    out = []
    for e in entries:
        events = e["_events"]
        if events and e["end_ns"] is not None:
            _, start, end = events
            end.synchronize()
            e["device_ms"], e["_events"] = start.elapsed_time(end), None
        out.append({k: v for k, v in e.items() if k != "_events"})
    return out


def counters() -> dict:
    with _REC.lock:
        return dict(_REC.counters)


def reset() -> None:
    """Empty the recorder."""
    with _REC.lock:
        _REC.ids = itertools.count()
        _REC.entries.clear()
        _REC.counters.clear()
        _REC.roots.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace scope (CPU and, where there is one, CUDA
    activity) over an emptied recorder; writes `trace.json` under `logdir`
    and yields the profiler, whose `key_averages()` sum the events by
    name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_fence(out) -> None:
    """Wait until the device has finished the work behind `out` (a tensor,
    or anything with a tensor `.data`, such as an OpBuffer); a no-op for
    host data."""
    data = getattr(out, "data", out)
    if torch.is_tensor(data) and data.device.type == "cuda":
        torch.cuda.synchronize(data.device)


def timed_sync(fn, *args, iters: int = 1, **kwargs):
    """(result, seconds per call) of `iters` calls after one warm-up call,
    with a device fence before each clock read."""
    out = fn(*args, **kwargs)
    device_fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    device_fence(out)
    return out, (time.perf_counter() - t0) / iters
