"""Timing helpers (counterpart of `imagepipe_tpu/profiling.py:26-68`).

* per-stage host times come from the pipeline (`Pipeline.stage_ms`, and
  the `_timing` log lines at INFO);
* device-accurate traces come from torch.profiler via `trace(...)`:
  open the exported Chrome trace in Perfetto or chrome://tracing;
* `timed_sync(fn)` times calls of `fn` with a device synchronize before the
  clock stops, so the time includes the device work the calls enqueued.

The JAX package's VPU pass census and floor model are TPU-only and not
ported.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "timed_sync", "device_fence"]


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace scope (CPU and, where there is one, CUDA
    activity); writes `trace.json` under `logdir` and yields the profiler,
    whose `key_averages()` sum the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
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
