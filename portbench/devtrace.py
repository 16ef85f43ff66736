"""The traced run's reading of the device: one `torch.profiler` over the
whole measured window, reduced to a summary (the trace file is written to
the run's scratch directory, read once and deleted).

From the trace: the window (the harness's `portbench.window` annotation),
the seconds in which a kernel, a copy or a fill ran on the card (the union
of their intervals inside the window), the device time of each kernel and
copy by name, the copies device-to-host, and the idle gaps between device
activity, each named by the innermost host operation or annotation running
on the harness's thread at the gap's middle.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10
# The program's kernels by the key of its launch counters (harness.launch_counts):
# a fragment of each kernel's name in the trace.
KERNELS = {"develop": "develop_kernel", "develop_scaled": "scaled_kernel",
           "rotate": "rotate_kernel", "suffix": "suffix_kernel"}


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: dict = field(default_factory=dict)   # name -> seconds
    device_counts: dict = field(default_factory=dict)  # name -> events
    dtoh_count: int = 0
    dtoh_s: float = 0.0
    idle_gaps: dict = field(default_factory=dict)    # host activity -> seconds idle

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of the kernels whose name holds `fragment`."""
        return sum(s for n, s in self.device_ops.items() if fragment in n)

    def kernel_count(self, fragment: str) -> int:
        """Launches in the trace of the kernels whose name holds `fragment`."""
        return sum(c for n, c in self.device_counts.items() if fragment in n)

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


def summarize(prof, scratch: str) -> Summary:
    path = os.path.join(scratch, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return summarize_events(events)


def summarize_events(events) -> Summary:
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in spans if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        return Summary()
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    out = Summary(window_s=(w1 - w0) / 1e6)

    device = []
    ops, counts = defaultdict(float), defaultdict(int)
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        device.append((s, t))
        ops[e["name"]] += (t - s) / 1e6
        counts[e["name"]] += 1
        if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]:
            out.dtoh_count += 1
            out.dtoh_s += (t - s) / 1e6
    out.device_ops, out.device_counts = dict(ops), dict(counts)

    device.sort()
    merged = []
    for s, t in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    out.busy_s = sum(t - s for s, t in merged) / 1e6

    gaps, prev = [], w0
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in spans
                   if e.get("cat") in HOST_CATS and e.get("tid") == win.get("tid")
                   and e.get("pid") == win.get("pid")), key=lambda h: (h[0], -h[1]))
    out.idle_gaps = _name_gaps(gaps, host)
    return out


def _name_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost host span open at each gap's middle
    (spans of one thread nest)."""
    named = defaultdict(float)
    stack, j = [], 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        named[stack[-1][2] if stack else "no host span"] += (g1 - g0) / 1e6
    return dict(named)


# -- what the per-layer metrics' readers share (metrics/<name>.py) -------------

def roofline(run, key: str, kind: str):
    """Percent of their roofline of the window's launches of the kernel
    `key` in a run of traffic `kind`: the sum of their bounds
    (portbench/bounds.py, from the work's shapes) over their device time in
    the trace. None where there is nothing to read, or where the trace
    holds another number of launches than the program counted (the
    harness then names the metric on an earlier line)."""
    trace = run["trace"]
    bound = run["readings"].get("bounds", {}).get(key)
    launches = run["launches"].get(key, 0)
    if run["kind"] != kind or trace is None or not bound or not launches:
        return None
    if trace.kernel_count(KERNELS[key]) != launches:
        return None
    return 100.0 * bound / trace.kernel_s(KERNELS[key])


def idle_pct(run, kind: str):
    """Percent of the traced window with no kernel, copy or fill on the
    card, in a run of traffic `kind`."""
    trace = run["trace"]
    if run["kind"] != kind or trace is None or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def d2h_ms(run, kind: str):
    """Device ms of device-to-host copies per request of the window, in a
    run of traffic `kind`."""
    trace, n = run["trace"], run["readings"].get("requests")
    if run["kind"] != kind or trace is None or not n or not trace.dtoh_count:
        return None
    return trace.dtoh_s * 1e3 / n
