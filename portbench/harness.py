"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one cell is found by name: the workload in
`BENCHMARK.json`; its configuration (`configs/<config>.json`), whose
`container.writer` names the writer of its files (`containers/<writer>.py`);
its traffic (`traffic/<traffic>.json`), whose `kind` names its driver
(`kinds/<kind>.py`); the limits of its check (`checks/<workload>.json`); and
each per-layer metric's reader (`metrics/<metric>.py`, a `read(run)` that
returns a number or None).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from . import devtrace
from .drivers import load_kind, numerics

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "imagepipe_tpu")


def log(msg: str) -> None:
    print(msg, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", os.path.join(HERE, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_lines(device) -> list[str]:
    lines = [f"card: {torch.cuda.get_device_name(device)}"]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        lines.append(f"nvidia-smi name, power limit, SM clock, max SM clock, memory clock: "
                     f"{out.stdout.strip()}")
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"nvidia-smi: {e}")
    return lines


def launch_counts() -> dict:
    """The program's launch counters of the kernels the rooflines read."""
    from imagepipe_tpu_torch.kernels import develop as kdev
    from imagepipe_tpu_torch.kernels import develop_scaled as kds
    from imagepipe_tpu_torch.kernels import rotate as krot
    from imagepipe_tpu_torch.kernels import suffix as ksuf

    return {"develop": kdev.LAUNCHES + kdev.BATCH_LAUNCHES + kdev.SP_LAUNCHES,
            "develop_scaled": kds.LAUNCHES + kds.BATCH_LAUNCHES,
            "rotate": krot.LAUNCHES + krot.CFA_LAUNCHES,
            "suffix": ksuf.LAUNCHES + ksuf.LUT_LAUNCHES}


def compare(got, want: torch.Tensor) -> tuple[int, float]:
    """(max |difference|, share of values that differ) of an output against
    its reference, the difference in steps of the output's type: LSB for an
    integer type (8-bit, 16-bit), 2**-16 of the unit range for a float
    type. An output of another shape or type than the reference reads one
    step past the type's whole range, and 1.0."""
    import numpy as np

    floating = want.is_floating_point()
    steps = 2 ** 16 if floating else 2 ** (8 * want.element_size())
    want_type = np.dtype(str(want.dtype).removeprefix("torch."))
    if not isinstance(got, np.ndarray) or got.dtype != want_type or \
            tuple(got.shape) != tuple(want.shape):
        return steps, 1.0
    got = torch.from_numpy(np.ascontiguousarray(got)).to(want.device)
    if floating:
        d = ((got.double() - want.double()).abs() * steps).ceil()
    else:
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
    return int(d.max()), float((d != 0).double().mean())


def check(driver, limits: dict):
    """Compare the driver's sampled outputs with the float32 reference;
    returns (correct, {number: {value, limit}}, per-output lines)."""
    worst_lsb, worst_frac, lines, n = 0, 0.0, [], 0
    for label, got, want in driver.checks(torch.float32):
        lsb, frac = compare(got, want)
        lines.append(f"check {label}: max |diff| {lsb} LSB, differing {frac!r}")
        worst_lsb, worst_frac, n = max(worst_lsb, lsb), max(worst_frac, frac), n + 1
    numbers = {"max_lsb": {"value": worst_lsb, "limit": limits["max_lsb"]},
               "diff_frac": {"value": worst_frac, "limit": limits["diff_frac"]},
               "outputs_compared": {"value": n, "limit": 1}}
    correct = n >= 1 and worst_lsb <= limits["max_lsb"] and worst_frac <= limits["diff_frac"]
    return correct, numbers, lines


def cell_files(bench: dict, name: str):
    """The workload `name`, its configuration, traffic and check limits."""
    cell = find_workload(bench, name)
    return (cell, load_json(HERE, "configs", f"{cell['config']}.json"),
            load_json(HERE, "traffic", f"{cell['traffic']}.json"),
            load_json(HERE, "checks", f"{name}.json"))


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float, bench: dict):
    """One run of the cell `name` on the card; returns the result object
    (the last line's keys) and the lines of the check."""
    _, config, traffic, limits = cell_files(bench, name)
    device = torch.device("cuda", 0)
    for line in card_lines(device):
        log(line)
    torch.cuda.set_device(device)
    from imagepipe_tpu_torch import native

    log(f"native host library loaded: {native.have_native()} (the cells' uncompressed "
        f"16-bit DNGs decode with numpy alone)")
    scratch = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        driver = load_kind(traffic["kind"])(config, traffic, seed, device, scratch, trace)
        return measure(driver, name, bench, limits, seconds, t_start)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def measure(driver, name: str, bench: dict, limits: dict, seconds: float, t_start: float):
    """Set-up, the window, the readings and the check of one run of
    `driver`, the cell `name`'s traffic on its device."""
    trace = driver.trace
    on_card = driver.device.type == "cuda"
    with numerics(driver.traffic):
        driver.setup()
        records = []
        with contextlib.ExitStack() as traced:
            prof = traced.enter_context(devtrace.profiler()) if trace else None
            counts0 = launch_counts()
            with (torch.profiler.record_function(devtrace.WINDOW) if trace
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                end = t0 + seconds
                while not records or time.perf_counter() < end:
                    records.append(driver.step(len(records)))
                t1 = time.perf_counter()
            launches = {k: v - counts0[k] for k, v in launch_counts().items()}
        summary = devtrace.summarize(prof, driver.scratch) if trace else None
        del prof
        setup_s = t0 - t_start
        parts = ", ".join(f"{k} {v!r}" for k, v in driver.parts.items())
        unit_s = sorted(r["t1"] - r["t0"] for r in records)
        log(f"set-up {setup_s!r} s (from process start; parts: {parts}); window {t1 - t0!r} s, "
            f"{len(records)} units of {unit_s[0]!r} / {unit_s[len(unit_s) // 2]!r} / "
            f"{unit_s[-1]!r} s (least / median / most)")
        memory_peak = torch.cuda.max_memory_allocated(driver.device) if on_card else 0
        readings = driver.readings(records)
        result = {"correct": False, "attempted": driver.attempted(records),
                  "failed": driver.failed(records)}
        if trace:
            metrics = layer_metrics(driver, name, bench, readings, summary, launches, records)
        else:
            metrics = {k: {"value": v, "unit": unit_of(bench, k)}
                       for k, v in driver.end_to_end(records).items()}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        result["metrics"] = metrics
        result["device"] = {"platform": "gpu" if on_card else driver.device.type,
                            "kind": torch.cuda.get_device_name(driver.device) if on_card
                            else "cpu", "count": 1, "memory_peak_bytes": memory_peak}
        if trace:
            result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
            result["breakdown"] = summary.breakdown()
        driver.release()
        if on_card:
            torch.cuda.synchronize(driver.device)
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        correct, numbers, lines = check(driver, limits)
    log(f"check took {time.perf_counter() - t_check!r} s")
    result["correct"] = correct and result["failed"] == 0
    result["checks"] = numbers
    return result, lines


def layer_metrics(driver, name, bench, readings, summary, launches, records) -> dict:
    """The cell's per-layer metrics from their readers. A metric whose
    reader finds nothing is left out, and named on an earlier line."""
    run = {"kind": driver.traffic["kind"], "readings": readings, "trace": summary,
           "launches": launches}
    metrics = {}
    for key, n in launches.items():
        if n:
            log(f"launches of {key}: {n} counted by the program, "
                f"{summary.kernel_count(devtrace.KERNELS[key])} in the trace")
    if driver.traffic["kind"] != "ingest" and summary.dtoh_count < len(records):
        log(f"the trace holds {summary.dtoh_count} device-to-host copies for "
            f"{len(records)} requests: fewer than one per request")
    for m in bench["per_layer"]:
        if name not in m.get("workloads", [name]):
            continue
        value = metric_reader(m["name"])(run)
        if value is None:
            log(f"per-layer metric {m['name']} read nothing in this run and is left out")
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def unit_of(bench: dict, name: str) -> str:
    for m in bench["end_to_end"]:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)
