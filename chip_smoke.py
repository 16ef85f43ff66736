#!/usr/bin/env python3
"""Smoke test of the PyTorch port (imagepipe_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize():
  0. setup: the card's name and power limit; build the CUDA kernels from
     csrc/ (develop.cu and develop_scaled.cu, one nvcc each, in parallel);
  1. each kernel against its plain PyTorch version on the card, at full
     size. The develop kernel: 24 MP Bayer 8-bit and 16-bit linear, 26 MP
     X-Trans, 24 MP mono, a Rotate90 frame and a cropped frame. The
     scaled-demosaic kernel: 24 MP Bayer to 2048, 1024, 320 and 160 wide,
     to 1024 at 16-bit linear, 26 MP X-Trans, Rotate90 and odd-crop frames
     and 61 MP to 1024. Contract: max |diff| <= 1 LSB and fewer than 2% of
     values differing;
  2. the main paths, each with the launch counts set to 0 just before it
     and read just after. Full size: a 24 MP Bayer DNG through
     Pipeline.new_from_file -> output_8bit (default, exposure +0.3, custom
     curve) and output_16bit, then simple_decode_8bit; each request must
     launch the develop kernel exactly once. Thumbnails: the same DNG at
     maxwidth 2048, 1024 (exposure +0.3), 160 and 1024 at 16 bit, then
     simple_decode_8bit(maxwidth=1024); each must launch the scaled kernel
     exactly once and the develop kernel never. Every request must agree
     with the plain version. Then a 'fulldown' request (maxwidth 4000)
     must launch neither kernel; small frames developed on the card must
     agree with the CPU engine, and a raster downscale with the CPU;
  3. kernels and plain versions timed with CUDA events, interleaved,
     median of 7: the develop kernel at 24 MP 8-bit, the scaled kernel at
     24 MP to 2048, 1024 and 160; the host wall time and breakdown of a
     cached 1024-px request.

It prints a JSON line of per-kernel results, then, as its last line,
{"ok": true, "device": {...}}. It exits non-zero, printing no result,
when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import imagepipe_tpu_torch as ipt
from imagepipe_tpu_torch import _host
from imagepipe_tpu_torch.engine import develop_fused, make_develop_plan
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds

BAYER = (6000, 4000)
XTRANS = (6240, 4168)
BIG = (9504, 6336)
THUMB_WIDTHS = (2048, 1024, 160)      # timed in phase 3
TIMED_RUNS = 7


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _check(label, got, want) -> int:
    """Hold two quantized images to the contract (kdev.MAX_LSB,
    kdev.MAX_FLIP_FRACTION); returns the max |diff|."""
    maxd, frac = kdev.compare(got, want)
    print(f"  {label}: max |diff| {maxd}, differing {frac:.6f}")
    if maxd > kdev.MAX_LSB or frac >= kdev.MAX_FLIP_FRACTION:
        raise AssertionError(f"{label}: max |diff| {maxd}, differing {frac} (limits "
                             f"{kdev.MAX_LSB}, {kdev.MAX_FLIP_FRACTION})")
    return maxd


def _plan(raw, bits, device, numerics="auto", maxwidth=0):
    pipe = ipt.Pipeline.new_from_source(_host.ImageSource.from_raw(raw), device)
    pipe.globals.settings.linear = bits == 16
    pipe.globals.settings.maxwidth = maxwidth
    return make_develop_plan(pipe, out_bits=bits, numerics=numerics)


def _reset_counts():
    kdev.LAUNCHES = 0
    kds.LAUNCHES = 0


def _upload(raw, device):
    return torch.from_numpy(np.ascontiguousarray(raw.data)).to(device)


def phase1(device, bayer, xtrans, big) -> tuple[int, int]:
    """Each kernel vs its plain version at full size; returns the largest
    |diff| of the develop and of the scaled kernel."""
    bw, bh = bayer
    base = _host.synthetic_bayer(bw, bh, seed=0)
    rotated = _host.synthetic_bayer(bw, bh, seed=0)
    rotated.orientation = _host.Orientation.Rotate90
    cropped = _host.synthetic_bayer(bw, bh, seed=0)
    cropped.crops = (3, 5, 7, 11)          # odd left crop re-anchors the CFA
    cases = [
        ("bayer 8-bit", base, 8),
        ("bayer 16-bit linear", base, 16),
        ("x-trans 8-bit", _host.synthetic_xtrans(*xtrans, seed=0), 8),
        ("mono 8-bit", _host.synthetic_mono(bw, bh, seed=0), 8),
        ("bayer Rotate90 8-bit", rotated, 8),
        ("bayer cropped 8-bit", cropped, 8),
    ]
    worst = 0
    for label, raw, bits in cases:
        plan = _plan(raw, bits, device)
        plane = _upload(raw, device)
        got = kdev.develop(plan, plane)
        want = kdev.develop_plain(plan, plane)
        _sync(device)
        worst = max(worst, _check(f"{label} {raw.width}x{raw.height}", got, want))

    odd = _host.synthetic_bayer(bw + 16, bh + 10, seed=0)
    odd.crops = (3, 5, 7, 11)              # odd origin on both axes
    thumbs = [(f"bayer -> {w}", base, w, 8) for w in (2048, 1024, 320, 160)] + [
        ("bayer -> 1024 16-bit linear", base, 1024, 16),
        ("x-trans -> 1024", cases[2][1], 1024, 8),
        ("bayer Rotate90 -> 1024", rotated, 1024, 8),
        ("bayer odd crop -> 1024", odd, 1024, 8),
        ("bayer 61 MP -> 1024", _host.synthetic_bayer(*big, seed=0), 1024, 8),
    ]
    worst_scaled = 0
    for label, raw, maxwidth, bits in thumbs:
        plan = _plan(raw, bits, device, maxwidth=maxwidth)
        if plan.dem_path != "scaled":
            raise AssertionError(f"{label}: dem_path {plan.dem_path}, want 'scaled'")
        plane = _upload(raw, device)
        got = kds.develop_scaled(plan, plane)
        want = kds.develop_scaled_plain(plan, plane)
        _sync(device)
        if tuple(got.shape[1:]) not in ((plan.dem_h, plan.dem_w), (plan.dem_w, plan.dem_h)):
            raise AssertionError(f"{label}: shape {tuple(got.shape)}")
        worst_scaled = max(worst_scaled, _check(
            f"{label} {raw.width}x{raw.height} -> {plan.dem_w}x{plan.dem_h}", got, want))
    return worst, worst_scaled


def phase2(device, bayer) -> tuple[int, int]:
    """The main paths through the port's entry points; returns the develop
    kernel's launches on the full-size path and the scaled kernel's on the
    thumbnail path."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bayer.dng")
        _host.write_dng(path, _host.synthetic_bayer(*bayer, seed=1))

        def set_exposure(p):
            p.ops.basecurve.exposure = 0.3

        def set_curve(p):
            p.ops.basecurve.exposure = 0.0
            p.ops.basecurve.points = [(0.2, 0.15), (0.5, 0.62), (0.8, 0.9)]

        requests = [("default output_8bit", None, 8), ("exposure +0.3", set_exposure, 8),
                    ("custom curve", set_curve, 8), ("output_16bit", None, 16)]
        _reset_counts()
        pipe = ipt.Pipeline.new_from_file(path, device)
        bw, bh = bayer
        for label, edit, bits in requests:
            if edit is not None:
                edit(pipe)
            before = kdev.LAUNCHES
            t = time.perf_counter()
            img = pipe.output_8bit(None) if bits == 8 else pipe.output_16bit(None)
            _sync(device)
            ms = (time.perf_counter() - t) * 1e3
            want_dtype = np.uint8 if bits == 8 else np.uint16
            if img.data.shape != (bh, bw, 3) or img.data.dtype != want_dtype:
                raise AssertionError(f"{label}: {img.data.shape} {img.data.dtype}")
            if device.type == "cuda" and kdev.LAUNCHES != before + 1:
                raise AssertionError(f"{label}: {kdev.LAUNCHES - before} kernel launches, want 1")
            plan = pipe._fused_plan_cached(bits)
            want = kdev.develop_plain(plan, pipe._sensor_plane())
            print(f"  request '{label}': {img.data.shape} {img.data.dtype}, host wall {ms:.1f} ms")
            _check(f"'{label}' vs plain", img.data, want.permute(1, 2, 0))
        before = kdev.LAUNCHES
        img = ipt.simple_decode_8bit(path, device=device)
        _sync(device)
        if img.data.shape != (bh, bw, 3):
            raise AssertionError(f"simple_decode_8bit: {img.data.shape}")
        if device.type == "cuda" and kdev.LAUNCHES != before + 1:
            raise AssertionError("simple_decode_8bit did not launch the kernel once")
        print(f"  simple_decode_8bit: {img.data.shape} {img.data.dtype}")
        launches, stray = kdev.LAUNCHES, kds.LAUNCHES
        if device.type == "cuda" and (launches == 0 or stray != 0):
            raise AssertionError(f"full-size path: {launches} develop, {stray} scaled launches")

        scaled_launches = _thumbnails(device, path, set_exposure)

        # A small frame on the card against the CPU engine in the same
        # numerics (the CPU engine is what the tests hold to the JAX package).
        small = os.path.join(td, "small.dng")
        _host.write_dng(small, _host.synthetic_xtrans(168, 112, seed=2))
        on_card = ipt.Pipeline.new_from_file(small, device).output_8bit().data
        cpu = ipt.Pipeline.new_from_file(small, "cpu")
        want = develop_fused(make_develop_plan(cpu, out_bits=8, numerics="direct"),
                             cpu._sensor_plane())
        _check("small x-trans frame, card vs CPU engine", on_card, want.permute(1, 2, 0))
        _fulldown_and_raster(device, path, td)
    return launches, scaled_launches


def _thumbnails(device, path, set_exposure) -> int:
    """The thumbnail path; returns the scaled kernel's launches."""
    requests = [("maxwidth 2048", 2048, None, 8),
                ("maxwidth 1024, exposure +0.3", 1024, set_exposure, 8),
                ("maxwidth 160", 160, None, 8), ("maxwidth 1024, 16-bit", 1024, None, 16)]
    _reset_counts()
    pipe = ipt.Pipeline.new_from_file(path, device)
    for label, maxwidth, edit, bits in requests:
        pipe.globals.settings.maxwidth = maxwidth
        if edit is not None:
            edit(pipe)
        before = (kdev.LAUNCHES, kds.LAUNCHES)
        t = time.perf_counter()
        img = pipe.output_8bit(None) if bits == 8 else pipe.output_16bit(None)
        _sync(device)
        ms = (time.perf_counter() - t) * 1e3
        plan = pipe._fused_plan_cached(bits)
        if img.data.shape != (plan.dem_h, plan.dem_w, 3) or img.data.shape[1] != maxwidth:
            raise AssertionError(f"{label}: {img.data.shape}, plan {plan.dem_w}x{plan.dem_h}")
        if device.type == "cuda" and (kdev.LAUNCHES, kds.LAUNCHES) != (before[0], before[1] + 1):
            raise AssertionError(f"{label}: {kdev.LAUNCHES - before[0]} develop, "
                                 f"{kds.LAUNCHES - before[1]} scaled launches, want 0 and 1")
        want = kds.develop_scaled_plain(plan, pipe._sensor_plane())
        print(f"  request '{label}': {img.data.shape} {img.data.dtype}, host wall {ms:.1f} ms")
        _check(f"'{label}' vs plain", img.data, want.permute(1, 2, 0))
    before = (kdev.LAUNCHES, kds.LAUNCHES)
    img = ipt.simple_decode_8bit(path, maxwidth=1024, device=device)
    _sync(device)
    if img.data.shape[1] != 1024:
        raise AssertionError(f"simple_decode_8bit(maxwidth=1024): {img.data.shape}")
    if device.type == "cuda" and (kdev.LAUNCHES, kds.LAUNCHES) != (before[0], before[1] + 1):
        raise AssertionError("simple_decode_8bit(maxwidth=1024) did not launch the scaled kernel once")
    print(f"  simple_decode_8bit(maxwidth=1024): {img.data.shape} {img.data.dtype}")
    launches, stray = kds.LAUNCHES, kdev.LAUNCHES
    if device.type == "cuda" and (launches == 0 or stray != 0):
        raise AssertionError(f"thumbnail path: {launches} scaled, {stray} develop launches")
    return launches


def _fulldown_and_raster(device, path, td):
    """A 'fulldown' request runs the eager engine on the card and launches
    neither kernel; small 'fulldown' and 'scaled' frames and a raster
    downscale on the card agree with the CPU."""
    pipe = ipt.Pipeline.new_from_file(path, device)
    pipe.globals.settings.maxwidth = 4000
    before = (kdev.LAUNCHES, kds.LAUNCHES)
    img = pipe.output_8bit(None)
    _sync(device)
    plan = pipe._fused_plan_cached(8)
    if plan.dem_path != "fulldown" or img.data.shape != (plan.dem_h, 4000, 3):
        raise AssertionError(f"fulldown: {plan.dem_path} {img.data.shape}")
    if (kdev.LAUNCHES, kds.LAUNCHES) != before:
        raise AssertionError("the fulldown request launched a kernel")
    print(f"  request 'maxwidth 4000' (fulldown, eager engine): {img.data.shape}, no launches")

    small = os.path.join(td, "small_bayer.dng")
    _host.write_dng(small, _host.synthetic_bayer(600, 400, seed=4))
    for maxwidth, dem_path in ((400, "fulldown"), (100, "scaled")):
        on_card = ipt.Pipeline.new_from_file(small, device)
        cpu = ipt.Pipeline.new_from_file(small, "cpu")
        for p in (on_card, cpu):
            p.globals.settings.maxwidth = maxwidth
        got = on_card.output_8bit().data
        plan = make_develop_plan(cpu, out_bits=8, numerics="direct")
        if plan.dem_path != dem_path:
            raise AssertionError(f"small frame to {maxwidth}: {plan.dem_path}")
        want = develop_fused(plan, cpu._sensor_plane())
        _check(f"small bayer {dem_path} frame, card vs CPU engine", got, want.permute(1, 2, 0))

    from PIL import Image

    yy, xx = np.mgrid[0:3000, 0:4000]
    rgb = np.stack([xx * 255 // 3999, yy * 255 // 2999, (xx + yy) % 256], -1).astype(np.uint8)
    png = os.path.join(td, "raster.png")
    Image.fromarray(rgb).save(png, compress_level=1)
    outs = []
    for dev in (device, "cpu"):
        p = ipt.Pipeline.new_from_file(png, dev)
        p.globals.settings.maxwidth = 1024
        outs.append(p.output_8bit().data)
    if outs[0].shape != (768, 1024, 3):
        raise AssertionError(f"raster downscale: {outs[0].shape}")
    _check("raster 4000x3000 -> 1024, card vs CPU", outs[0], outs[1])


def _time_ms(fn, device) -> float:
    """Device ms of one call, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def _interleaved(kernel, plain, device) -> tuple[float, float, list, list]:
    """Median device ms of kernel and plain version, timed in turns (plain,
    kernel, kernel, plain, ...) after a warm-up; also the runs."""
    for fn in (kernel, plain, kernel, plain):
        fn()
    torch.cuda.synchronize(device)
    k_ms, p_ms = [], []
    for i in range(TIMED_RUNS):
        order = (plain, kernel) if i % 2 == 0 else (kernel, plain)
        for fn in order:
            (k_ms if fn is kernel else p_ms).append(_time_ms(fn, device))
    return statistics.median(k_ms), statistics.median(p_ms), k_ms, p_ms


def phase3(device, bayer, card):
    """Returns {kernel name: (ms, plain_ms)}: the develop kernel at 24 MP
    8-bit, the scaled kernel at 24 MP -> 1024."""
    raw = _host.synthetic_bayer(*bayer, seed=3)
    plan = _plan(raw, 8, device)
    plane = _upload(raw, device)
    ms, pms, k_ms, p_ms = _interleaved(lambda: kdev.develop(plan, plane),
                                       lambda: kdev.develop_plain(plan, plane), device)
    mp = bayer[0] * bayer[1] / 1e6
    print(f"  develop kernel: {ms:.4f} ms median of {TIMED_RUNS} ({mp / ms * 1e3:.1f} MP/s), "
          f"runs {[round(t, 4) for t in k_ms]}")
    print(f"  plain version:  {pms:.4f} ms median of {TIMED_RUNS} ({mp / pms * 1e3:.1f} MP/s), "
          f"runs {[round(t, 4) for t in p_ms]}")
    print(f"  ({mp:.0f} MP Bayer 8-bit, CUDA events, on {card})")
    times = {"develop": (ms, pms)}

    for width in THUMB_WIDTHS:
        tplan = _plan(raw, 8, device, maxwidth=width)
        sms, spms, k_ms, p_ms = _interleaved(lambda: kds.develop_scaled(tplan, plane),
                                             lambda: kds.develop_scaled_plain(tplan, plane),
                                             device)
        print(f"  scaled kernel -> {tplan.dem_w}x{tplan.dem_h}: {sms:.4f} ms, plain "
              f"{spms:.4f} ms (medians of {TIMED_RUNS}; kernel runs "
              f"{[round(t, 4) for t in k_ms]}, plain runs {[round(t, 4) for t in p_ms]})")
        if width == 1024:
            times["develop_scaled"] = (sms, spms)
    print(f"  ({mp:.0f} MP Bayer source, 8-bit, CUDA events, on {card})")

    # A cached 1024-px request: plan and plane on the card, and its parts.
    pipe = ipt.Pipeline.new_from_source(_host.ImageSource.from_raw(raw), device)
    pipe.globals.settings.maxwidth = 1024
    pipe.output_8bit(None)
    walls = []
    for _ in range(TIMED_RUNS):
        t = time.perf_counter()
        pipe.output_8bit(None)
        walls.append((time.perf_counter() - t) * 1e3)
    tplan = pipe._fused_plan_cached(8)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    up = _upload(raw, device)
    torch.cuda.synchronize(device)
    up_ms = (time.perf_counter() - t) * 1e3
    out = kds.develop_scaled(tplan, up)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    out.cpu()
    d2h_ms = (time.perf_counter() - t) * 1e3
    print(f"  cached 1024-px output_8bit: host wall {statistics.median(walls):.4f} ms median of "
          f"{TIMED_RUNS}, runs {[round(w, 4) for w in walls]}; upload of the u16 plane "
          f"{up_ms:.4f} ms (once per frame), kernel {times['develop_scaled'][0]:.4f} ms, "
          f"D2H of the {out.numel()} B output {d2h_ms:.4f} ms (on {card})")
    return times


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device = torch.device("cuda", 0)
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    t = time.perf_counter()
    lib = kdev.build()
    print(f"phase 0: built {lib.name} from {sorted(p.name for p in kdev._CSRC.glob('*.cu'))} "
          f"in {time.perf_counter() - t:.1f} s")

    print("phase 1: kernels vs plain versions, full size")
    max_err, max_err_scaled = phase1(device, BAYER, XTRANS, BIG)
    print("phase 2: main paths")
    launches, scaled_launches = phase2(device, BAYER)
    print("phase 3: timing")
    times = phase3(device, BAYER, card)

    print(json.dumps({"kernels": [
        {"name": "develop", "route": "cuda",
         "source": "imagepipe_tpu_torch/csrc/develop.cu",
         "replaces": "imagepipe_tpu/kernels/develop_pallas.py:143",
         "launches": launches, "max_abs_err": max_err,
         "ms": times["develop"][0], "plain_ms": times["develop"][1]},
        {"name": "develop_scaled", "route": "cuda",
         "source": "imagepipe_tpu_torch/csrc/develop_scaled.cu",
         "replaces": "imagepipe_tpu/kernels/develop_scaled.py:391,500",
         "launches": scaled_launches, "max_abs_err": max_err_scaled,
         "ms": times["develop_scaled"][0], "plain_ms": times["develop_scaled"][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
