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
  1b. the batched kernels: develop_batch at B=4 of 24 MP Bayer with four
     WB/exposure settings, 8-bit and 16-bit linear; develop_scaled_batch at
     B=8 of 24 MP Bayer and B=4 of 26 MP X-Trans to 1024 wide. Each batch
     must be bit-equal to its single-image launches and hold the contract
     against its plain version;
  2b. the batch path through its entry point: 16 DNGs of 24 MP Bayer (WB
     varied, half of them Rotate90), 4 of 26 MP X-Trans and one corrupt
     file through BatchEngine(max_batch=8).develop_files(errors="skip").
     The corrupt slot must be a BatchError, every other result agree with
     its single-image plain develop, and the run make exactly 3 launches
     of develop_batch (2 Bayer buckets, 1 X-Trans) and none of the other
     kernels; at maxwidth 1024 exactly 3 of develop_scaled_batch only;
  3. kernels and plain versions timed with CUDA events, interleaved,
     median of 7: the develop kernel at 24 MP 8-bit, the scaled kernel at
     24 MP to 2048, 1024 and 160; the host wall time and breakdown of a
     cached 1024-px request;
  3b. the batch path timed: develop_files throughput of the 16 Bayer files
     (source MP/s, full size and to 1024), its host split (decode, plan,
     staging, dispatch, wait, scatter) and, under torch.profiler, its
     device split (H2D, kernel, D2H) and idle share; a batched launch at
     B=8 against a loop of 8 single launches and the plain version, 24 MP
     8-bit and to 1024.

It prints a JSON line of per-kernel results (launches on the main path,
max |diff| against the plain version, times, and the bound: the least time
the card could take, from the bytes and float32 operations of this run's
shapes), then, as its last line, {"ok": true, "device": {...}}. It exits
non-zero, printing no result, when there is no CUDA device or any phase
fails.
"""

from __future__ import annotations

import collections
import copy
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
from imagepipe_tpu_torch import dng
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.decode import decode_file
from imagepipe_tpu_torch.engine import develop_fused, make_develop_plan
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds
from imagepipe_tpu_torch.parallel import BatchEngine, BatchError
from imagepipe_tpu_torch.sources import ImageSource

BAYER = (6000, 4000)
XTRANS = (6240, 4168)
BIG = (9504, 6336)
THUMB_WIDTHS = (2048, 1024, 160)      # timed in phase 3
TIMED_RUNS = 7
BATCH = 8                             # max_batch of the batch path
BATCH_THUMB = 1024                    # thumbnail width of the batch path
BATCH_REPS = 4                        # calls per timing of a batched launch

# The card's peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit):
# device memory rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 operations the kernels do, counted from csrc/ (an FMA counts 2;
# expf, logf and a division 1 each; index arithmetic not counted).
# finish.cuh per output pixel, 8-bit with gamma and no tone curve: WB 8,
# camera matrix 21, XYZ scaling 3, three lab_f 24, L/A/B 11, Lab^-1 30,
# XYZ->RGB 15, gamma 30, quantize 12.
OPS_FINISH = 154
# develop.cu's demosaic per pixel: levels (3) and accumulate (2) for each
# sample, 7 samples on average over a Bayer quad (9 at R and B, 5 at G),
# then four averages (2 each).
OPS_DEMOSAIC_BAYER = 7 * 5 + 8
# develop_scaled.cu per window sample (weight 3, levels 3, product 1, two
# sums) and per output pixel (four averages, 2 each).
OPS_WINDOW_SAMPLE = 9
OPS_SCALED_PIXEL = 8


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


def _plan(raw, bits, device, numerics="auto", maxwidth=0, exposure=0.0):
    pipe = ipt.Pipeline.new_from_source(ImageSource.from_raw(raw), device)
    pipe.globals.settings.linear = bits == 16
    pipe.globals.settings.maxwidth = maxwidth
    pipe.ops.basecurve.exposure = exposure
    return make_develop_plan(pipe, out_bits=bits, numerics=numerics)


def _reset_counts():
    kdev.LAUNCHES = kdev.BATCH_LAUNCHES = 0
    kds.LAUNCHES = kds.BATCH_LAUNCHES = 0


def _counts() -> dict:
    return {"develop": kdev.LAUNCHES, "develop_scaled": kds.LAUNCHES,
            "develop_batch": kdev.BATCH_LAUNCHES, "develop_scaled_batch": kds.BATCH_LAUNCHES}


def _upload(raw, device):
    return torch.from_numpy(np.ascontiguousarray(raw.data)).to(device)


def phase1(device, bayer, xtrans, big) -> tuple[int, int]:
    """Each kernel vs its plain version at full size; returns the largest
    |diff| of the develop and of the scaled kernel."""
    bw, bh = bayer
    base = traw.synthetic_bayer(bw, bh, seed=0)
    rotated = copy.copy(base)              # the same sensor data
    rotated.orientation = traw.Orientation.Rotate90
    cropped = copy.copy(base)
    cropped.crops = (3, 5, 7, 11)          # odd left crop re-anchors the CFA
    cases = [
        ("bayer 8-bit", base, 8),
        ("bayer 16-bit linear", base, 16),
        ("x-trans 8-bit", traw.synthetic_xtrans(*xtrans, seed=0), 8),
        ("mono 8-bit", traw.synthetic_mono(bw, bh, seed=0), 8),
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

    odd = traw.synthetic_bayer(bw + 16, bh + 10, seed=0)
    odd.crops = (3, 5, 7, 11)              # odd origin on both axes
    thumbs = [(f"bayer -> {w}", base, w, 8) for w in (2048, 1024, 320, 160)] + [
        ("bayer -> 1024 16-bit linear", base, 1024, 16),
        ("x-trans -> 1024", cases[2][1], 1024, 8),
        ("bayer Rotate90 -> 1024", rotated, 1024, 8),
        ("bayer odd crop -> 1024", odd, 1024, 8),
        ("bayer 61 MP -> 1024", traw.synthetic_bayer(*big, seed=0), 1024, 8),
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
        dng.write_dng(path, traw.synthetic_bayer(*bayer, seed=1))

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
        dng.write_dng(small, traw.synthetic_xtrans(168, 112, seed=2))
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
    dng.write_dng(small, traw.synthetic_bayer(600, 400, seed=4))
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


def _time_ms(fn, device, reps=1) -> float:
    """Device ms of one call, timed with CUDA events around `reps` calls
    back to back (from an idle device: with reps=1 the call's host path
    before its launch counts too)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def _in_turns(fns: dict, device, reps=1) -> dict:
    """{name: (median device ms, runs)} of each function, timed in turns
    (the order rotating every round) after a warm-up of two calls each."""
    for _ in range(2):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize(device)
    runs = {name: [] for name in fns}
    names = list(fns)
    for i in range(TIMED_RUNS):
        order = names[i % len(names):] + names[:i % len(names)]
        for name in (order if i % 2 == 0 else order[::-1]):
            runs[name].append(_time_ms(fns[name], device, reps))
    return {name: (statistics.median(r), r) for name, r in runs.items()}


def _bound(read_bytes, write_bytes, ops) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the float32 rate."""
    by_bytes = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def develop_bound(plan, plane) -> tuple[float, str]:
    """The develop kernel's bound for one Bayer plane: the cropped plane
    read once, the quantized planes written once, the counted operations."""
    px = plan.height * plan.width
    return _bound(px * plane.element_size(), 3 * px * plan.out_bits // 8,
                  px * (OPS_DEMOSAIC_BAYER + OPS_FINISH))


def scaled_bound(plan, plane) -> tuple[float, str]:
    """The scaled kernel's bound for one plane: the cropped plane read once,
    the thumbnail written once, and the operations of the window samples
    this geometry has (from its tables) and of each output pixel."""
    g = {k: v.cpu().numpy().astype(np.int64) for k, v in kds.scaled_geometry(plan).items()
         if k in ("from_x", "to_x", "from_y", "to_y")}
    samples = int((g["to_x"] - g["from_x"] + 1).sum()) * int((g["to_y"] - g["from_y"] + 1).sum())
    out_px = plan.dem_h * plan.dem_w
    return _bound(plan.height * plan.width * plane.element_size(), 3 * out_px * plan.out_bits // 8,
                  samples * OPS_WINDOW_SAMPLE + out_px * (OPS_SCALED_PIXEL + OPS_FINISH))


def _timing(name, ms, plain_ms, bound, batch=1) -> dict:
    return {name: {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0] * batch,
                   "bound_by": bound[1]}}


def phase3(device, bayer, card):
    """Returns {kernel name: {ms, plain_ms, bound_ms, bound_by}}: the develop
    kernel at 24 MP 8-bit, the scaled kernel at 24 MP -> 1024."""
    raw = traw.synthetic_bayer(*bayer, seed=3)
    plan = _plan(raw, 8, device)
    plane = _upload(raw, device)
    t = _in_turns({"kernel": lambda: kdev.develop(plan, plane),
                   "plain": lambda: kdev.develop_plain(plan, plane)}, device)
    (ms, k_ms), (pms, p_ms) = t["kernel"], t["plain"]
    mp = bayer[0] * bayer[1] / 1e6
    bound = develop_bound(plan, plane)
    print(f"  develop kernel: {ms:.4f} ms median of {TIMED_RUNS} ({mp / ms * 1e3:.1f} MP/s), "
          f"runs {[round(t, 4) for t in k_ms]}; bound {bound[0]:.4f} ms by {bound[1]}")
    print(f"  plain version:  {pms:.4f} ms median of {TIMED_RUNS} ({mp / pms * 1e3:.1f} MP/s), "
          f"runs {[round(t, 4) for t in p_ms]}")
    print(f"  ({mp:.0f} MP Bayer 8-bit, CUDA events, on {card})")
    times = _timing("develop", ms, pms, bound)

    for width in THUMB_WIDTHS:
        tplan = _plan(raw, 8, device, maxwidth=width)
        t = _in_turns({"kernel": lambda: kds.develop_scaled(tplan, plane),
                       "plain": lambda: kds.develop_scaled_plain(tplan, plane)}, device)
        (sms, k_ms), (spms, p_ms) = t["kernel"], t["plain"]
        sbound = scaled_bound(tplan, plane)
        print(f"  scaled kernel -> {tplan.dem_w}x{tplan.dem_h}: {sms:.4f} ms, plain "
              f"{spms:.4f} ms (medians of {TIMED_RUNS}; kernel runs "
              f"{[round(t, 4) for t in k_ms]}, plain runs {[round(t, 4) for t in p_ms]}); "
              f"bound {sbound[0]:.4f} ms by {sbound[1]}")
        if width == 1024:
            times.update(_timing("develop_scaled", sms, spms, sbound))
    print(f"  ({mp:.0f} MP Bayer source, 8-bit, CUDA events, on {card})")

    # A cached 1024-px request: plan and plane on the card, and its parts.
    pipe = ipt.Pipeline.new_from_source(ImageSource.from_raw(raw), device)
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
          f"{up_ms:.4f} ms (once per frame), kernel {times['develop_scaled']['ms']:.4f} ms, "
          f"D2H of the {out.numel()} B output {d2h_ms:.4f} ms (on {card})")
    return times


# -- the batch path ------------------------------------------------------

def _variants(bases, n, orientations=("Normal",)):
    """n RawImages over `bases` (shared sensor data), each with its own
    white balance, the orientations taken in turn."""
    out = []
    for i in range(n):
        r = copy.copy(bases[i % len(bases)])
        r.wb_coeffs = (1.5 + 0.1 * i, 1.0, 1.2 + 0.12 * i, float("nan"))
        r.orientation = traw.Orientation(orientations[i % len(orientations)])
        out.append(r)
    return out


def _check_batch(label, got, singles, plain) -> int:
    """A batched launch must equal its single launches bit for bit and hold
    the contract against its plain version; returns the max |diff|."""
    if not torch.equal(got, singles):
        n = int((got != singles).sum())
        raise AssertionError(f"{label}: batched launch differs from single launches in {n} values")
    return _check(f"{label} (bit-equal to single launches) vs plain", got, plain)


def phase1b(device, bayer_bases, xtrans_bases) -> dict:
    """The batched kernels against single launches and plain versions;
    returns the largest |diff| of each against its plain version."""
    worst = {"develop_batch": 0, "develop_scaled_batch": 0}
    raws = _variants(bayer_bases, 4)
    planes = torch.stack([_upload(r, device) for r in raws])
    for bits in (8, 16):
        plans = [_plan(r, bits, device, exposure=e) for r, e in zip(raws, (0.3, -0.2, 0.5, 0.1))]
        got = kdev.develop_batch(plans, planes)
        singles = torch.stack([kdev.develop(p, planes[i]) for i, p in enumerate(plans)])
        plain = kdev.develop_batch_plain(plans, planes)
        _sync(device)
        worst["develop_batch"] = max(worst["develop_batch"], _check_batch(
            f"develop_batch B=4 24 MP Bayer {bits}-bit", got, singles, plain))
    del planes, got, singles, plain

    cases = [(f"B={BATCH} 24 MP Bayer -> {BATCH_THUMB}", _variants(bayer_bases, BATCH)),
             (f"B=4 26 MP X-Trans -> {BATCH_THUMB}", _variants(xtrans_bases, 4))]
    for label, raws in cases:
        plans = [_plan(r, 8, device, maxwidth=BATCH_THUMB) for r in raws]
        if plans[0].dem_path != "scaled":
            raise AssertionError(f"{label}: dem_path {plans[0].dem_path}, want 'scaled'")
        planes = torch.stack([_upload(r, device) for r in raws])
        got = kds.develop_scaled_batch(plans, planes)
        singles = torch.stack([kds.develop_scaled(p, planes[i]) for i, p in enumerate(plans)])
        plain = kds.develop_scaled_batch_plain(plans, planes)
        _sync(device)
        worst["develop_scaled_batch"] = max(worst["develop_scaled_batch"], _check_batch(
            f"develop_scaled_batch {label}", got, singles, plain))
    return worst


def _batch_files(td, bayer_bases, xtrans_bases):
    """16 Bayer DNGs (8 Normal, 8 Rotate90), 4 X-Trans DNGs and one corrupt
    file (at index 5); returns (paths, corrupt index)."""
    raws = _variants(bayer_bases, 16, ("Normal", "Rotate90")) + _variants(xtrans_bases, 4)
    paths = []
    for i, r in enumerate(raws):
        paths.append(os.path.join(td, f"batch_{i:02d}.dng"))
        dng.write_dng(paths[-1], r)
    corrupt = os.path.join(td, "corrupt.dng")
    with open(corrupt, "wb") as f:
        f.write(b"II*\x00 not a raw file")
    paths.insert(5, corrupt)
    return paths, 5


def _run_batch(device, paths, corrupt, maxwidth, want_counts, label):
    """develop_files over `paths` with the counts zeroed just before and read
    just after; every result checked against its single-image plain develop."""
    eng = BatchEngine(devices=[device], max_batch=BATCH, maxwidth=maxwidth)
    _reset_counts()
    t = time.perf_counter()
    outs = eng.develop_files(paths, errors="skip")
    wall = time.perf_counter() - t
    counts = _counts()
    print(f"  {label}: {len(outs)} results in {wall * 1e3:.1f} ms host wall, launches {counts}")
    if counts != want_counts:
        raise AssertionError(f"{label}: launches {counts}, want {want_counts}")
    if not isinstance(outs[corrupt], BatchError) or outs[corrupt]:
        raise AssertionError(f"{label}: corrupt slot holds {outs[corrupt]!r}")
    worst = 0
    for i, (path, out) in enumerate(zip(paths, outs)):
        if i == corrupt:
            continue
        pipe = ipt.Pipeline.new_from_file(path, device)
        pipe.globals.settings.maxwidth = maxwidth
        plan = pipe._fused_plan_cached(8)
        want = kdev.develop_plain(plan, pipe._sensor_plane()).permute(1, 2, 0)
        maxd, frac = kdev.compare(out, want)
        if maxd > kdev.MAX_LSB or frac >= kdev.MAX_FLIP_FRACTION:
            raise AssertionError(f"{label}: {path} max |diff| {maxd}, differing {frac}")
        worst = max(worst, maxd)
    print(f"  {label}: slot {corrupt} is {outs[corrupt]!r}; the other {len(outs) - 1} agree "
          f"with their single-image plain develops, max |diff| {worst}")
    return counts


def phase2b(device, paths, corrupt) -> dict:
    """The batch path through BatchEngine.develop_files; returns the main
    path's launches of each batched kernel."""
    none = {k: 0 for k in _counts()}
    full = _run_batch(device, paths, corrupt, 0, dict(none, develop_batch=3),
                      "develop_files, full size")
    thumbs = _run_batch(device, paths, corrupt, BATCH_THUMB, dict(none, develop_scaled_batch=3),
                        f"develop_files, maxwidth {BATCH_THUMB}")
    return {"develop_batch": full["develop_batch"],
            "develop_scaled_batch": thumbs["develop_scaled_batch"]}


def _device_split(prof, wall_ms):
    """(ms by kind of device activity, busy ms) from a torch.profiler trace,
    or None when the trace holds no device activity."""
    from torch.autograd import DeviceType

    spans, intervals = collections.Counter(), []
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        intervals.append((start, end))
        name = e.name
        kind = ("H2D" if "HtoD" in name else "D2H" if "DtoH" in name
                else "kernel" if ("develop_kernel" in name or "scaled_kernel" in name)
                else "other")
        spans[kind] += (end - start) / 1e3
    if not intervals:
        return None
    busy, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return dict(spans), busy / 1e3


def phase3b(device, bayer_paths, bayer_bases, card) -> dict:
    """The batch path timed: develop_files throughput, host and device
    split, and the batched launch against a loop of single launches."""
    from torch.profiler import ProfilerActivity, profile

    mp = len(bayer_paths) * BAYER[0] * BAYER[1] / 1e6
    sources = [decode_file(p) for p in bayer_paths]
    for maxwidth in (0, BATCH_THUMB):
        eng = BatchEngine(devices=[device], max_batch=BATCH, maxwidth=maxwidth)
        eng.develop_files(bayer_paths)                    # warm-up
        walls = []
        for _ in range(3):
            eng.timings.clear()
            t = time.perf_counter()
            eng.develop_files(bayer_paths)
            walls.append((time.perf_counter() - t) * 1e3)
        host = {k: round(v * 1e3, 3) for k, v in sorted(eng.timings.items())}
        wall = statistics.median(walls)
        label = "full size" if not maxwidth else f"-> {maxwidth}"
        print(f"  develop_files, {len(bayer_paths)} x 24 MP Bayer, {label}: {mp / wall * 1e3:.1f} "
              f"source MP/s (median of 3 walls {[round(w, 1) for w in walls]} ms); host ms of "
              f"the last run {host} (decode summed over {eng.decode_workers} threads) (on {card})")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            eng.develop_files(bayer_paths)
            pwall = (time.perf_counter() - t) * 1e3
        split = _device_split(prof, pwall)
        if split is None:
            print(f"  under torch.profiler ({pwall:.1f} ms): device split not measured "
                  f"(the trace holds no device activity)")
        else:
            spans, busy = split
            print(f"  under torch.profiler ({pwall:.1f} ms wall): device ms "
                  f"{ {k: round(v, 3) for k, v in sorted(spans.items())} }, busy {busy:.3f} ms, "
                  f"idle share {1 - busy / pwall:.4f} (on {card})")
        eng.develop_sources(sources)                      # warm-up
        eng.timings.clear()
        t = time.perf_counter()
        eng.develop_sources(sources)
        s_ms = (time.perf_counter() - t) * 1e3
        host = {k: round(v * 1e3, 3) for k, v in sorted(eng.timings.items())}
        print(f"  develop_sources of the same frames decoded beforehand, {label}: "
              f"{mp / s_ms * 1e3:.1f} source MP/s ({s_ms:.1f} ms; host ms {host}) (on {card})")

    # Plans as the engine makes them: params on the host, so the batched
    # wrapper builds its per-image tables without reading the card.
    # The copies behind `scatter`, for one 8-bit 24 MP output (72 MB): from
    # pageable and from pinned host memory into fresh memory (as a result
    # array is) and into memory touched before, and from the card into
    # fresh pageable memory.
    out = np.full(3 * BAYER[0] * BAYER[1], 7, np.uint8)
    pinned = torch.empty(out.nbytes, dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = out
    on_card = torch.from_numpy(out).to(device)
    touched = np.zeros_like(out)
    copies = {"pageable -> fresh": lambda: out.copy(),
              "pageable -> touched": lambda: np.copyto(touched, out),
              "pinned -> fresh": lambda: pinned.numpy().copy(),
              "pinned -> touched": lambda: np.copyto(touched, pinned.numpy()),
              "card -> fresh pageable": lambda: on_card.cpu()}
    host_ms = {name: [] for name in copies}
    for _ in range(3):
        for name, fn in copies.items():
            _sync(device)
            t = time.perf_counter()
            fn()
            host_ms[name].append(round((time.perf_counter() - t) * 1e3, 3))
    print(f"  host clock of copying {out.nbytes} B, 3 runs each: {host_ms} (on {card})")
    del out, pinned, on_card, touched

    raws = _variants(bayer_bases, BATCH)
    planes = torch.stack([_upload(r, device) for r in raws])
    cpu = torch.device("cpu")
    times = {}
    for maxwidth, batched, single, plain, bound_of, name in (
            (0, kdev.develop_batch, kdev.develop, kdev.develop_batch_plain, develop_bound,
             "develop_batch"),
            (BATCH_THUMB, kds.develop_scaled_batch, kds.develop_scaled, kds.develop_scaled_batch_plain,
             scaled_bound, "develop_scaled_batch")):
        plans = [_plan(r, 8, cpu, numerics="direct", maxwidth=maxwidth) for r in raws]
        on_card = [p.to(device) for p in plans]
        t = _in_turns({"batched": lambda: batched(plans, planes),
                       "loop": lambda: [single(p, planes[i]) for i, p in enumerate(plans)],
                       "plain": lambda: plain(on_card, planes)}, device, reps=BATCH_REPS)
        bound = bound_of(plans[0], planes[0])
        runs = {k: [round(x, 4) for x in v[1]] for k, v in t.items()}
        print(f"  {name} B={BATCH} (24 MP {f'-> {maxwidth}' if maxwidth else '8-bit'}): "
              f"batched {t['batched'][0]:.4f} ms ({t['batched'][0] / BATCH:.4f} ms/image), "
              f"loop of single launches {t['loop'][0]:.4f} ms ({t['loop'][0] / BATCH:.4f} "
              f"ms/image), plain {t['plain'][0]:.4f} ms; bound {bound[0] * BATCH:.4f} ms by "
              f"{bound[1]}; runs {runs} (CUDA events over {BATCH_REPS} calls back to back, "
              f"medians of {TIMED_RUNS}, on {card})")
        times.update(_timing(name, t["batched"][0], t["plain"][0], bound, BATCH))
    return times


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


KERNELS = (   # name, source, the TPU kernel it replaces
    ("develop", "imagepipe_tpu_torch/csrc/develop.cu",
     "imagepipe_tpu/kernels/develop_pallas.py:143"),
    ("develop_scaled", "imagepipe_tpu_torch/csrc/develop_scaled.cu",
     "imagepipe_tpu/kernels/develop_scaled.py:391,500"),
    ("develop_batch", "imagepipe_tpu_torch/csrc/develop.cu",
     "imagepipe_tpu/kernels/develop_pallas.py:584,930"),
    ("develop_scaled_batch", "imagepipe_tpu_torch/csrc/develop_scaled.cu",
     "imagepipe_tpu/kernels/develop_scaled.py:846,861"),
)


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
    bayer_bases = [traw.synthetic_bayer(*BAYER, seed=10 + i) for i in range(4)]
    xtrans_bases = [traw.synthetic_xtrans(*XTRANS, seed=10 + i) for i in range(2)]
    print("phase 1b: batched kernels vs single launches and plain versions")
    errors = dict(develop=max_err, develop_scaled=max_err_scaled,
                  **phase1b(device, bayer_bases, xtrans_bases))
    print("phase 2: main paths")
    launches, scaled_launches = phase2(device, BAYER)
    with tempfile.TemporaryDirectory() as td:
        paths, corrupt = _batch_files(td, bayer_bases, xtrans_bases)
        print("phase 2b: the batch path, BatchEngine.develop_files")
        counts = dict(develop=launches, develop_scaled=scaled_launches,
                      **phase2b(device, paths, corrupt))
        print("phase 3: timing")
        times = phase3(device, BAYER, card)
        print("phase 3b: timing the batch path")
        bayer_paths = [p for p in paths[:17] if p != paths[corrupt]]
        times.update(phase3b(device, bayer_paths, bayer_bases, card))

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=counts[name], max_abs_err=errors[name], library_ms=None, **times[name])
        for name, source, replaces in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
