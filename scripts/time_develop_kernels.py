#!/usr/bin/env python3
"""Time the port's kernels like for like, and show what they cost in
registers and instructions.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/time_develop_kernels.py [--label NAME]
                                            [--kernels develop,rotate,suffix,suffix_lut,cuts]
                                            [--rotate-tile-h 8,16,32]

It times whichever `imagepipe_tpu_torch` is first on the import path, so two
versions of the kernels can be compared in one run on one card: unpack the
other version's `imagepipe_tpu_torch/` into a directory that .gitignore
lists and run this script with `PYTHONPATH=<that directory>`, in turns with
the tree's own (`PYTHONPATH=.`). The script uses only the kernels' public
wrappers (`develop`, `develop_batch`, `develop_scaled`,
`develop_scaled_batch`, `rotate_resample_planar`) and
`kernels.develop.build`, which every version of the port has since the
rotate kernel landed. `--kernels rotate` times the rotate kernel alone;
`--rotate-tile-h` times it again at each listed tile height of its staged
route (`kernels.rotate.TILE_H`, where the version has one). `--kernels
suffix` times the fused-suffix kernel (`kernels.suffix.run_suffix`, in
versions that have it) for each segment start at the two 24 MP frames of
`SUFFIX_SHAPES`, and beside it the eager stages it replaces
(`suffix_plain`, the per-stage loop's torch ops) on the same inputs;
`--kernels suffix_lut` the same kernel's 'lut' form from to_lab on the
5981x4458 frame (`run_suffix(..., numerics="lut")`, in versions that have
it), beside the eager stages in 'lut'. `--kernels cuts` times the develop
kernels cut at each `stage_limit` (`develop(plan, plane, stage_limit=k)`
and `develop_scaled(..., stage_limit=k)` for k = 1, 2, 3, 4, in versions
that have it) at 24 MP Bayer 8-bit, full size and -> 1024, so the
differences split the back end: the demosaic (cut 1), Lab (2 - 1), the
tone spline (3 - 2), Lab^-1 + XYZ->RGB + gamma (4 - 3).
`--kernels rotate_cfa` times the rotate kernel's CFA route
(`kernels.rotate.rotate_resample_cfa`, in versions that have it) on one
[1, 4000, 6000] float32 sensor plane (RGGB) at the three rotatecrop
geometries of `ROTATE_CASES`, and at the launch of chip_smoke.py's phase
2f (`CFA_STRIP_CASE`, a [1, 16000, 1500] plane to a 1 x 10 output); where
the version has the route's staged form, also its direct form and its
staged form in turns, and the staged schedule's stores alone at the
output's width and at the next multiple of 8 (`rotate_cfa_times`).

What it measures, on the card it names (`nvidia-smi` name and power limit):

* device ms per launch: `LAUNCHES` calls back to back after a warm-up,
  enqueued behind a device sleep so the card runs them without gaps, the
  calls rotating over three distinct inputs so that each 24 MP plane
  (48 MB, about the L2 cache's 50 MB) is read cold, as a request reads it;
  median of `REPEATS` such runs. If the host took longer to enqueue the
  launches than the sleep lasted, the figure is flagged `host_bound`. The
  rotate kernel resamples one [4, 4000, 6000] float32 source (384 MB, past
  the L2 cache) at the three rotatecrop geometries of `ROTATE_CASES`. The
  suffix kernel runs each segment start of a 24 MP frame (to_lab from a
  [4, H, W] f32 plane, 427 MB at 5981x4458; the later starts from the
  plain stages' outputs) to the 8-bit quantize, every stage output kept,
  as the staged edit path runs it, and from to_lab with a transposing
  orientation too (`SUFFIX_ORIENTED`); the eager stages are timed the
  same way with `EAGER_LAUNCHES` calls;
* from idle: one call timed with CUDA events from an idle device, so the
  wrapper's host path before its launch counts too (median of `REPEATS`);
  the difference from the device ms is the wrapper's host overhead;
* the bound: the larger of the bytes the function must move (the cropped
  plane read once, the output written once) over 3.35 TB/s and its least
  float32 work (`OPS_*`, levels counted once per source sample; the rotate
  kernel's from the valid windows of the geometry; the suffix kernel's the
  cheaper side of each branch, `OPS_SUFFIX`) over 67 TFLOP/s;
* registers, spills and shared memory per kernel (`nvcc -Xptxas -v` on the
  package's csrc/), and static SASS instructions per kernel
  (`cuobjdump -sass` of the built library).

Prints one JSON object as its last line (and writes it to `--json PATH`
when given).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

try:
    import imagepipe_tpu_torch as ipt
except ImportError:        # run from a checkout without PYTHONPATH: its own package
    sys.path.append(str(Path(__file__).resolve().parent.parent))
    import imagepipe_tpu_torch as ipt
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.engine import make_develop_plan
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds
from imagepipe_tpu_torch.sources import ImageSource

BAYER = (6000, 4000)
XTRANS = (6240, 4168)
BATCH = 8
LAUNCHES = 24            # launches per timed run (>= 20)
REPEATS = 5              # timed runs per figure
INPUTS = 3               # distinct inputs the launches rotate over
SLEEP_CYCLES = 200_000_000   # ~0.1 s of device sleep ahead of a timed run

# The card's peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The develop function's least float32 work (an FMA counts 2; expf, logf, a
# division, a min or a compare 1 each; index arithmetic not counted).
# Levels, once per source sample: subtract, divide, clip.
OPS_LEVELS = 3
# The back end per output pixel, 8-bit with gamma and no tone curve: WB 8,
# camera matrix 21, XYZ scaling 3, three lab_f 24, L/A/B 11, Lab^-1 30,
# XYZ->RGB 15, gamma 30, quantize 12.
OPS_FINISH = 154
# The back end cut at stage_limit 1 (quantize 12), 2 (WB, matrix, XYZ
# scaling, lab_f, L/A/B and the quantize) and 3 (the same plus the tone
# spline, OPS_SPLINE plus a compare per knot but the first, where the plan
# has a curve).
OPS_CUT = {1: 12, 2: 79, 3: 79}
OPS_SPLINE = 12
# The 3x3 demosaic per Bayer pixel, averaged over a quad: at R and B the
# two other colours sum four neighbours each (3 adds and a division), at G
# two each (1 add and a division): (8 + 4 + 4 + 8) / 4.
OPS_DEMOSAIC_BAYER = 6
# The scaled demosaic per window sample: weight (subtract dy^2, clip at 0),
# product, colour sum and weight sum (1 - dx^2 is per window column, not per
# sample); per output pixel the four averages.
OPS_WINDOW_SAMPLE = 5
OPS_SCALED_PIXEL = 4
# The rotated resample over the samples of each pixel's valid window (the
# staged route's walk): per window column dx (subtract, divide), dx^2 and
# 1 - dx^2; per window row dy (subtract, divide) and dy^2; per sample the
# weight (subtract dy^2, clip at 0), a product and a sum per channel and the
# count sum; per output pixel 6 adds of row and column terms and one
# division per channel.
OPS_ROTATE_COLUMN = 4
OPS_ROTATE_ROW = 3
OPS_ROTATE_SAMPLE = 3           # plus 2 per channel
OPS_ROTATE_PIXEL = 6            # plus 1 per channel

# The rotate kernel's source: the staged edit path's 24 MP demosaic stage,
# planar [4, H, W] f32, and rotatecrop's (label, rotation, crop_left).
ROTATE_SOURCE = (4, 4000, 6000)
ROTATE_CASES = (("rotation 0.05, crop_left 0.05", 0.05, 0.05),
                ("rotation 0.1, crop_left 0.05", 0.1, 0.05),
                ("rotation 0.5 (45 degrees)", 0.5, 0.0))
# The CFA route's launch on the staged render of a 1500 x 16000 (24 MP)
# Bayer strip at maxwidth 1 (chip_smoke.py phase 2f): its scaled demosaic
# to a 1 x 10 stage, (width, height, topleft, topright, bottomleft, nwidth,
# nheight).
CFA_STRIP_CASE = (1500, 16000, (0, 0), (1499, 0), (0, 15999), 1, 10)


# The suffix kernel: the staged edit path's two 24 MP frames (unrotated,
# and rotated 0.05 with crop_left 0.05, the first render's), and the
# stages a dirty suffix can start at.
SUFFIX_SHAPES = ((6000, 4000), (5981, 4458))
SUFFIX_STARTS = ("to_lab", "basecurve", "from_lab", "gamma")
SUFFIX_ORIENTED = ("Rotate90",)        # orientations timed from to_lab beside Normal
EAGER_LAUNCHES = 6       # calls of the eager stages per timed run
# The suffix's least float32 work per pixel, each branch counted at its
# cheaper side: to_lab (WB 8, camera matrix 21, XYZ scaling 2, three lab_f
# 12, L/a/b 11), basecurve (n_knots - 1 interval compares, the cubic 10,
# 2 end compares), from_lab (Lab^-1 21, XYZ->RGB 15), gamma (3 x clamp,
# compare, linear side), transform (none), and the quantize.
OPS_SUFFIX = {"to_lab": 54, "basecurve": 12, "from_lab": 36, "gamma": 12, "transform": 0}
OPS_QUANT = {8: 9, 16: 18}
# In 'lut' numerics each cube root and each gamma is a table lookup inside
# [0, 1] (a real frame's values; range test 2, pos, trunc, clamp 2, a, the
# lerp 3: 10): to_lab 54 - 12 + 3 x 10, gamma 3 x (clamp 2 + 10). Each
# lookup table, LUT_ENTRIES float32, is read once.
OPS_SUFFIX_LUT = dict(OPS_SUFFIX, to_lab=72, gamma=36)
LUT_ENTRIES = 8193

# Opcodes counted in each kernel's SASS: special-function unit calls
# (MUFU.RCP of a division, MUFU.LG2/EX2 of logf/expf), fused multiply-adds,
# the division's range check, branches, global and shared memory accesses, and the local
# memory accesses of spilled registers.
SASS_OPCODES = ("MUFU", "FFMA", "FCHK", "BRA", "LDG", "STG", "LDS", "STS", "LDL", "STL", "BAR")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def roofline(read_bytes, write_bytes, ops) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the float32 rate."""
    by_bytes = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def finish_ops(plan, stage_limit=4) -> int:
    """The back end's float32 operations per output pixel, cut at
    stage_limit (OPS_FINISH, OPS_CUT)."""
    if stage_limit == 4:
        return OPS_FINISH
    spline = OPS_SPLINE + plan.n_knots - 1 if plan.apply_curve and stage_limit == 3 else 0
    return OPS_CUT[stage_limit] + spline


def develop_bound(plan, plane, stage_limit=4) -> tuple[float, str]:
    """The full-size develop's bound for one Bayer plane, the back end cut
    at stage_limit."""
    px = plan.height * plan.width
    return roofline(px * plane.element_size(), 3 * px * plan.out_bits // 8,
                  px * (OPS_LEVELS + OPS_DEMOSAIC_BAYER + finish_ops(plan, stage_limit)))


def scaled_bound(plan, plane, stage_limit=4) -> tuple[float, str]:
    """The thumbnail develop's bound for one plane: the window samples this
    geometry has (from its tables), levels once per source sample; the back
    end cut at stage_limit."""
    g = {k: v.cpu().numpy().astype(np.int64) for k, v in kds.scaled_geometry(plan).items()
         if k in ("from_x", "to_x", "from_y", "to_y")}
    samples = int((g["to_x"] - g["from_x"] + 1).sum()) * int((g["to_y"] - g["from_y"] + 1).sum())
    src_px = plan.height * plan.width
    out_px = plan.dem_h * plan.dem_w
    return roofline(src_px * plane.element_size(), 3 * out_px * plan.out_bits // 8,
                  src_px * OPS_LEVELS + samples * OPS_WINDOW_SAMPLE
                  + out_px * (OPS_SCALED_PIXEL + finish_ops(plan, stage_limit)))


def rotatecrop_geometry(rotation, crop_left, width, height):
    """(topleft, topright, bottomleft, nwidth, nheight) of rotatecrop at
    these settings on a width x height demosaic stage."""
    from imagepipe_tpu_torch.ops.rotatecrop import OpRotateCrop

    op = OpRotateCrop()
    op.rotation, op.crop_left = rotation, crop_left
    return op.geometry(width, height)


def rotate_windows(height, width, geometry, device) -> tuple[int, int, int, int]:
    """(window columns, window rows, samples, live pixels) summed over the
    output's pixels: min(K, to - from + 1) per axis, 0 for an empty window
    and for a pixel whose centre is NaN (its output is 0 whatever the
    source holds: csrc/rotate.cu (h)); live pixels have no NaN centre."""
    from imagepipe_tpu_torch.scaling import rotated_geometry

    tl, tr, bl, nw, nh = geometry
    g = rotated_geometry(width, height, tl, tr, bl, nw, nh)
    rows, cols = torch.from_numpy(g.rows).to(device), torch.from_numpy(g.cols).to(device)
    cols_total = rows_total = samples = live = 0
    for r0 in range(0, nh, 512):                 # bands of rows bound the memory
        def term(i):
            return rows[i, r0:r0 + 512, None] + cols[i, None, :]

        def idx(i, maxv):
            v = torch.nan_to_num(term(i), nan=0.0)
            return torch.clamp(torch.floor(v), 0, maxv).to(torch.int64)

        alive = ~(torch.isnan(term(4)) | torch.isnan(term(5)))
        ny = torch.clamp(torch.clamp(idx(1, height - 1) - idx(0, height - 1) + 1, max=g.k_y),
                         min=0) * alive
        nx = torch.clamp(torch.clamp(idx(3, width - 1) - idx(2, width - 1) + 1, max=g.k_x),
                         min=0) * alive
        cols_total += int(nx.sum())
        rows_total += int(ny.sum())
        samples += int((nx * ny).sum())
        live += int(alive.sum())
    return cols_total, rows_total, samples, live


def rotate_bound(channels, height, width, geometry, device,
                 out_channels=None) -> tuple[float, str]:
    """The rotate kernel's bound: the source's `channels` planes read once
    (not at all where every pixel's centre is NaN), the output's
    `out_channels` planes (default `channels`; 4 for the CFA route's one
    sensor plane) written once, and the operations of the samples of each
    live pixel's valid window."""
    out_channels = channels if out_channels is None else out_channels
    nw, nh = geometry[3], geometry[4]
    wcols, wrows, samples, live = rotate_windows(height, width, geometry, device)
    ops = (wcols * OPS_ROTATE_COLUMN + wrows * OPS_ROTATE_ROW
           + samples * (OPS_ROTATE_SAMPLE + 2 * channels)
           + live * (OPS_ROTATE_PIXEL + out_channels))
    return roofline(channels * height * width * 4 if live else 0, out_channels * nh * nw * 4,
                    ops)


def rotate_cfa_times(device) -> dict:
    """{case: {ms, runs, host_bound, from_idle_ms, bound_ms, bound_by}} for
    the CFA route at the ROTATE_CASES geometries of one 24 MP RGGB plane
    and at CFA_STRIP_CASE, through its entry point; in versions with a
    staged form (`kernels.rotate.cfa_launch`) also each form alone at the
    ROTATE_CASES, the direct form and the staged form timed in turns
    (direct, staged, staged, direct; ms the mean of each form's two
    medians), and the stores alone (route "stores": the staged schedule
    writing every output as zeros) at the geometry's output width and at
    the next multiple of 8 (rows that start on a 32-byte sector)."""
    import dataclasses

    from imagepipe_tpu_torch.kernels import rotate as krot
    from imagepipe_tpu_torch.raw import CFA
    from imagepipe_tpu_torch.scaling import rotated_geometry

    _, height, width = ROTATE_SOURCE
    gen = torch.Generator(device=device).manual_seed(7)
    src = torch.rand((1, height, width), generator=gen, device=device, dtype=torch.float32)
    cfa = CFA("RGGB")
    out = {}
    w, h, *strip = CFA_STRIP_CASE
    plane = torch.rand((1, h, w), generator=gen, device=device, dtype=torch.float32)
    fn = lambda: krot.rotate_resample_cfa(plane, w, h, *strip, cfa)
    out[f"rotate_cfa [1, {h}, {w}] RGGB -> 4 x {strip[3]}x{strip[4]} (chip_smoke phase 2f)"] = (
        _entry([fn], fn, rotate_bound(1, h, w, strip, device, 4), device))
    del plane
    for label, rotation, crop in ROTATE_CASES:
        geometry = rotatecrop_geometry(rotation, crop, width, height)
        tl, tr, bl, nw, nh = geometry
        fn = lambda: krot.rotate_resample_cfa(src, width, height, tl, tr, bl, nw, nh, cfa)
        name = f"rotate_cfa [1, {height}, {width}] RGGB {label} -> 4 x {nw}x{nh}"
        bound = rotate_bound(1, height, width, geometry, device, 4)
        out[name] = _entry([fn], fn, bound, device)
        if not hasattr(krot, "cfa_launch"):
            continue                             # a version with the direct form only
        g = rotated_geometry(width, height, tl, tr, bl, nw, nh)
        plan = krot.rotate_tile_plan(g, 1, height, width, cfa=True)
        forms = {"direct form": dataclasses.replace(plan, route="direct"), "staged form": plan}
        turns = {form: [] for form in forms}
        for form in ("direct form", "staged form", "staged form", "direct form"):
            turns[form].append(device_ms(
                [lambda p=forms[form]: krot.cfa_launch(src, g, p, cfa)], device))
        for form, runs in turns.items():
            launch = lambda p=forms[form]: krot.cfa_launch(src, g, p, cfa)
            out[f"{name}, {form} (in turns)"] = {
                "ms": statistics.mean(r["ms"] for r in runs),
                "runs": [r["ms"] for r in runs],
                "host_bound": any(r["host_bound"] for r in runs),
                "from_idle_ms": from_idle_ms(launch, device),
                "bound_ms": bound[0], "bound_by": bound[1]}
        if "stores" not in getattr(krot, "CFA_ROUTES", {}):
            continue                             # a version without the stores probe
        for w8 in (nw, nw + (-nw) % 8):
            g8 = rotated_geometry(width, height, tl, tr, bl, w8, nh)
            p8 = krot.rotate_tile_plan(g8, 1, height, width, cfa=True)
            probe = lambda: krot.cfa_launch(src, g8, dataclasses.replace(p8, route="stores"), cfa)
            out[f"{name}, stores alone at {w8}x{nh}"] = _entry(
                [probe], probe, roofline(0, 4 * nh * w8 * 4, 0), device)
    del src
    torch.cuda.empty_cache()
    return out


def suffix_segment(device, bits=8, orientation="Normal", mono=False, exposure=0.3):
    """[(stage, params)] of the whole chainable tail (to_lab to transform,
    identities as stage None), as the ops' device_chain give them for a
    synthetic Bayer (or monochrome) frame at these settings."""
    from imagepipe_tpu_torch.buffer import OpBuffer

    raw = (traw.synthetic_mono if mono else traw.synthetic_bayer)(64, 48, seed=1)
    raw.orientation = traw.Orientation[orientation]
    pipe = ipt.Pipeline.new_from_source(ImageSource.from_raw(raw), device)
    pipe.globals.settings.linear = bits == 16
    pipe.ops.basecurve.exposure = exposure
    chains = pipe._chains(pipe.ops.all_ops(), 3, OpBuffer(64, 48, 4, mono, torch.empty(0)))
    return [(c[1], c[2]) for c in chains]


def suffix_bound(stages, params, height, width, keep, quant,
                 numerics="direct") -> tuple[float, str]:
    """The suffix kernel's bound: the input planes read once, each kept
    stage output and the quantized output written once, and OPS_SUFFIX
    (OPS_SUFFIX_LUT in 'lut', whose tables are read once too)."""
    px = height * width
    planes = 4 if stages[0] == "to_lab" else 3
    ops_of = OPS_SUFFIX_LUT if numerics == "lut" else OPS_SUFFIX
    ops = sum(ops_of[s] for s in stages) + (OPS_QUANT[quant] if quant else 0)
    if "basecurve" in stages:
        ops += np.asarray(dict(zip(stages, params))["basecurve"][0]).shape[1] - 1
    written = 3 * px * (4 * sum(bool(k) for k in keep) + (quant // 8 if quant else 0))
    tables = 4 * LUT_ENTRIES * sum(s in ("to_lab", "gamma") for s in stages)
    read = planes * px * 4 + (tables if numerics == "lut" else 0)
    return roofline(read, written, px * ops)


def suffix_times(device, numerics="direct", starts=SUFFIX_STARTS, oriented=SUFFIX_ORIENTED,
                 shapes=SUFFIX_SHAPES) -> dict:
    """{case: {ms, runs, host_bound, from_idle_ms, bound_ms, bound_by,
    eager_ms, eager_runs}} for the suffix kernel in `numerics` at each
    segment start of `starts` on the frames of `shapes` (8-bit, Normal,
    every stage kept) and from to_lab at the orientations of `oriented`,
    and the eager stages on the same inputs. A 'lut' case's label says so;
    its bound counts the same bytes and OPS_SUFFIX_LUT."""
    from imagepipe_tpu_torch.kernels import suffix as ksuf

    form = {} if numerics == "direct" else {"numerics": numerics}

    def real(orientation):
        seg = [(s, p) for s, p in suffix_segment(device, orientation=orientation)
               if s is not None]
        return [s for s, _ in seg], [p for _, p in seg]

    stages, params = real("Normal")
    cases = [(start, "Normal") for start in starts]
    cases += [("to_lab", o) for o in oriented]
    out = {}
    for width, height in shapes:
        gen = torch.Generator(device=device).manual_seed(9)
        bases = [torch.rand((4, height, width), generator=gen, device=device)
                 for _ in range(INPUTS)]
        inter = [ksuf.suffix_plain(b, stages, params, **form)[0] for b in bases]
        for start, orientation in cases:
            k = SUFFIX_STARTS.index(start)
            ins = bases if k == 0 else [o[k - 1] for o in inter]
            st, pa = real(orientation)
            st, pa = st[k:], pa[k:]
            keep = [True] * len(st)
            fns = [lambda x=x: ksuf.run_suffix(x, st, pa, 8, keep, **form) for x in ins]
            label = (f"suffix {width}x{height} from {start} to the 8-bit output, every stage "
                     f"kept{'' if orientation == 'Normal' else ', ' + orientation}"
                     f"{'' if not form else f', {numerics!r}'}")
            t = _entry(fns, fns[0], suffix_bound(st, pa, height, width, keep, 8, numerics),
                       device)
            eager = device_ms([lambda x=x: ksuf.suffix_plain(x, st, pa, 8, keep, **form)
                               for x in ins], device, EAGER_LAUNCHES, REPEATS)
            t["eager_ms"], t["eager_runs"] = eager["ms"], eager["runs"]
            out[label] = t
        del bases, inter
        torch.cuda.empty_cache()
    return out


def device_ms(fns, device, launches=LAUNCHES, repeats=REPEATS) -> dict:
    """Device ms per launch of `launches` calls of `fns` in rotation, back to
    back, behind a device sleep (median of `repeats`); `host_bound` if the
    host enqueued them more slowly than the sleep lasted."""
    for fn in fns:
        fn()
    torch.cuda.synchronize(device)
    runs, host_bound = [], False
    for _ in range(repeats):
        t0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t = time.perf_counter()
        for i in range(launches):
            fns[i % len(fns)]()
        enqueue_ms = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize(device)
        host_bound |= enqueue_ms >= t0.elapsed_time(start)
        runs.append(start.elapsed_time(end) / launches)
    return {"ms": statistics.median(runs), "runs": [round(r, 5) for r in runs],
            "host_bound": host_bound}


def from_idle_ms(fn, device, repeats=REPEATS) -> float:
    """Median ms of one call timed with CUDA events from an idle device."""
    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        runs.append(start.elapsed_time(end))
    return statistics.median(runs)


def plan_for(raw, bits, device, maxwidth=0):
    pipe = ipt.Pipeline.new_from_source(ImageSource.from_raw(raw), device)
    pipe.globals.settings.linear = bits == 16
    pipe.globals.settings.maxwidth = maxwidth
    return make_develop_plan(pipe, out_bits=bits, numerics="direct")


def variants(base, n):
    """n RawImages sharing `base`'s sensor data, each with its own WB."""
    import copy

    out = []
    for i in range(n):
        r = copy.copy(base)
        r.wb_coeffs = (1.5 + 0.1 * i, 1.0, 1.2 + 0.12 * i, float("nan"))
        out.append(r)
    return out


def _upload(raw, device):
    return torch.from_numpy(np.ascontiguousarray(raw.data)).to(device)


def _entry(fns, idle_fn, bound, device, batch=1) -> dict:
    t = device_ms(fns, device)
    t["from_idle_ms"] = from_idle_ms(idle_fn, device)
    t["bound_ms"] = bound[0] * batch
    t["bound_by"] = bound[1]
    return t


def kernel_times(device) -> dict:
    """{case: {ms, runs, host_bound, from_idle_ms, bound_ms, bound_by}} for
    the develop and scaled kernels at the main path's shapes."""
    out = {}
    bayer = [traw.synthetic_bayer(*BAYER, seed=20 + i) for i in range(INPUTS)]
    xtrans = [traw.synthetic_xtrans(*XTRANS, seed=20 + i) for i in range(INPUTS)]
    for label, raws, bits in (("develop 24 MP Bayer 8-bit", bayer, 8),
                              ("develop 24 MP Bayer 16-bit linear", bayer, 16),
                              ("develop 26 MP X-Trans 8-bit", xtrans, 8)):
        plan = plan_for(raws[0], bits, device)
        planes = [_upload(r, device) for r in raws]
        fns = [lambda p=p: kdev.develop(plan, p) for p in planes]
        out[label] = _entry(fns, fns[0], develop_bound(plan, planes[0]), device)
        del planes
    planes = [_upload(r, device) for r in bayer]
    for width, bits in ((2048, 8), (1024, 8), (160, 8), (1024, 16)):
        plan = plan_for(bayer[0], bits, device, maxwidth=width)
        fns = [lambda p=p: kds.develop_scaled(plan, p) for p in planes]
        label = (f"develop_scaled 24 MP Bayer -> {plan.dem_w}x{plan.dem_h}"
                 + (" 16-bit linear" if bits == 16 else ""))
        out[label] = _entry(fns, fns[0], scaled_bound(plan, planes[0]), device)
    del planes

    # Batched: B=8 planes of 24 MP Bayer with per-image WB, plans on the
    # host as the batch engine makes them; INPUTS distinct batches.
    cpu = torch.device("cpu")
    batches = [torch.stack([_upload(r, device) for r in variants(bayer[i], BATCH)])
               for i in range(INPUTS)]
    raws = variants(bayer[0], BATCH)
    for maxwidth, fn, bound_of, label in (
            (0, kdev.develop_batch, develop_bound, f"develop_batch B={BATCH} 24 MP Bayer 8-bit"),
            (1024, kds.develop_scaled_batch, scaled_bound,
             f"develop_scaled_batch B={BATCH} 24 MP Bayer -> 1024")):
        plans = [plan_for(r, 8, cpu, maxwidth=maxwidth) for r in raws]
        fns = [lambda b=b: fn(plans, b) for b in batches]
        out[label] = _entry(fns, fns[0], bound_of(plans[0], batches[0][0]), device, BATCH)
    del batches
    torch.cuda.empty_cache()
    return out


CUTS = (1, 2, 3, 4)      # stage_limit: after the demosaic, Lab, the spline; the whole chain


def cut_label(kernel, k, maxwidth=0) -> str:
    return (f"{kernel} 24 MP Bayer 8-bit{f' -> {maxwidth}' if maxwidth else ''} "
            f"stage_limit {k}")


def cut_times(device, maxwidths=(0, 1024)) -> dict:
    """{case: {ms, runs, host_bound, from_idle_ms, bound_ms, bound_by}} for
    the develop kernel (maxwidth 0) and the scaled kernel (-> maxwidth) cut
    at each stage_limit of CUTS, on the plans and planes `kernel_times`
    times the whole kernels on (24 MP Bayer 8-bit); the cuts of one kernel
    are timed one after another, so their differences split its back end."""
    bayer = [traw.synthetic_bayer(*BAYER, seed=20 + i) for i in range(INPUTS)]
    planes = [_upload(r, device) for r in bayer]
    out = {}
    for maxwidth in maxwidths:
        plan = plan_for(bayer[0], 8, device, maxwidth=maxwidth)
        fn, bound_of, kernel = ((kdev.develop, develop_bound, "develop") if not maxwidth else
                                (kds.develop_scaled, scaled_bound, "develop_scaled"))
        for k in CUTS:
            fns = [lambda p=p, k=k: fn(plan, p, stage_limit=k) for p in planes]
            out[cut_label(kernel, k, maxwidth)] = _entry(fns, fns[0],
                                                         bound_of(plan, planes[0], k), device)
    del planes
    torch.cuda.empty_cache()
    return out


def rotate_times(device, tile_hs=()) -> dict:
    """{case: {ms, runs, host_bound, from_idle_ms, bound_ms, bound_by}} for
    the rotate kernel at the ROTATE_CASES geometries of one 24 MP source,
    then again at each staged tile height of `tile_hs` ("... tile_h N")."""
    from imagepipe_tpu_torch.kernels import rotate as krot

    c, height, width = ROTATE_SOURCE
    gen = torch.Generator(device=device).manual_seed(7)
    src = torch.rand(ROTATE_SOURCE, generator=gen, device=device, dtype=torch.float32)
    default = getattr(krot, "TILE_H", None)
    out = {}
    for tile_h in (None, *tile_hs):
        if tile_h is not None:
            if default is None:
                break                            # a version without a staged route
            krot.TILE_H = tile_h
        for label, rotation, crop in ROTATE_CASES:
            geometry = rotatecrop_geometry(rotation, crop, width, height)
            tl, tr, bl, nw, nh = geometry
            fn = lambda: krot.rotate_resample_planar(src, width, height, tl, tr, bl, nw, nh, c)
            name = f"rotate [{c}, {height}, {width}] {label} -> {nw}x{nh}"
            if tile_h is not None:
                name += f" tile_h {tile_h}"
            out[name] = _entry([fn], fn, rotate_bound(c, height, width, geometry, device), device)
    if default is not None:
        krot.TILE_H = default
    del src
    torch.cuda.empty_cache()
    return out


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for c in ([os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []) + [shutil.which("nvcc")]:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found")


PTXAS_SOURCES = ("develop.cu", "develop_scaled.cu", "rotate.cu", "suffix.cu",
                 "develop_variants.cu")


def ptxas_report(csrc: Path, build_dir: Path, sources=PTXAS_SOURCES) -> dict:
    """{kernel: 'N registers, ... bytes spill ..., M bytes smem'} from
    `nvcc -Xptxas -v` on each kernel source of `sources` (by default the
    develop kernels', rotate.cu, suffix.cu and develop_variants.cu),
    compiled with the package's own flags (one nvcc each, in parallel)."""
    flags = [f for f in kdev._NVCC_FLAGS]
    build_dir.mkdir(exist_ok=True)
    procs = []
    for name in sources:
        if not (csrc / name).exists():
            continue
        obj = build_dir / f"ptxas_{name}.{os.getpid()}.o"
        procs.append((obj, subprocess.Popen([_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(obj),
                                             str(csrc / name)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
    report, kernel = {}, None
    for obj, proc in procs:
        text, _ = proc.communicate()
        obj.unlink(missing_ok=True)
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = _demangle(m.group(1))
            elif kernel and ("registers" in line or "spill" in line):
                report.setdefault(kernel, []).append(line.split("ptxas info    :")[-1].strip())
    return report


def _demangle(name: str) -> str:
    cxxfilt = shutil.which("c++filt") or shutil.which("cu++filt")
    if not cxxfilt:
        return name
    return subprocess.run([cxxfilt, name], capture_output=True, text=True).stdout.strip() or name


def sass_counts(lib: Path) -> dict:
    """{kernel: {"instructions": static SASS instruction count, and the
    count of each opcode in SASS_OPCODES}} of the develop, rotate, suffix
    and variant kernels in the built library (`cuobjdump -sass`); NOPs are not counted."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, kernel = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            kernel = _demangle(m.group(1))
            counts[kernel] = dict.fromkeys(("instructions",) + SASS_OPCODES, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if kernel and m and m.group(2) != "NOP":
            c = counts[kernel]
            c["instructions"] += 1
            op = m.group(2)
            for name in SASS_OPCODES:
                if op == name or op.startswith(name + "."):
                    c[name] += 1
    return {k: v for k, v in counts.items()
            if any(n in k for n in ("develop_kernel", "scaled_kernel", "rotate_kernel",
                                    "suffix_kernel", "variant_kernel"))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--json", help="also write the result line to this file")
    ap.add_argument("--kernels", default="develop,rotate",
                    help="comma-separated: develop (the develop and scaled kernels), rotate, "
                         "rotate_cfa, suffix, suffix_lut, cuts")
    ap.add_argument("--rotate-tile-h", default="",
                    help="comma-separated staged tile heights to time the rotate kernel at too")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("time_develop_kernels: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    the_card = card()
    print(the_card)
    pkg = Path(kdev.__file__).resolve().parent.parent
    t = time.perf_counter()
    lib = kdev.build()
    print(f"{args.label}: {pkg}, built {lib.name} in {time.perf_counter() - t:.1f} s")
    result = {"label": args.label, "card": the_card, "package": str(pkg),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "ptxas": ptxas_report(pkg / "csrc", pkg / "build"),
              "sass_instructions": sass_counts(lib)}
    for k, v in result["ptxas"].items():
        print(f"  ptxas {k}: {'; '.join(v)}")
    for k, v in result["sass_instructions"].items():
        print(f"  sass {k}: {v}")
    result["times"] = kernel_times(device) if "develop" in kernels else {}
    if "rotate" in kernels:
        tile_hs = [int(v) for v in args.rotate_tile_h.split(",") if v]
        result["times"].update(rotate_times(device, tile_hs))
    if "rotate_cfa" in kernels:
        result["times"].update(rotate_cfa_times(device))
    if "suffix" in kernels:
        result["times"].update(suffix_times(device))
    if "suffix_lut" in kernels:
        result["times"].update(suffix_times(device, "lut", ("to_lab",), (), SUFFIX_SHAPES[1:]))
    if "cuts" in kernels:
        result["times"].update(cut_times(device))
    for k, v in result["times"].items():
        eager = f"; eager stages {v['eager_ms']:.4f} ms device" if "eager_ms" in v else ""
        print(f"  {k}: {v['ms']:.4f} ms device (runs {v['runs']}{', HOST-BOUND' if v['host_bound'] else ''}), "
              f"{v['from_idle_ms']:.4f} ms from idle; bound {v['bound_ms']:.4f} ms by {v['bound_by']}"
              f"{eager} (on {the_card})")
    line = json.dumps(result)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
