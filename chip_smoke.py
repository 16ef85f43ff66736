#!/usr/bin/env python3
"""Smoke test of the PyTorch port (imagepipe_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize():
  0. setup: the card's name and power limit; build the CUDA kernels from
     csrc/ (develop.cu, develop_scaled.cu, rotate.cu with its CFA route,
     suffix.cu, develop_variants.cu and the division proof, one nvcc each,
     in parallel);
  1. each kernel against its plain PyTorch version on the card, at full
     size, and the proof that the kernels' reciprocal-multiply division
     (finish.cuh div_rcp) equals the IEEE one for every input they give it. The develop kernel: 24 MP Bayer 8-bit and 16-bit linear, 26 MP
     X-Trans, 24 MP mono, a Rotate90 frame and a cropped frame. The
     scaled-demosaic kernel: 24 MP Bayer to 2048, 1024, 320 and 160 wide,
     to 1024 at 16-bit linear, 26 MP X-Trans, Rotate90 and odd-crop frames
     and 61 MP to 1024. The tile edges: 24 MP Bayer and 26 MP X-Trans
     frames cropped at the odd origin (11, 3) to a width one pixel past a
     multiple of the develop kernel's 128-pixel tile (6017 and 6145), 8-bit
     and 16-bit, and the same frames to 1024 and 160 wide. Contract: max
     |diff| <= 1 LSB and fewer than 2% of values differing;
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
  2e. the multi-process feed: two ranks spawned (the parent has CUDA
     initialized, so not forked) form a gloo group on a FileStore in a
     temporary directory and each runs MultiHostBatchEngine(devices=
     ["cuda:0"]).develop_files over the same 21 files, full size and at
     maxwidth 1024; the corrupt file (index 5) falls on rank 1. Every result
     of each rank must be bit-equal to phase 2b's for the same path (sha256
     of its bytes), the corrupt slot a BatchError, and each rank's run
     launch develop_batch (full size) or develop_scaled_batch (1024) at
     least once and nothing else. Then errors="raise": both ranks must raise
     within 120 s, rank 1 its decode error, rank 0 a RuntimeError naming
     rank 1 and the path. A rank that fails or is still running after
     420 s fails the phase (every rank is killed);
  2d. the width-sharded batch path: the same files through
     BatchEngine(devices=[cuda:0, cuda:0], spatial=2).develop_files, both
     shards of each chunk on the one card. Every result must be bit-equal
     to phase 2b's, and the run make exactly 6 shard launches (3 chunks x 2
     shards) and no other; at maxwidth 1024 the thumbnails develop whole
     (3 launches of develop_scaled_batch only). Then the width-sharded
     eager route (engine.develop_batch_perimage_sp): the same files
     through BatchEngine(executor="eager") at spatial=2 on one card
     against spatial=1, at full size, at maxwidth 4000 ('fulldown') and
     at maxwidth 1024 (eager 'scaled'), and a 24 MP mono DNG at maxwidth
     4000 ('plaindown') and a 24 MP linear DNG (rgb) with the default
     executor. Each sharded run must be bit-equal to spatial=1 and launch
     no kernel (every count 0); the full-size and 1024 results must hold
     the contract against phase 2b's kernel results. Host walls of both
     are printed beside the card (no speed claim);
  2g. the banded eager develop: a 60 MP (9504x6336) Bayer frame in 'lut'
     numerics through engine.develop_fused with bands=None (3 bands)
     against bands=1 on the card, bit for bit, two runs of each in turns,
     each with its peak device memory (torch.cuda.max_memory_allocated)
     and host wall;
  2h. a staged output with no pixels: a 98x54 Bayer DNG rendered through
     Pipeline(device="cuda").output_8bit with a cache at maxwidth 1 must
     be (0, 1, 3) uint8 and launch no kernel (no rotate, rotate_cfa or
     suffix launch);
  2i. the staged edit path in 'lut' numerics (color.numerics_mode, the
     process-wide override): a 24 MP Bayer DNG through RenderService(
     device="cuda"), the first render (rotation 0.05 + crop_left 0.05) and
     an exposure edit, from a freshly decoded file in each of four turns
     ('direct', 'lut', 'lut', 'direct'; the turns of a mode bit-equal). Each
     must launch the rotate kernel as in phase 2c and the suffix kernel
     once, in the mode's form (`suffix_lut` in 'lut', `suffix` in
     'direct'), and nothing else; one more exposure edit a turn runs under
     torch.profiler for the device split, and two more with each stage
     synchronized, fused and per stage (FUSE_SUFFIX = False, the ops'
     `run`), their host ms printed. Each 'lut' request must hold the
     contract against its 'direct' twin, and the same requests on a
     600x400 crop of the frame on the card against the CPU, both 'lut'.
     After the context 'auto' is 'direct' again and an exposure edit
     launches the 'direct' form once. Host ms of each request to host
     pixels, beside the card. Then
     engine.develop_batch_fn(plan) over B=4 24 MP Bayer planes on the card
     against develop_batch (the batch engine's kernel) on the same plan,
     within the contract;
  1c. the rotate kernel against its plain version: [4, 4000, 6000] f32
     (24 MP, as the staged path hands it to rotatecrop) rotated 0.05 with
     crop_left 0.05 (-> 5981x4458), rotated 0.1 with the same crop, rotated
     0.5 (45 degrees, 7071x7071, half the output outside the source),
     rotated 0.05 from the 5999x3999 stage the first render of phase 2c
     resamples (an odd width), rotated 0.05 with a x2 and a x8 downscale,
     the same source with NaN
     and +-Inf planted at 0.05 and at 45 degrees, and small degenerate
     geometries (an output 1 wide, 1 high, a zero x-step, corners outside
     the source). Contract: max |diff| <= 2e-6 (0 expected) and the same
     NaN and zero pattern. Routes: the x8 downscale, the outputs 1 wide
     and 1 high and the corners outside the source must take the kernel's
     direct route (one direct launch each), every other case its staged
     route. The CFA route (rotate_resample_cfa, one sensor plane to four
     colour planes) bit for bit against its plain version, one launch each:
     a [1, 4000, 6000] plane with the RGGB and the X-Trans CFA rotated 0.05
     with crop_left 0.05, rotated 0.5 (45 degrees) and rotated 0.05 with a
     x2 downscale, the same at 0.05 and 45 degrees with NaN and +-Inf
     planted, the 5999x3999 stage (RGGB) at 0.05, all in the route's staged
     form, and outputs 1 wide and 1 high in its direct form (counted in
     CFA_DIRECT_LAUNCHES), among them phase 2f's launch, a [1, 16000, 1500]
     plane to a 1x10 output, with and without NaN and +-Inf planted;
  2f. the CFA route's path: a 1500x16000 (24 MP) Bayer strip DNG rendered
     staged (Pipeline(device="cuda").output_8bit with a cache) at maxwidth
     1: its scaled demosaic to a 1x10 stage is the CFA-aware rotated
     resample. It must launch the CFA route once, in its direct form (the
     1x10 output's tables hold inf), no develop or per-channel rotate
     kernel, and agree with the same render on the CPU; that launch is then
     timed (device ms back to back, and one call from idle) with its plain
     version, and its time, plain time and bound are the `rotate_cfa` row
     of the kernels line;
  1d. the width-sharded develop (develop_sp: one launch of the develop
     kernel per column shard at its global column offset, a 1-column halo
     exchange between the shards, the output assembled on the first
     device): 60 MP Bayer 16-bit, 24 MP Bayer 8-bit and 26 MP X-Trans 8-bit
     at spatial 2 and 3 (3 leaves an uneven last shard), every shard on one
     card and, where there are two or more cards, across cards; and
     develop_sp_batch at B=4 of 24 MP Bayer. Each must be bit-equal to the
     unsharded develop / develop_batch, hold the contract against its plain
     version, and make one launch per shard;
  1e. the suffix kernel (the fused dirty suffix) against its plain version,
     bit for bit (floats to the bit where not NaN, NaN at the same places;
     quantized outputs equal): on the 6000x4000 frame and the first
     render's 5981x4458 rotated frame, a segment from each start
     (rotatecrop/to_lab, basecurve, from_lab, gamma) to the 8-bit and the
     16-bit linear output, at Normal, Rotate90 and Transverse, with every
     stage output kept and with only the last; a monochrome frame from
     to_lab. The inputs: a [4, H, W] plane over [-0.1, 1.2) and the plain
     stages' outputs on it (values below 0 and above 1), each with 3000
     each of NaN, +Inf and -Inf planted. One launch per segment. Then the
     same cases in 'lut' numerics (the kernel's 'lut' form, color.
     TransformLUT's table lookups with their out-of-range fallback) on the
     5981x4458 frame, against the plain version in 'lut', with the count
     of lookups that took the fallback;
  1g. the develop kernels' stage_limit cuts (finish.cuh develop_rgb<k>:
     the back end stopped after the demosaic, Lab or the spline, quantized
     without gamma; the JAX package's _finish_tile(stage_limit) knob):
     develop(plan, plane, stage_limit=k) on 24 MP Bayer 8-bit and 16-bit
     linear and 26 MP X-Trans, develop_scaled(..., stage_limit=k) on 24 MP
     Bayer to 1024 and to 160, k = 1, 2, 3, one launch each counted in
     CUT_LAUNCHES[k] and nothing else, each within the contract of its
     plain version; then each cut and the whole kernel timed at 24 MP
     Bayer 8-bit (full size and -> 1024), and the split of the kernel's
     time printed: up to the demosaic, Lab, spline, Lab^-1 + gamma;
  1f. the develop kernel's ablation ladder (kernels/variants.py::
     run_variant, csrc/develop_variants.cu, the port of the TPU experiments
     scripts/exp_kernel_variants.py and exp_kernel_variants3.py): every
     rung, each variant (noop, dma_floor, levels, demosaic, color_only,
     full) of form A and B on u16 and f32 24 MP planes to u8 and (form B)
     f32 outputs, once through run_variant with the counts set to 0 just
     before and read just after (one launch per rung of its form, no other
     kernel; the 24 MP planes load by TMA); each held to its plain version
     on the card (u8 max |diff| <= 1 LSB on < 2% of values, f32 bit for
     bit; dma_floor form A also at a 32 x 768 TPU tile); then every rung
     again on 6001 x 4001 planes (rows off 16 bytes: the vector-load route,
     counted in kv.ROUTE_LAUNCHES), held the same way; each rung's route
     and tile height printed; then every rung timed as the develop kernels
     are, beside kernels.develop.develop cut after the demosaic and whole
     on the same plan and planes (scripts/torch_kernel_variants.py), with
     the plain versions from idle, noop beside one PyTorch call (form B
     Tensor.zero_(), form A a copy of its three values), the previous
     design's times and the bounds. The kernels line's
     `develop_variants` row is rung full_A_u16_u8 and `develop_variants3`
     rung noop_B_u16_u8 (library: zero_());
  2c. the staged edit path at full width: a 24 MP Bayer DNG through
     RenderService(device="cuda").open_file, then edits: rotation 0.05 +
     crop_left 0.05 (the first render), exposure +0.3, rotation 0.1, and
     rotation 0 (crop only). Each edit must launch the rotate kernel 1, 0,
     1, 0 times, the suffix kernel once (its dirty tail after rotatecrop
     is one fused segment) and no develop kernel, and leave 8, 12, 20, 26
     cache entries (the reference's hash chain). The same edits with
     pipeline.FUSE_SUFFIX = False (each op's run in turn, no suffix
     launch) must give the same pixels bit for bit and the same entries.
     The first render must agree with the same edit with the
     rotate step replaced by its plain version (on the cached demosaic
     stage, finished by the ops' run), and a staged render of the unedited
     frame with the fused develop kernel (<= 1 LSB, < 2%). Prints per-stage
     host ms (each stage or fused segment synchronized), the device's idle
     share under torch.profiler, and the cache's total_bytes beside the
     device memory it holds;
  3. the kernels timed like for like (scripts/time_develop_kernels.py):
     device ms per launch over 24 launches back to back behind a device
     sleep, rotating over 3 distinct inputs so each 24 MP plane is read
     cold, median of 5, with one call from idle beside it (the wrapper's
     host path): the develop kernel at 24 MP Bayer 8-bit and 16-bit and
     26 MP X-Trans, the scaled kernel at 24 MP to 2048, 1024, 160 and 1024
     at 16-bit, both batched at B=8; the rotate kernel the same way at the
     three 24 MP geometries of phase 1c; the suffix kernel the same way
     from each segment start on the two frames of phase 1e (8-bit, every
     stage kept), beside the device ms of the eager stages it replaces on
     the same inputs, and its 'lut' form from to_lab on the 5981x4458
     frame beside the eager stages in 'lut'; plain versions one call from idle, median of 5; the
     host wall time and breakdown of a cached 1024-px request; the edit
     requests of phase 2c (first render, exposure edit, rotation edit) to
     host pixels, per-stage (FUSE_SUFFIX = False) and fused in turns; the
     CFA route at the three 24 MP geometries on a [1, 4000, 6000] RGGB
     plane (its direct and staged forms in turns, the staged schedule's
     stores alone; no main path runs these geometries) and at phase 2f's
     launch;
  3b. the batch path timed: develop_files throughput of the 16 Bayer files
     (source MP/s, full size and to 1024), its host split (decode, plan,
     staging, dispatch, wait, scatter) and, under torch.profiler, its
     device split (H2D, kernel, D2H) and idle share; a batched launch at
     B=8 against a loop of 8 single launches (device ms back to back) and
     the plain version (one call from idle), 24 MP 8-bit and to 1024;
  3e. the multi-process feed timed: the two ranks over phase 3b's 16 Bayer
     files (8 each), full size and to 1024: source MP/s of the fleet's wall
     (the slower rank's, each run started after a barrier; median of 3)
     beside phase 3b's single process in the same call, with each rank's
     host split (decode, plan, stage, dispatch, wait, scatter);
  3d. the width-sharded develop at spatial 2 on one card, 60 MP Bayer
     16-bit and 24 MP Bayer 8-bit: device ms of an image's shard launches,
     of the halo exchange, of the assembly, and of the whole develop_sp
     beside the unsharded develop (the timing script's method); the plain
     version one call from idle.

Each phase prints its wall when it ends. It prints a JSON line of
per-kernel results (launches on the main path, max |diff| against the
plain version, times, and the bound: the least time the card could take,
from the bytes and float32 operations of this run's shapes; the
`suffix_lut` row is the suffix kernel's 'lut' form on phase 2i's path, the
`develop_cut{k}` and `develop_scaled_cut{k}` rows the cuts of phase 1g),
then, as its last line, {"ok": true, "device": {...}}. It exits non-zero,
printing no result, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import datetime
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

import imagepipe_tpu_torch as ipt
from imagepipe_tpu_torch import color as tcc
from imagepipe_tpu_torch import dng
from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.buffer import OpBuffer
from imagepipe_tpu_torch.cache import MultiCache
from imagepipe_tpu_torch.color import output8bit
from imagepipe_tpu_torch.decode import decode_file
from imagepipe_tpu_torch.engine import develop_fused, make_develop_plan, planar_to_hwc
from imagepipe_tpu_torch.hasher import BufHasher
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import develop_scaled as kds
from imagepipe_tpu_torch.kernels import rotate as krot
from imagepipe_tpu_torch.kernels import suffix as ksuf
from imagepipe_tpu_torch.kernels import variants as kv
from imagepipe_tpu_torch import pipeline as ppl
from imagepipe_tpu_torch.parallel import BatchEngine, BatchError, MultiHostBatchEngine
from imagepipe_tpu_torch.service import RenderService
from imagepipe_tpu_torch.sources import ImageSource, image_content_hash

sys.path.insert(1, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
import time_develop_kernels as tdk  # noqa: E402
import torch_kernel_variants as tkv  # noqa: E402

BAYER = (6000, 4000)
XTRANS = (6240, 4168)
BIG = (9504, 6336)
# Cropped sizes of phase 1's tile-edge frames: widths 47 * 128 + 1 and
# 48 * 128 + 1.
EDGE_BAYER = (6017, 4000)
EDGE_XTRANS = (6145, 4168)
# Phase 1d's width-sharded cases: (label, size, generator, bits).
SP_CASES = (("60 MP Bayer 16-bit", BIG, traw.synthetic_bayer, 16),
            ("24 MP Bayer 8-bit", BAYER, traw.synthetic_bayer, 8),
            ("26 MP X-Trans 8-bit", XTRANS, traw.synthetic_xtrans, 8))
PLAIN_RUNS = 5                        # one-call timings of plain versions and requests
BATCH = tdk.BATCH                     # max_batch of the batch path
BATCH_THUMB = 1024                    # thumbnail width of the batch path

# The card's peaks, the kernels' bounds (OPS_*, the rotate kernel's over
# each pixel's valid window) and the like-for-like timing (device ms over
# launches back to back, cold inputs) are the timing script's:
# scripts/time_develop_kernels.py.

# The staged edit path: the 24 MP source of the rotate kernel is the
# demosaic stage, planar [4, H, W] f32, rotated by rotatecrop at these
# (label, rotation, crop_left); and the edits of phase 2c.
ROTATE_CASES = tdk.ROTATE_CASES
# Non-finite values planted in phase 1c's 24 MP source: of each of NaN,
# +Inf and -Inf, this many at seeded positions (about half the staged tiles'
# boxes then hold one and take the full walk).
ROTATE_NONFINITE = 3000
# (label, patch, rotate launches, suffix launches, cache entries after it).
# The entries follow the reference's hash chain: the settings, demosaic size
# included, come first, and size planning asks a 6000x4000 frame rotated
# 0.05 for a 5999x3999 demosaic stage, 6000x4000 at 0.1 and at 0: those two
# edits recompute every stage (8 + 4 + 8 + 6). Each edit's dirty tail after
# rotatecrop is one fused segment: one suffix launch.
EDITS = (("rotation 0.05 + crop_left 0.05 (first render)",
          {"rotatecrop": {"rotation": 0.05, "crop_left": 0.05}}, 1, 1, 8),
         ("exposure +0.3", {"basecurve": {"exposure": 0.3}}, 0, 1, 12),
         ("rotation 0.1", {"rotatecrop": {"rotation": 0.1}}, 1, 1, 20),
         ("rotation 0 (crop only)", {"rotatecrop": {"rotation": 0.0}}, 0, 1, 26))
EDIT_CACHE_BYTES = 16 << 30
# Phase 1e: the suffix kernel's frames (the staged edit path's 24 MP frame
# and the first render's rotated one), orientations and output bits.
SUFFIX_SHAPES = tdk.SUFFIX_SHAPES
SUFFIX_ORIENTATIONS = ("Normal", "Rotate90", "Transverse")
EDIT_RUNS = 3                         # fresh services per turn of phase 3c's edit requests
# Phase 1c's CFA cases: the CFAs of the CFA route, and the staged scaled
# demosaic to a 1-px-wide stage (a 24 MP vertical strip, maxwidth 1 -> 1x10).
CFA_NAMES = (("RGGB", "RGGB"), ("X-Trans", "GBGGRGRGRBGBGBGGRGRGRBGBGBGGRGGRGGBG"))
STRIP = (1500, 16000)
# Phases 2e and 3e: the fleet's ranks (spawned processes sharing the one
# card), the time a rank may take before the phase fails, and the time the
# errors="raise" run may take before both ranks have raised.
FLEET_RANKS = 2
FLEET_TIMEOUT_S = 420
FLEET_RAISE_LIMIT_S = 120


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
    kdev.LAUNCHES = kdev.BATCH_LAUNCHES = kdev.SP_LAUNCHES = 0
    kds.LAUNCHES = kds.BATCH_LAUNCHES = 0
    krot.LAUNCHES = krot.DIRECT_LAUNCHES = krot.CFA_LAUNCHES = krot.CFA_DIRECT_LAUNCHES = 0
    ksuf.LAUNCHES = ksuf.LUT_LAUNCHES = 0
    kv.VARIANT_LAUNCHES.update(A=0, B=0)
    kv.ROUTE_LAUNCHES.update(dict.fromkeys(kv.ROUTE_LAUNCHES, 0))
    for cuts in (kdev.CUT_LAUNCHES, kds.CUT_LAUNCHES):
        cuts.update(dict.fromkeys(cuts, 0))


def _counts() -> dict:
    return {"develop": kdev.LAUNCHES, "develop_scaled": kds.LAUNCHES,
            "develop_batch": kdev.BATCH_LAUNCHES, "develop_scaled_batch": kds.BATCH_LAUNCHES,
            "rotate": krot.LAUNCHES, "develop_sp": kdev.SP_LAUNCHES, "suffix": ksuf.LAUNCHES,
            "suffix_lut": ksuf.LUT_LAUNCHES,
            "rotate_cfa": krot.CFA_LAUNCHES, "develop_variants": kv.VARIANT_LAUNCHES["A"],
            "develop_variants3": kv.VARIANT_LAUNCHES["B"],
            **{f"develop_cut{k}": n for k, n in kdev.CUT_LAUNCHES.items()},
            **{f"develop_scaled_cut{k}": n for k, n in kds.CUT_LAUNCHES.items()}}


def _upload(raw, device):
    return torch.from_numpy(np.ascontiguousarray(raw.data)).to(device)


def phase1(device, bayer, xtrans, big, edges=(EDGE_BAYER, EDGE_XTRANS)) -> tuple[int, int]:
    """Each kernel vs its plain version at full size, and at the tile edges
    (`edges`: the cropped sizes of a Bayer and an X-Trans frame); returns
    the largest |diff| of the develop and of the scaled kernel."""
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
    calibs = []
    for label, raw, bits in cases:
        plan = _plan(raw, bits, device)
        calibs.append(plan)
        plane = _upload(raw, device)
        got = kdev.develop(plan, plane)
        want = kdev.develop_plain(plan, plane)
        _sync(device)
        worst = max(worst, _check(f"{label} {raw.width}x{raw.height}", got, want))

    # Tile edges: odd crop origins (11, 3) and a cropped width one pixel
    # past a multiple of the develop kernel's 128-pixel tile.
    edge_raws = []
    for kind, make, (w, h) in zip(("bayer", "x-trans"),
                                  (traw.synthetic_bayer, traw.synthetic_xtrans), edges):
        raw = make(w + 16, h + 10, seed=0)
        raw.crops = (3, 5, 7, 11)
        edge_raws.append((kind, raw))
        for bits in (8, 16):
            plan = _plan(raw, bits, device)
            calibs.append(plan)
            if (plan.crop_x, plan.crop_y, plan.width % 128) != (11, 3, 1):
                raise AssertionError(f"{kind} edge frame: crop ({plan.crop_x}, {plan.crop_y}), "
                                     f"width {plan.width}")
            plane = _upload(raw, device)
            got = kdev.develop(plan, plane)
            want = kdev.develop_plain(plan, plane)
            _sync(device)
            worst = max(worst, _check(f"{kind} odd crop (11, 3), {plan.width}x{plan.height} "
                                      f"{bits}-bit", got, want))

    odd = traw.synthetic_bayer(bw + 16, bh + 10, seed=0)
    odd.crops = (3, 5, 7, 11)              # odd origin on both axes
    thumbs = [(f"bayer -> {w}", base, w, 8) for w in (2048, 1024, 320, 160)] + [
        ("bayer -> 1024 16-bit linear", base, 1024, 16),
        ("x-trans -> 1024", cases[2][1], 1024, 8),
        ("bayer Rotate90 -> 1024", rotated, 1024, 8),
        ("bayer odd crop -> 1024", odd, 1024, 8),
        ("bayer 61 MP -> 1024", traw.synthetic_bayer(*big, seed=0), 1024, 8),
    ] + [(f"{kind} odd crop (11, 3) -> {w}", raw, w, 8) for kind, raw in edge_raws
                                                     for w in (1024, 160)]
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
    if device.type == "cuda":
        _division_proof(device, calibs)
    return worst, worst_scaled


def _division_proof(device, plans) -> None:
    """finish.cuh's div_rcp must give the IEEE quotient (__fdiv_rn) for
    every input the kernels feed it: every float dividend of each constant
    divisor of the back end; all 65,536 u16 raws for the levels of each
    calibration of phase 1 and of a seeded sweep of 256 more (black, range)
    pairs; all 2^32 float raws for two of them (f32 planes)."""
    run = sorted({tuple(float(v) for v in kdev.calib_tables(p)[0][0, :2]) for p in plans})
    rng = np.random.default_rng(0)
    sweep = [(b, r) for b in (0.0, 64.0, 512.0, 1024.0, 2047.5) for r in (1.0, 0.37, 255.0, 4095.0,
                                                                         15871.0, 16383.0, 65535.0)]
    sweep += list(zip(rng.uniform(0, 4096, 256 - len(sweep)).astype(np.float32).tolist(),
                      rng.uniform(1, 65536, 256 - len(sweep)).astype(np.float32).tolist()))
    t = time.perf_counter()
    res = kdev.division_mismatches(run + sweep, [run[0], sweep[-1]], device)
    ms = (time.perf_counter() - t) * 1e3
    want = {"constants": 1 << 32, "levels": len(run + sweep) << 16, "levels_f32": 2 << 32}
    print(f"  div_rcp vs __fdiv_rn, mismatches: constant divisors {res['constants']}; levels of "
          f"{len(run)} run calibrations {run} and {len(sweep)} swept (u16 raws) "
          f"{sum(res['levels'])}; levels over float raws {res['levels_f32']}; inputs tried "
          f"{res['checked']} (want {want}) ({ms:.1f} ms)")
    if (any(res["constants"]) or any(res["levels"]) or any(res["levels_f32"])
            or res["checked"] != want):
        raise AssertionError(f"div_rcp differs from the IEEE division: {res}")


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


def _plain_ms(fn, device) -> float:
    """A plain version's ms: one call from an idle device, CUDA events,
    median of PLAIN_RUNS after a warm-up call."""
    return tdk.from_idle_ms(fn, device, PLAIN_RUNS)


def _timing(name, ms, plain_ms, bound, batch=1) -> dict:
    return {name: {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0] * batch,
                   "bound_by": bound[1]}}


def _show(label, t, card) -> None:
    print(f"  {label}: {t['ms']:.4f} ms device, launches back to back (runs {t['runs']}"
          f"{', HOST-BOUND' if t['host_bound'] else ''}); {t['from_idle_ms']:.4f} ms one call "
          f"from idle (the difference is the wrapper's host path); bound {t['bound_ms']:.4f} ms "
          f"by {t['bound_by']} (on {card})")


def phase3(device, bayer, card):
    """The develop kernels timed like for like (scripts/time_develop_kernels.py:
    device ms per launch, 24 launches back to back over 3 distinct cold
    inputs, median of 5; one call from idle beside it), their plain versions
    from idle, and a cached 1024-px request. Returns {kernel name: {ms,
    plain_ms, bound_ms, bound_by}} for the single and batched kernels."""
    kt = tdk.kernel_times(device)
    for label, t in kt.items():
        _show(label, t, card)
    raw = traw.synthetic_bayer(*bayer, seed=3)
    plane = _upload(raw, device)
    plan = _plan(raw, 8, device)
    pms = _plain_ms(lambda: kdev.develop_plain(plan, plane), device)
    tplan = _plan(raw, 8, device, maxwidth=1024)
    spms = _plain_ms(lambda: kds.develop_scaled_plain(tplan, plane), device)
    print(f"  plain versions, one call from idle, median of {PLAIN_RUNS}: develop 24 MP Bayer "
          f"8-bit {pms:.4f} ms, develop_scaled -> 1024 {spms:.4f} ms (on {card})")
    times = {}
    for name, label, plain_ms in (("develop", "develop 24 MP Bayer 8-bit", pms),
                                  ("develop_scaled", "develop_scaled 24 MP Bayer -> 1024x682", spms)):
        t = kt[label]
        times.update(_timing(name, t["ms"], plain_ms, (t["bound_ms"], t["bound_by"])))

    # A cached 1024-px request: plan and plane on the card, and its parts.
    pipe = ipt.Pipeline.new_from_source(ImageSource.from_raw(raw), device)
    pipe.globals.settings.maxwidth = 1024
    pipe.output_8bit(None)
    walls = []
    for _ in range(PLAIN_RUNS):
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
          f"{PLAIN_RUNS}, runs {[round(w, 4) for w in walls]}; upload of the u16 plane "
          f"{up_ms:.4f} ms (once per frame), kernel {times['develop_scaled']['ms']:.4f} ms device, "
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


def _sp_devices(device, spatial) -> list[list]:
    """The device rows a sharded case runs on: every shard on `device`, and
    across cards too where there are two or more."""
    rows = [[device] * spatial]
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        n = torch.cuda.device_count()
        rows.append([torch.device("cuda", i % n) for i in range(spatial)])
    return rows


def phase1d(device, sp_cases, bayer_bases) -> int:
    """The shard launches of the width-sharded develop (develop_sp, one
    launch of csrc/develop.cu per column shard, 1-column halo exchange):
    each case of `sp_cases` at spatial 2 and 3 must be bit-equal to the
    unsharded develop and hold the contract against develop_sp_plain, with
    SP_LAUNCHES equal to its shards; develop_sp_batch at B=4 of 24 MP Bayer
    (per-image WB) bit-equal to develop_batch. Returns the largest |diff|
    against the plain versions."""
    worst = 0
    for label, (w, h), make, bits in sp_cases:
        raw = make(w, h, seed=0)
        plan = _plan(raw, bits, device)
        whole = kdev.develop(plan, _upload(raw, device))
        for spatial in (2, 3):
            shards = kdev.stage_sp(plan, raw.data, spatial)
            for devices in _sp_devices(device, spatial):
                kdev.SP_LAUNCHES = 0
                got = kdev.develop_sp(plan, shards, devices)
                launches = kdev.SP_LAUNCHES
                plain = kdev.develop_sp_plain(plan, [s.to(d) for s, d in zip(shards, devices)])
                _sync(device)
                where = ("one card" if len(set(devices)) == 1 else
                         f"{len(set(devices))} cards")
                if device.type == "cuda" and launches != len(shards):
                    raise AssertionError(f"{label} spatial {spatial}: {launches} shard launches, "
                                         f"want {len(shards)}")
                if not torch.equal(got, whole):
                    raise AssertionError(f"{label} spatial {spatial} ({where}): differs from the "
                                         f"unsharded develop in {int((got != whole).sum())} values")
                worst = max(worst, _check(
                    f"{label} {w}x{h} spatial {spatial} ({where}, shards "
                    f"{kdev.sp_shards(plan.width, spatial)}, {launches} launches; bit-equal to "
                    f"the unsharded develop) vs plain", got, plain))
                del got, plain
        del whole
    raws = _variants(bayer_bases, 4)
    plans = [_plan(r, 8, device, exposure=e) for r, e in zip(raws, (0.3, -0.2, 0.5, 0.1))]
    whole = kdev.develop_batch(plans, torch.stack([_upload(r, device) for r in raws]))
    for spatial in (2, 3):
        shards = kdev.stage_sp(plans[0], [r.data for r in raws], spatial)
        kdev.SP_LAUNCHES = 0
        got = kdev.develop_sp_batch(plans, shards, [device] * spatial)
        launches = kdev.SP_LAUNCHES
        plain = kdev.develop_sp_batch_plain(plans, [s.to(device) for s in shards])
        _sync(device)
        if device.type == "cuda" and launches != len(shards):
            raise AssertionError(f"develop_sp_batch spatial {spatial}: {launches} launches")
        if not torch.equal(got, whole):
            raise AssertionError(f"develop_sp_batch spatial {spatial}: differs from develop_batch")
        worst = max(worst, _check(f"develop_sp_batch B=4 24 MP Bayer spatial {spatial} "
                                  f"({launches} launches; bit-equal to develop_batch) vs plain",
                                  got, plain))
    del whole, got, plain
    if device.type == "cuda":
        torch.cuda.empty_cache()
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


def _develop_files(eng, paths, corrupt, want_counts, label) -> list:
    """eng.develop_files(paths, errors="skip") with the counts zeroed just
    before and read just after; returns the results."""
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
    return outs


def _run_batch(device, paths, corrupt, maxwidth, want_counts, label) -> list:
    """develop_files over `paths` (`_develop_files`), every result checked
    against its single-image plain develop; returns the results."""
    eng = BatchEngine(devices=[device], max_batch=BATCH, maxwidth=maxwidth)
    outs = _develop_files(eng, paths, corrupt, want_counts, label)
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
    return outs


def phase2b(device, paths, corrupt) -> tuple[dict, list, list]:
    """The batch path through BatchEngine.develop_files; returns the main
    path's launches of each batched kernel, the full-size results and the
    thumbnails."""
    none = {k: 0 for k in _counts()}
    full = _run_batch(device, paths, corrupt, 0, dict(none, develop_batch=3),
                      "develop_files, full size")
    thumbs = _run_batch(device, paths, corrupt, BATCH_THUMB, dict(none, develop_scaled_batch=3),
                        f"develop_files, maxwidth {BATCH_THUMB}")
    return {"develop_batch": 3, "develop_scaled_batch": 3}, full, thumbs


def phase2d(device, paths, corrupt, flat) -> int:
    """The width-sharded batch path: BatchEngine(devices=[device, device],
    spatial=2).develop_files over phase 2b's files, each chunk's two shards
    on one card. Every result must equal phase 2b's spatial=1 result (`flat`)
    bit for bit, and the run make 2 shard launches per chunk (2 Bayer
    buckets and 1 X-Trans) and no other launch; at maxwidth 1024 the
    thumbnails develop whole (develop_scaled_batch only). Returns the shard
    launches."""
    none = {k: 0 for k in _counts()}
    on_card = device.type == "cuda"          # off the card the wrappers run plain versions
    eng = BatchEngine(devices=[device, device], spatial=2, max_batch=BATCH)
    outs = _develop_files(eng, paths, corrupt, dict(none, develop_sp=6) if on_card else none,
                          "develop_files, full size, spatial=2 on one card")
    for i, (out, want) in enumerate(zip(outs, flat)):
        if i != corrupt and not np.array_equal(out, want):
            raise AssertionError(f"spatial=2: {paths[i]} differs from spatial=1 in "
                                 f"{int((out != want).sum())} values")
    print(f"  the {len(outs) - 1} results are bit-equal to spatial=1's (phase 2b)")
    eng = BatchEngine(devices=[device, device], spatial=2, max_batch=BATCH, maxwidth=BATCH_THUMB)
    _develop_files(eng, paths, corrupt, dict(none, develop_scaled_batch=3) if on_card else none,
                   f"develop_files, maxwidth {BATCH_THUMB}, spatial=2 (thumbnails develop whole)")
    return 6


def _eager_sp(device, paths, corrupt, label, card, **kw) -> list:
    """develop_files over `paths` by BatchEngine(devices=[device, device],
    spatial=2, **kw) and by BatchEngine(devices=[device], **kw), the
    counts zeroed just before each run and read just after: neither may
    launch a kernel, and the sharded results must equal the unsharded ones
    bit for bit. Prints both host walls beside the card; returns the
    sharded results."""
    none = {k: 0 for k in _counts()}
    outs, walls = {}, {}
    for name, devices, spatial in (("spatial=2", [device, device], 2),
                                   ("spatial=1", [device], 1)):
        eng = BatchEngine(devices=devices, spatial=spatial, max_batch=BATCH, **kw)
        t = time.perf_counter()
        outs[name] = _develop_files(eng, paths, corrupt, none, f"{label}, {name}")
        walls[name] = (time.perf_counter() - t) * 1e3
    for i, (got, want) in enumerate(zip(outs["spatial=2"], outs["spatial=1"])):
        if i != corrupt and not np.array_equal(got, want):
            raise AssertionError(f"{label}: {paths[i]} sharded differs from unsharded in "
                                 f"{int((got != want).sum())} values")
    print(f"  {label}: the {len(paths) - 1} sharded results are bit-equal to spatial=1's; "
          f"host walls {walls['spatial=2']:.1f} ms (spatial=2) vs {walls['spatial=1']:.1f} ms "
          f"(spatial=1) on {card}")
    return outs["spatial=2"]


def _hold_to_kernel(label, outs, kernel_outs, corrupt) -> int:
    """Each eager result within the contract of the kernel's result for the
    same file (phase 2b); returns the max |diff|."""
    worst = 0
    for i, (got, want) in enumerate(zip(outs, kernel_outs)):
        if i != corrupt:
            maxd, frac = kdev.compare(got, want)
            if maxd > kdev.MAX_LSB or frac >= kdev.MAX_FLIP_FRACTION:
                raise AssertionError(f"{label}: result {i} max |diff| {maxd}, differing {frac} "
                                     f"against the kernel's")
            worst = max(worst, maxd)
    print(f"  {label}: within the contract of phase 2b's kernel results, max |diff| {worst}")
    return worst


def phase2d_eager(device, paths, corrupt, flat, thumbs, td, bayer, card) -> None:
    """The width-sharded eager route (engine.develop_batch_perimage_sp) at
    full width: phase 2b's files through BatchEngine(executor="eager") at
    full size, at maxwidth 4000 ('fulldown', and 'full' for the Rotate90
    frames) and at maxwidth BATCH_THUMB (eager 'scaled'); then a mono DNG
    at maxwidth 4000 ('plaindown') and a linear DNG (rgb), each beside the
    corrupt file, with the default executor. Every sharded run is
    bit-equal to spatial=1 and launches no kernel; the full-size and
    thumbnail results hold the contract against phase 2b's kernels."""
    full = _eager_sp(device, paths, corrupt, "eager, full size", card, executor="eager")
    _hold_to_kernel("eager, full size", full, flat, corrupt)
    del full
    _eager_sp(device, paths, corrupt, "eager, maxwidth 4000 (fulldown)", card,
              executor="eager", maxwidth=4000)
    small = _eager_sp(device, paths, corrupt, f"eager, maxwidth {BATCH_THUMB} (scaled)", card,
                      executor="eager", maxwidth=BATCH_THUMB)
    _hold_to_kernel(f"eager, maxwidth {BATCH_THUMB}", small, thumbs, corrupt)
    for name, make, maxwidth in (("mono", traw.synthetic_mono, 4000),
                                 ("linear", traw.synthetic_linear, 0)):
        path = os.path.join(td, f"eager_{name}.dng")
        dng.write_dng(path, make(*bayer, seed=5))
        what = f"{name} {bayer[0]}x{bayer[1]}" + (f", maxwidth {maxwidth}" if maxwidth else "")
        outs = _eager_sp(device, [path, paths[corrupt]], 1, what, card, maxwidth=maxwidth)
        print(f"  {what}: {outs[0].shape} {outs[0].dtype}")


def phase_bands(device, big, card) -> None:
    """The banded eager develop: a `big` Bayer frame in 'lut' numerics
    through develop_fused with bands=None (auto_bands) must equal bands=1
    bit for bit. Two turns of each, in turns; prints each run's peak
    device memory and host wall."""
    raw = traw.synthetic_bayer(*big, seed=3)
    plan = _plan(raw, 8, device, numerics="lut")
    plane = _upload(raw, device)
    outs = {}
    for bands in (None, 1, None, 1):
        _sync(device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        out = develop_fused(plan, plane, bands=bands)
        _sync(device)
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        n = tengine.auto_bands(plan) if bands is None else bands
        print(f"  {big[0]}x{big[1]} Bayer, lut, bands={bands} ({n} band(s)): peak device "
              f"memory {peak} B, host wall {ms:.1f} ms on {card}")
        if bands in outs and not torch.equal(out, outs[bands]):
            raise AssertionError(f"bands={bands}: two runs differ")
        outs[bands] = out
        del out
    if not torch.equal(outs[None], outs[1]):
        raise AssertionError(f"banded develop differs from bands=1 in "
                             f"{int((outs[None] != outs[1]).sum())} values")
    print("  banded develop bit-equal to bands=1")


def phase_empty(device, td) -> None:
    """A staged render whose size rounds to 0: the 98 x 54 Bayer frame at
    maxwidth 1 through Pipeline(device).output_8bit with a cache must give
    (0, 1, 3) u8, with the counts zeroed just before and no launch after
    (the resampler and the fused suffix pass the empty frame through)."""
    path = os.path.join(td, "tiny.dng")
    dng.write_dng(path, traw.synthetic_bayer(98, 54, seed=4))
    pipe = ipt.Pipeline.new_from_file(path, device)
    pipe.globals.settings.maxwidth = 1
    _reset_counts()
    img = pipe.output_8bit(MultiCache(1 << 28))
    _sync(device)
    counts = _counts()
    if img.data.shape != (0, 1, 3) or img.data.dtype != np.uint8:
        raise AssertionError(f"empty output: {img.data.shape} {img.data.dtype}")
    if any(counts.values()):
        raise AssertionError(f"empty output: launches {counts}, want none")
    print(f"  98x54 at maxwidth 1: {img.data.shape} {img.data.dtype}, launches {counts}")


LUT_EDITS = EDITS[:2]                 # phase 2i: the first render and the exposure edit
LUT_CROP = (600, 400)                 # phase 2i: the crop rendered on the card and the CPU
LUT_PROFILED = (0.5, 0.6, 0.7)        # phase 2i: exposures tried in turn under the profiler
LUT_SYNCED = (0.8, 0.9)               # phase 2i: exposures of the synchronized edits, fused
                                      # and per stage


def _profiled_edit(svc, edits, card) -> None:
    """Edits of svc's "frame" under torch.profiler, stages not synchronized,
    one (label, patch) of `edits` after another until a trace holds device
    activity (the profiler at times records none); prints each trace's
    device split and idle share."""
    from torch.profiler import ProfilerActivity, profile

    for label, patch in edits:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            svc.edit("frame", patch)
            pwall = (time.perf_counter() - t) * 1e3
        split = _device_split(prof, pwall)
        if split is None:
            print(f"  {label} under torch.profiler ({pwall:.1f} ms): device split "
                  f"not measured (the trace holds no device activity)")
            continue
        spans, busy = split
        print(f"  {label} under torch.profiler ({pwall:.1f} ms wall): device ms "
              f"{ {k: round(v, 3) for k, v in sorted(spans.items())} }, busy {busy:.3f} ms, "
              f"idle share {1 - busy / pwall:.4f} (on {card})")
        return


def _synced_edits(svc, pipe, label, card) -> None:
    """An exposure edit of LUT_SYNCED fused, then one per stage
    (pipeline.FUSE_SUFFIX = False: each op's `run`), with the package's
    logger at DEBUG so that each stage or fused segment ends in a
    synchronize; prints each one's host ms (device time included). The
    profiler's traces of these edits are at times empty; these spans are
    not."""
    import logging

    pkg_log = logging.getLogger("imagepipe_tpu_torch")
    old_level, old_fuse = pkg_log.level, ppl.FUSE_SUFFIX
    pkg_log.setLevel(logging.DEBUG)
    try:
        for fuse, exposure in zip((True, False), LUT_SYNCED):
            ppl.FUSE_SUFFIX = fuse
            svc.edit("frame", {"basecurve": {"exposure": exposure}})
            ms = {k: round(v, 3) for k, v in pipe.stage_ms.items()}
            print(f"  {label}, edit 'exposure +{exposure}' {'fused' if fuse else 'per stage'}, "
                  f"each stage synchronized: host ms {ms}, sum {sum(ms.values()):.3f} (on {card})")
    finally:
        pkg_log.setLevel(old_level)
        ppl.FUSE_SUFFIX = old_fuse


def _lut_requests(device, source, mode, label, card) -> tuple[list, int]:
    """LUT_EDITS through a fresh RenderService(device) in numerics `mode`
    (color.numerics_mode), each with the counts set to 0 just before; the
    rotate kernel must launch as EDITS says, the suffix kernel once a
    request in the mode's form (`suffix` or `suffix_lut`), nothing else (on
    CUDA); on CUDA one more exposure edit (LUT_PROFILED) under
    torch.profiler gives the mode's device split, and `_synced_edits` the
    fused segment's and the per-stage loop's synchronized ms.
    Returns (the host outputs of LUT_EDITS, their 'lut' suffix launches)."""
    svc = RenderService(cache_bytes=EDIT_CACHE_BYTES, device=device)
    pipe = svc.open_source("frame", source).pipeline
    outs, lut_launches = [], 0
    form = "suffix_lut" if mode == "lut" else "suffix"
    with tcc.numerics_mode(mode):
        for edit, patch, want_rotate, _, _ in LUT_EDITS:
            _reset_counts()
            t = time.perf_counter()
            img = svc.edit("frame", patch)
            ms = (time.perf_counter() - t) * 1e3
            counts = _counts()
            print(f"  {label}, '{mode}', edit '{edit}': {img.data.shape}, host wall {ms:.1f} ms "
                  f"to host pixels (on {card}); launches {({k: v for k, v in counts.items() if v})}")
            want = dict({k: 0 for k in counts}, rotate=want_rotate, **{form: 1})
            if device.type == "cuda" and counts != want:
                raise AssertionError(f"'{mode}' edit '{edit}': launches {counts}, want {want}")
            outs.append(img.data)
            lut_launches += counts["suffix_lut"]
        if device.type == "cuda":
            _profiled_edit(svc, [(f"{label}, '{mode}', edit 'exposure +{e}'",
                                  {"basecurve": {"exposure": e}}) for e in LUT_PROFILED], card)
            _synced_edits(svc, pipe, f"{label}, '{mode}'", card)
    del svc, pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return outs, lut_launches


def phase_lut(device, bayer, bases, card) -> int:
    """2i: the staged edit path in 'lut' numerics on the card (the
    process-wide override, color.numerics_mode): LUT_EDITS of a `bayer`
    DNG through RenderService(device) in 'lut' (one launch of the suffix
    kernel's 'lut' form each) against the same requests in 'direct' (one
    launch of its 'direct' form each), within the contract, in turns
    ('direct', 'lut', 'lut', 'direct'), each from a freshly decoded file
    (so each first render uploads the plane and hashes the frame); the
    same requests on a LUT_CROP crop of the frame on the card against the
    CPU, both 'lut'; after the context 'auto' is 'direct' again and a
    'direct' edit launches the 'direct' form. Then develop_batch_fn(plan)
    over `bases` on the card against the batch kernel (the BatchEngine's
    route) for the same plan. Returns the 'lut' requests' launches of the
    'lut' form."""
    raw = traw.synthetic_bayer(*bayer, seed=6)
    outs, lut_launches = {}, 0
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "lut.dng")
        dng.write_dng(path, raw)
        for mode in ("direct", "lut", "lut", "direct"):
            got, n = _lut_requests(device, decode_file(path), mode, f"{bayer[0]}x{bayer[1]}",
                                   card)
            lut_launches += n
            if mode in outs and not all(np.array_equal(a, b) for a, b in zip(got, outs[mode])):
                raise AssertionError(f"'{mode}': two turns differ")
            outs[mode] = got
    for (edit, *_), got, want in zip(LUT_EDITS, outs["lut"], outs["direct"]):
        _check(f"'lut' vs 'direct', edit '{edit}'", got, want)
    del outs

    width, height = LUT_CROP
    crop = ImageSource.from_raw(dataclasses.replace(
        raw, width=width, height=height, data=np.ascontiguousarray(raw.data[:height, :width])))
    on_card, n = _lut_requests(device, crop, "lut", f"{width}x{height} crop", card)
    lut_launches += n
    on_cpu, _ = _lut_requests(torch.device("cpu"), crop, "lut", f"{width}x{height} crop",
                              "the host CPU")
    for (edit, *_), got, want in zip(LUT_EDITS, on_card, on_cpu):
        _check(f"{width}x{height} crop, 'lut', edit '{edit}': {device.type} vs CPU", got, want)

    if tcc._NUMERICS_MODE is not None or tcc.resolve_numerics("auto", device) != (
            "lut" if device.type == "cpu" else "direct"):
        raise AssertionError(f"after the context: override {tcc._NUMERICS_MODE!r}")
    svc = RenderService(cache_bytes=EDIT_CACHE_BYTES, device=device)
    svc.open_source("frame", crop)
    svc.edit("frame", LUT_EDITS[0][1])
    _reset_counts()
    svc.edit("frame", {"basecurve": {"exposure": 0.4}})
    counts = _counts()
    print(f"  after the context: 'auto' on {device.type} is "
          f"'{tcc.resolve_numerics('auto', device)}'; an exposure edit launches "
          f"{({k: v for k, v in counts.items() if v})}")
    if device.type == "cuda" and (counts["suffix"], counts["suffix_lut"]) != (1, 0):
        raise AssertionError(f"'direct' edit after the context: launches {counts}")
    del svc

    plan = _plan(bases[0], 8, device)
    planes = torch.stack([_upload(b, device) for b in bases])
    _sync(device)
    t = time.perf_counter()
    got = tengine.develop_batch_fn(plan)(planes)
    _sync(device)
    ms = (time.perf_counter() - t) * 1e3
    want = kdev.develop_batch([plan] * len(bases), planes)
    _check(f"develop_batch_fn, B={len(bases)} x {bayer[0]}x{bayer[1]}, vs the batch kernel "
           f"(host wall {ms:.1f} ms on {card})", got, want)
    del planes, got, want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return lut_launches


# -- the fleet: MultiHostBatchEngine in spawned ranks sharing the card --------

def _digest(img) -> str:
    """sha256 of a [H, W, 3] result's bytes (its planar buffer), shape and
    dtype: equal digests are bit-equal results."""
    planar = np.ascontiguousarray(np.moveaxis(img, -1, 0))
    h = hashlib.sha256(f"{img.shape} {img.dtype.str}".encode())
    h.update(memoryview(planar).cast("B"))
    return h.hexdigest()


def _fleet_check(device, paths, thumb, corrupt) -> dict:
    """Phase 2e on one rank: develop_files at full size and at maxwidth
    `thumb` with errors="skip" (counts zeroed just before each run and read
    just after), then errors="raise"."""
    out = {}
    for maxwidth in (0, thumb):
        eng = MultiHostBatchEngine(devices=[device], max_batch=BATCH, maxwidth=maxwidth)
        _reset_counts()
        outs = eng.develop_files(paths)
        _sync(device)
        out[str(maxwidth)] = {
            "counts": _counts(),
            "digests": [None if isinstance(o, BatchError) else _digest(o) for o in outs]}
    t = time.perf_counter()
    try:
        eng.develop_files(paths, errors="raise")
        raised = None
    except Exception as e:
        raised = {"type": type(e).__name__, "message": str(e)[:1000]}
    out["raise"] = {"raised": raised, "seconds": time.perf_counter() - t}
    return out


def _fleet_time(device, paths, thumb, runs) -> dict:
    """Phase 3e on one rank: after a warm-up, `runs` develop_files walls at
    full size and at maxwidth `thumb`, each started after a barrier
    (each ends in the status gather, so a rank's wall is the fleet's), with
    the rank's host split (`timings`) of each run."""
    import torch.distributed as dist

    out = {}
    for maxwidth in (0, thumb):
        eng = MultiHostBatchEngine(devices=[device], max_batch=BATCH, maxwidth=maxwidth)
        eng.develop_files(paths)
        walls, hosts = [], []
        for _ in range(runs):
            eng.engine.timings.clear()
            dist.barrier(group=eng.group)
            t = time.perf_counter()
            outs = eng.develop_files(paths)
            walls.append(time.perf_counter() - t)
            hosts.append({k: round(v * 1e3, 3) for k, v in sorted(eng.engine.timings.items())})
        out[str(maxwidth)] = {"walls": walls, "timings": hosts, "files": len(outs),
                              "decode_workers": eng.engine.decode_workers}
    return out


_FLEET_TASKS = {"check": _fleet_check, "time": _fleet_time}


def _fleet_rank(rank, device, task, store, paths, arg, out_dir) -> None:
    """One spawned rank: join the gloo group over the FileStore `store`, run
    `task` on `device` (all ranks share it), write its report to out_dir/<task>_rank<rank>.json and exit 0,
    or 1 on any failure (its traceback in the report)."""
    import torch.distributed as dist

    report = {"rank": rank, "ok": False}
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=FLEET_RANKS,
                                timeout=datetime.timedelta(seconds=FLEET_TIMEOUT_S))
        try:
            report.update(_FLEET_TASKS[task](torch.device(device), paths, *arg))
            report["ok"] = True
        finally:
            dist.destroy_process_group()
    except Exception:
        report["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"{task}_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    sys.exit(0 if report["ok"] else 1)


def _fleet(device, task, paths, arg) -> list[dict]:
    """Run `task` on `device` in FLEET_RANKS spawned processes (the parent
    has CUDA initialized, so not forked) and return their reports; fails if a rank
    fails or is still running after FLEET_TIMEOUT_S, killing every rank
    left."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as td:
        procs = [ctx.Process(target=_fleet_rank,
                             args=(r, str(device), task, os.path.join(td, "store"), paths, arg,
                                   td))
                 for r in range(FLEET_RANKS)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + FLEET_TIMEOUT_S
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            if hung:
                raise AssertionError(f"fleet {task}: ranks {hung} still running after "
                                     f"{FLEET_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        reports = []
        for r, p in enumerate(procs):
            path = os.path.join(td, f"{task}_rank{r}.json")
            if not os.path.exists(path):
                raise AssertionError(f"fleet {task}: rank {r} exited {p.exitcode} with no report")
            with open(path) as f:
                reports.append(json.load(f))
            if not reports[-1]["ok"] or p.exitcode != 0:
                raise AssertionError(f"fleet {task}: rank {r} failed (exit {p.exitcode}):\n"
                                     f"{reports[-1].get('error')}")
    return reports


def phase2e(device, paths, corrupt, full, thumbs) -> None:
    """The multi-process feed: FLEET_RANKS spawned ranks, a gloo group on a
    FileStore, each running MultiHostBatchEngine(devices=["cuda:0"]) over
    phase 2b's files at full size and at maxwidth BATCH_THUMB. Every result
    of each rank must be bit-equal to phase 2b's (`full`, `thumbs`) for the
    same path, the corrupt file (rank 1's) a BatchError, each rank's runs
    launch only develop_batch (full size) or develop_scaled_batch, at least
    once; then errors="raise" must make both ranks raise within
    FLEET_RAISE_LIMIT_S: the failing rank its own error, the other a
    RuntimeError naming it and the path."""
    reports = _fleet(device, "check", paths, (BATCH_THUMB, corrupt))
    bad_rank = corrupt % FLEET_RANKS
    for r, rep in enumerate(reports):
        slots = list(range(len(paths)))[r::FLEET_RANKS]
        for maxwidth, want, kernel in ((0, full, "develop_batch"),
                                       (BATCH_THUMB, thumbs, "develop_scaled_batch")):
            got = rep[str(maxwidth)]
            counts = got["counts"]
            stray = {k: v for k, v in counts.items() if v and k != kernel}
            if device.type == "cuda" and (counts[kernel] <= 0 or stray):
                raise AssertionError(f"fleet rank {r} maxwidth {maxwidth}: launches {counts}, "
                                     f"want {kernel} > 0 and no other")
            if len(got["digests"]) != len(slots):
                raise AssertionError(f"fleet rank {r}: {len(got['digests'])} results for "
                                     f"{len(slots)} files")
            for i, digest in zip(slots, got["digests"]):
                if i == corrupt:
                    if digest is not None:
                        raise AssertionError(f"fleet rank {r}: the corrupt slot holds a result")
                elif digest != _digest(want[i]):
                    raise AssertionError(f"fleet rank {r} maxwidth {maxwidth}: {paths[i]} "
                                         f"differs from phase 2b's result")
            print(f"  rank {r}, maxwidth {maxwidth}: {len(slots)} files (slots {slots}), "
                  f"launches {counts}; every result bit-equal to phase 2b's"
                  + (f", the corrupt file a BatchError" if corrupt in slots else ""))
        raised, seconds = rep["raise"]["raised"], rep["raise"]["seconds"]
        print(f"  rank {r}, errors=\"raise\": raised {raised} after {seconds:.2f} s")
        if raised is None or seconds > FLEET_RAISE_LIMIT_S:
            raise AssertionError(f"fleet rank {r}: errors='raise' gave {raised} in {seconds} s")
        named = raised["type"] == "RuntimeError" and f"rank {bad_rank}" in raised["message"]
        if r == bad_rank and named:
            raise AssertionError(f"fleet rank {r}: raised its peer's error, not its own")
        if r != bad_rank and not (named and paths[corrupt] in raised["message"]):
            raise AssertionError(f"fleet rank {r}: {raised} does not name rank {bad_rank} "
                                 f"and {paths[corrupt]}")


def phase3e(device, bayer_paths, single_mps, card) -> None:
    """The fleet timed: FLEET_RANKS ranks sharing the card over the 16 Bayer
    files, source MP/s of the slowest rank's wall (median of 3), beside
    phase 3b's single-process BatchEngine, with each rank's host split."""
    reports = _fleet(device, "time", bayer_paths, (BATCH_THUMB, 3))
    mp = len(bayer_paths) * BAYER[0] * BAYER[1] / 1e6
    for maxwidth in (0, BATCH_THUMB):
        label = "full size" if not maxwidth else f"-> {maxwidth}"
        per = [rep[str(maxwidth)] for rep in reports]
        walls = [max(p["walls"][i] for p in per) * 1e3 for i in range(len(per[0]["walls"]))]
        wall = statistics.median(walls)
        print(f"  fleet of {FLEET_RANKS} ranks on one card, {len(bayer_paths)} x 24 MP Bayer, "
              f"{label}: {mp / wall * 1e3:.1f} source MP/s (median of {len(walls)} fleet walls "
              f"{[round(w, 1) for w in walls]} ms), single process (phase 3b, this call) "
              f"{single_mps[label]:.1f} MP/s (on {card})")
        for r, p in enumerate(per):
            print(f"    rank {r}: {p['files']} files, {p['decode_workers']} decode threads, walls "
                  f"{[round(w * 1e3, 1) for w in p['walls']]} ms; host ms of the last run "
                  f"{p['timings'][-1]}")


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
                else "kernel" if any(k in name for k in ("develop_kernel", "scaled_kernel",
                                                           "rotate_kernel", "suffix_kernel"))
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


def phase3b(device, bayer_paths, bayer_bases, card) -> tuple[dict, dict]:
    """The batch path timed: develop_files throughput, host and device
    split, and the batched launch against a loop of single launches.
    Returns the kernels' times and develop_files' source MP/s by size."""
    from torch.profiler import ProfilerActivity, profile

    mp = len(bayer_paths) * BAYER[0] * BAYER[1] / 1e6
    sources = [decode_file(p) for p in bayer_paths]
    mps = {}
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
        mps[label] = mp / wall * 1e3
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
            (0, kdev.develop_batch, kdev.develop, kdev.develop_batch_plain, tdk.develop_bound,
             "develop_batch"),
            (BATCH_THUMB, kds.develop_scaled_batch, kds.develop_scaled, kds.develop_scaled_batch_plain,
             tdk.scaled_bound, "develop_scaled_batch")):
        plans = [_plan(r, 8, cpu, numerics="direct", maxwidth=maxwidth) for r in raws]
        on_card = [p.to(device) for p in plans]
        t = {"batched": tdk.device_ms([lambda: batched(plans, planes)], device),
             "loop": tdk.device_ms([lambda: [single(p, planes[i]) for i, p in enumerate(plans)]],
                                   device),
             "plain": {"ms": _plain_ms(lambda: plain(on_card, planes), device)}}
        bound = bound_of(plans[0], planes[0])
        print(f"  {name} B={BATCH} (24 MP {f'-> {maxwidth}' if maxwidth else '8-bit'}): "
              f"batched {t['batched']['ms']:.4f} ms ({t['batched']['ms'] / BATCH:.4f} ms/image), "
              f"loop of single launches {t['loop']['ms']:.4f} ms ({t['loop']['ms'] / BATCH:.4f} "
              f"ms/image), plain {t['plain']['ms']:.4f} ms; bound {bound[0] * BATCH:.4f} ms by "
              f"{bound[1]}; device ms of calls back to back (batched runs {t['batched']['runs']}, "
              f"loop runs {t['loop']['runs']}{', HOST-BOUND' if t['loop']['host_bound'] else ''}), "
              f"plain one call from idle (on {card})")
        times.update(_timing(name, t["batched"]["ms"], t["plain"]["ms"], bound, BATCH))
    return times, mps


def sp_bound(plan, plane, shards) -> tuple[float, str]:
    """The width-sharded develop's bound: the unsharded develop's
    (`tdk.develop_bound`) plus the halo columns each shard reads again."""
    px = plan.height * plan.width
    halo = 2 * (len(shards) - 1) * plan.height * plane.element_size()
    return tdk.roofline(px * plane.element_size() + halo, 3 * px * plan.out_bits // 8,
                        px * (tdk.OPS_LEVELS + tdk.OPS_DEMOSAIC_BAYER + tdk.OPS_FINISH))


def phase3d(device, card) -> dict:
    """The width-sharded develop timed at spatial 2 on one card, 60 MP
    Bayer 16-bit and 24 MP Bayer 8-bit: device ms (the timing script's
    method, 3 distinct inputs) of the shard launches of one image, the halo
    exchange, the assembly, and the whole develop_sp beside the unsharded
    develop; the plain version from idle. Returns the 60 MP figures."""
    times = {}
    for label, (w, h), bits in (("60 MP Bayer 16-bit", BIG, 16), ("24 MP Bayer 8-bit", BAYER, 8)):
        raws = [traw.synthetic_bayer(w, h, seed=30 + i) for i in range(tdk.INPUTS)]
        plan = _plan(raws[0], bits, device, numerics="direct")
        planes = [_upload(r, device) for r in raws]
        staged = [[s.to(device) for s in kdev.stage_sp(plan, r.data, 2)] for r in raws]
        x_offs = [x for x, _ in kdev.sp_shards(plan.width, 2)]
        tables = kdev._device_tables(plan, device)
        for shards in staged:
            kdev.exchange_halos(shards)
        outs = [[kdev._launch(plan, s[None], *tables, x_off=x)[0] for s, x in zip(shards, x_offs)]
                for shards in staged]
        t = {
            "shard launches": tdk.device_ms([lambda s=s: [kdev._launch(plan, sh[None], *tables, x_off=x)
                                                          for sh, x in zip(s, x_offs)]
                                             for s in staged], device),
            "halo exchange": tdk.device_ms([lambda s=s: kdev.exchange_halos(s) for s in staged],
                                           device),
            "assembly": tdk.device_ms([lambda o=o: kdev.assemble(o, device) for o in outs], device),
            "develop_sp": tdk.device_ms([lambda s=s: kdev.develop_sp(plan, s, [device] * 2)
                                         for s in staged], device),
            "develop (unsharded)": tdk.device_ms([lambda p=p: kdev.develop(plan, p) for p in planes],
                                                 device),
        }
        pms = _plain_ms(lambda: kdev.develop_sp_plain(plan, staged[0]), device)
        bound = sp_bound(plan, planes[0], staged[0])
        print(f"  develop_sp {label}, spatial 2 on one card (shards "
              f"{kdev.sp_shards(plan.width, 2)}), device ms back to back: "
              + "; ".join(f"{k} {v['ms']:.4f} (runs {v['runs']}"
                          f"{', HOST-BOUND' if v['host_bound'] else ''})" for k, v in t.items())
              + f"; plain {pms:.4f} ms one call from idle; bound {bound[0]:.4f} ms by {bound[1]} "
                f"(on {card})")
        if not times:
            times.update(_timing("develop_sp", t["shard launches"]["ms"], pms, bound))
        del raws, planes, staged, outs
        torch.cuda.empty_cache()
    return times


# -- the staged edit path and the rotate kernel -----------------------------

def _rotate_source(device, shape, seed) -> torch.Tensor:
    """A seeded uniform [C, H, W] float32 source, made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def _plant_nonfinite(src, seed) -> torch.Tensor:
    """`src` with ROTATE_NONFINITE each of NaN, +Inf and -Inf written at
    seeded positions (in place)."""
    gen = torch.Generator(device=src.device).manual_seed(seed)
    flat = src.view(-1)
    at = torch.randint(0, flat.numel(), (3, ROTATE_NONFINITE), generator=gen, device=src.device)
    for row, value in zip(at, (float("nan"), float("inf"), float("-inf"))):
        flat[row] = value
    return src


def _check_rotate(label, src, geometry, direct) -> float:
    """The rotate kernel against its plain version on `src`: max |diff| <=
    krot.MAX_ABS_DIFF and the same NaN and zero pattern, and on the card
    `direct` (0 or 1) launches on the direct route; returns max |diff|."""
    c, h, w = src.shape
    tl, tr, bl, nw, nh = geometry
    before = krot.DIRECT_LAUNCHES
    got = krot.rotate_resample_planar(src, w, h, tl, tr, bl, nw, nh, c)
    routed = krot.DIRECT_LAUNCHES - before
    want = krot.rotate_resample_plain(src, w, h, tl, tr, bl, nw, nh, c)
    _sync(src.device)
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    same_nan = torch.equal(torch.isnan(got), torch.isnan(want))
    same_zero = torch.equal(got == 0, want == 0)
    maxd = float((got - want).abs().nan_to_num(0.0).max())
    route = ("plain version" if src.device.type != "cuda"
             else "direct route" if routed else "staged route")
    print(f"  {label}: {w}x{h} -> {nw}x{nh}, {route}, max |diff| {maxd}, "
          f"NaN pattern {'same' if same_nan else 'DIFFERS'} ({int(torch.isnan(got).sum())} NaN), "
          f"zero pattern {'same' if same_zero else 'DIFFERS'} ({int((got == 0).sum())} zeros "
          f"of {got.numel()})")
    if not (same_nan and same_zero) or maxd > krot.MAX_ABS_DIFF:
        raise AssertionError(f"{label}: max |diff| {maxd} (limit {krot.MAX_ABS_DIFF}), "
                             f"NaN pattern same {same_nan}, zero pattern same {same_zero}")
    if src.device.type == "cuda" and routed != direct:
        raise AssertionError(f"{label}: {routed} direct-route launches, want {direct}")
    return maxd


def phase1c(device, bayer) -> float:
    """The rotate kernel vs its plain version at the staged path's 24 MP
    shapes, on a source with non-finite values, and at degenerate
    geometries, with the route of each; returns the largest |diff|."""
    width, height = bayer
    src = _rotate_source(device, (4, height, width), 5)
    worst = 0.0
    for label, rotation, crop in ROTATE_CASES:
        worst = max(worst, _check_rotate(label, src, tdk.rotatecrop_geometry(
            rotation, crop, width, height), direct=0))
    # The first render's demosaic stage is 5999 x 3999: rows of an odd
    # width take the staged route's 4-byte copies.
    odd = src[:, :height - 1, :width - 1].contiguous()
    worst = max(worst, _check_rotate("rotation 0.05, crop_left 0.05, odd width", odd,
                                     tdk.rotatecrop_geometry(0.05, 0.05, width - 1, height - 1),
                                     direct=0))
    del odd
    tl, tr, bl, nw, nh = tdk.rotatecrop_geometry(0.05, 0.05, width, height)
    for factor, direct in ((2, 0), (8, 1)):
        worst = max(worst, _check_rotate(f"rotation 0.05, x{factor} downscale", src,
                                         (tl, tr, bl, nw // factor, nh // factor), direct))
    _plant_nonfinite(src, 8)
    for label, rotation, crop in (ROTATE_CASES[0], ROTATE_CASES[2]):
        worst = max(worst, _check_rotate(
            f"{label}, {ROTATE_NONFINITE} each of NaN, +Inf, -Inf planted", src,
            tdk.rotatecrop_geometry(rotation, crop, width, height), direct=0))
    small = _rotate_source(device, (4, 100, 100), 6)
    for label, geometry, direct in (
            ("output 1 wide", ((0, 0), (99, 10), (-10, 99), 1, 50), 1),
            ("output 1 high", ((0, 0), (99, 10), (-10, 99), 50, 1), 1),
            ("zero x-step", ((5, 0), (5, 40), (0, 99), 50, 50), 0),
            # A x4 sheared, mirrored downscale: two buffers of its tiles'
            # boxes (the whole source) exceed a block's shared memory.
            ("corners outside the source", ((-40, 80), (120, -30), (-90, -20), 40, 30), 1)):
        worst = max(worst, _check_rotate(label, small, geometry, direct))
    del src, small
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return worst


def _check_rotate_cfa(label, src, geometry, cfa, direct) -> float:
    """The rotate kernel's CFA route against its plain version on the
    sensor plane `src` [1, H, W]: bit-equal (floats to the bit where not
    NaN, NaN at the same places), one CFA launch on the card, `direct` (0
    or 1) of them in the direct form; returns max |diff| (0 expected)."""
    _, h, w = src.shape
    tl, tr, bl, nw, nh = geometry
    before, before_direct = krot.CFA_LAUNCHES, krot.CFA_DIRECT_LAUNCHES
    got = krot.rotate_resample_cfa(src, w, h, tl, tr, bl, nw, nh, cfa)
    launched = krot.CFA_LAUNCHES - before
    routed = krot.CFA_DIRECT_LAUNCHES - before_direct
    want = krot.rotate_resample_cfa_plain(src, w, h, tl, tr, bl, nw, nh, cfa)
    _sync(src.device)
    same, maxd = _same_bits(got, want)
    form = ("plain version" if src.device.type != "cuda"
            else "direct form" if routed else "staged form")
    print(f"  CFA {label}: [1, {h}, {w}] -> [4, {nh}, {nw}], {form}, "
          f"{'bit-equal' if same else 'DIFFERS'} (max |diff| {maxd}; "
          f"{int(torch.isnan(got).sum())} NaN, {int((got == 0).sum())} zeros of {got.numel()})")
    if not same:
        raise AssertionError(f"CFA {label}: differs from the plain version (max |diff| {maxd})")
    if src.device.type == "cuda" and (launched, routed) != (1, direct):
        raise AssertionError(f"CFA {label}: {launched} CFA-route launches, {routed} in the "
                             f"direct form; want 1 and {direct}")
    return maxd


def phase1c_cfa(device, bayer) -> float:
    """The rotate kernel's CFA route vs its plain version, bit for bit, and
    the form each case takes: a 24 MP sensor plane with the RGGB and the
    X-Trans CFA rotated 0.05 with crop_left 0.05, rotated 0.5 (45 degrees)
    and with a x2 downscale, the same at 0.05 and 45 degrees with NaN and
    +-Inf planted, the 5999x3999 stage (4-byte copies) at 0.05 (staged
    form); outputs 1 wide and 1 high (direct form), phase 2f's launch among
    them, with and without NaN and +-Inf. Returns the largest |diff|."""
    width, height = bayer
    geometry = tdk.rotatecrop_geometry(0.05, 0.05, width, height)
    tl, tr, bl, nw, nh = geometry
    src = _rotate_source(device, (1, height, width), 11)
    bad = _plant_nonfinite(src.clone(), 12)
    small = _rotate_source(device, (1, 100, 100), 13)
    worst = 0.0
    for label, name in CFA_NAMES:
        cfa = traw.CFA(name)
        for case, plane, g in (
                ("rotation 0.05, crop_left 0.05", src, geometry),
                ("rotation 0.5 (45 degrees)", src,
                 tdk.rotatecrop_geometry(0.5, 0.0, width, height)),
                ("rotation 0.05, x2 downscale", src, (tl, tr, bl, nw // 2, nh // 2)),
                (f"rotation 0.05, crop_left 0.05, {ROTATE_NONFINITE} each of NaN, +Inf, -Inf "
                 f"planted", bad, geometry),
                (f"rotation 0.5 (45 degrees), {ROTATE_NONFINITE} each of NaN, +Inf, -Inf "
                 f"planted", bad, tdk.rotatecrop_geometry(0.5, 0.0, width, height))):
            worst = max(worst, _check_rotate_cfa(f"{label} {case}", plane, g, cfa, direct=0))
        for case, small_geometry in (("output 1 wide", ((0, 0), (99, 10), (-10, 99), 1, 50)),
                                     ("output 1 high", ((0, 0), (99, 10), (-10, 99), 50, 1))):
            worst = max(worst, _check_rotate_cfa(f"{label} {case}", small, small_geometry, cfa,
                                                 direct=1))
    # The first render's demosaic stage is 5999 x 3999: rows of an odd
    # width take the staged form's 4-byte copies.
    odd = src[:, :height - 1, :width - 1].contiguous()
    worst = max(worst, _check_rotate_cfa(
        "RGGB rotation 0.05, crop_left 0.05, odd width", odd,
        tdk.rotatecrop_geometry(0.05, 0.05, width - 1, height - 1), traw.CFA("RGGB"), direct=0))
    # Phase 2f's launch: every pixel's centre is NaN, so the direct form
    # writes zeros without a walk, whatever the plane holds.
    sw, sh, *strip = tdk.CFA_STRIP_CASE
    del src, bad
    plane = _rotate_source(device, (1, sh, sw), 15)
    for case, p in (("", plane), (f", {ROTATE_NONFINITE} each of NaN, +Inf, -Inf planted",
                                  _plant_nonfinite(plane.clone(), 16))):
        worst = max(worst, _check_rotate_cfa(f"RGGB phase 2f's strip{case}", p, strip,
                                             traw.CFA("RGGB"), direct=1))
    del small, odd, plane, p
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return worst


def phase2f(device, card) -> tuple[int, dict]:
    """The CFA route's main path: a staged render (Pipeline.output_8bit
    with a cache) of a 24 MP vertical strip at maxwidth 1, whose scaled
    demosaic to a 1-px-wide stage is the CFA-aware rotated resample. It must
    launch the CFA route once and the other resample and develop kernels
    never, and agree with the same render on the CPU. Returns the CFA
    route's launches and that launch's timing (device ms, plain ms, bound)."""
    calls = []
    wrapper = krot.rotate_resample_cfa

    def recorded(*args):          # the main path's CFA call, to time it below
        calls.append(args)
        return wrapper(*args)

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "strip.dng")
        dng.write_dng(path, traw.synthetic_bayer(*STRIP, seed=14))
        pipe = ipt.Pipeline.new_from_file(path, device)
        pipe.globals.settings.maxwidth = 1
        krot.rotate_resample_cfa = recorded
        try:
            _reset_counts()
            img = pipe.output_8bit(MultiCache(EDIT_CACHE_BYTES)).data
            _sync(device)
            counts = _counts()
            direct = krot.CFA_DIRECT_LAUNCHES
        finally:
            krot.rotate_resample_cfa = wrapper
        cpu = ipt.Pipeline.new_from_file(path, "cpu")
        cpu.globals.settings.maxwidth = 1
        want = cpu.output_8bit(MultiCache(EDIT_CACHE_BYTES)).data
    print(f"  staged render of a {STRIP[0]}x{STRIP[1]} Bayer strip at maxwidth 1: "
          f"{img.shape}, demosaic stage {pipe.globals.settings.demosaic_width}x"
          f"{pipe.globals.settings.demosaic_height}; launches {counts}")
    stray = {k: v for k, v in counts.items() if v and k not in ("rotate_cfa", "suffix")}
    if device.type == "cuda" and (counts["rotate_cfa"] != 1 or direct != 1 or stray):
        raise AssertionError(f"staged 1-px-wide render: launches {counts}, {direct} in the CFA "
                             f"route's direct form; want rotate_cfa 1, in the direct form")
    if img.shape != (STRIP[1] // STRIP[0], 1, 3):
        raise AssertionError(f"staged 1-px-wide render: shape {img.shape}")
    _check("staged 1-px-wide render, card vs CPU", img, want)
    if device.type != "cuda" or len(calls) != 1:
        return counts["rotate_cfa"], {}
    src, w, h, tl, tr, bl, nw, nh, cfa = calls[0]
    if (w, h, tl, tr, bl, nw, nh) != tdk.CFA_STRIP_CASE:
        raise AssertionError(f"phase 2f's CFA call {(w, h, tl, tr, bl, nw, nh)} is not the "
                             f"timing script's CFA_STRIP_CASE {tdk.CFA_STRIP_CASE}")
    fn = lambda: wrapper(*calls[0])
    t = tdk.device_ms([fn], device)
    t["from_idle_ms"] = tdk.from_idle_ms(fn, device)
    t["bound_ms"], t["bound_by"] = tdk.rotate_bound(1, h, w, (tl, tr, bl, nw, nh), device, 4)
    _show(f"its CFA launch, direct form, [1, {h}, {w}] -> [4, {nh}, {nw}]", t, card)
    pms = _plain_ms(lambda: krot.rotate_resample_cfa_plain(src, w, h, tl, tr, bl, nw, nh, cfa),
                    device)
    print(f"    plain {pms:.4f} ms one call from idle")
    return counts["rotate_cfa"], _timing("rotate_cfa", t["ms"], pms, (t["bound_ms"],
                                                                       t["bound_by"]))


def _suffix_inputs(device, shape, seed, numerics="direct") -> list:
    """The inputs of phase 1e's segments on a width x height frame, one per
    segment start (tdk.SUFFIX_STARTS): a seeded [4, H, W] float32 plane over
    [-0.1, 1.2), then the plain stages' outputs on it in `numerics` (Lab,
    the curved Lab, linear RGB with values below 0 and above 1), each with
    ROTATE_NONFINITE each of NaN, +Inf and -Inf planted."""
    width, height = shape
    base = _rotate_source(device, (4, height, width), seed) * 1.3 - 0.1
    seg = [(s, p) for s, p in tdk.suffix_segment(device) if s is not None]
    inter = ksuf.suffix_plain(base, [s for s, _ in seg], [p for _, p in seg],
                              numerics=numerics)[0]
    ins = [base] + inter[:len(tdk.SUFFIX_STARTS) - 1]
    return [_plant_nonfinite(x.clone(), seed + 1 + k) for k, x in enumerate(ins)]


def _same_bits(got, want) -> tuple[bool, float]:
    """(bit-equal, max |diff|): floats equal bit for bit where neither is
    NaN and NaN at the same places; integers equal."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    if not got.is_floating_point():
        return torch.equal(got, want), float((got.int() - want.int()).abs().max())
    nan = got.isnan()
    g, w = got.masked_fill(nan, 0.0), want.masked_fill(want.isnan(), 0.0)
    same = torch.equal(nan, want.isnan()) and torch.equal(g.view(torch.int32),
                                                          w.contiguous().view(torch.int32))
    diff = (g - w).abs().nan_to_num(0.0, posinf=0.0)
    return same, float(diff.max())


def _lut_fallbacks(ins, device) -> tuple[int, int]:
    """(to_lab's, gamma's) lookups of phase 1e's inputs `ins` that take
    color.TransformLUT's out-of-range fallback: the three XYZ / W values of
    each pixel of the to_lab input outside [0, 1] (NaN included), computed
    as color.camera_to_lab_planar computes them, and the NaN of the gamma
    input (clamped to [0, 1] first)."""
    params = dict((s, p) for s, p in tdk.suffix_segment(device) if s is not None)["to_lab"]
    mul, cm = (torch.as_tensor(np.asarray(v, np.float32), device=device) for v in params)
    x = ins[0]
    wb = [torch.clamp(x[c] * mul[c], max=1.0) for c in range(4)]
    xyz = [((wb[0] * cm[r, 0] + wb[1] * cm[r, 1]) + wb[2] * cm[r, 2]) + wb[3] * cm[r, 3]
           for r in range(3)]
    looked = torch.stack([xyz[0] / tcc.XW, xyz[1], xyz[2] / tcc.ZW])
    lab = int((~((looked >= 0) & (looked <= 1))).sum())
    return lab, int(ins[tdk.SUFFIX_STARTS.index("gamma")].isnan().sum())


def phase1e(device, shapes, numerics="direct") -> float:
    """The suffix kernel in `numerics` ('direct' or 'lut') against its
    plain version in the same numerics, bit for bit: on each frame of
    `shapes`, every segment start (rotatecrop/to_lab, basecurve, from_lab,
    gamma) to the 8-bit and the 16-bit linear output, Normal, Rotate90 and
    Transverse, every stage output kept and only the last; and a
    monochrome frame from to_lab. Inputs carry NaN, +-Inf, negative values
    and values above 1 ('lut': how many of its lookups take the
    out-of-range fallback is printed). Returns the largest |diff| (0
    expected)."""
    worst = 0.0
    lut = numerics == "lut"
    launched = (lambda: ksuf.LUT_LAUNCHES) if lut else (lambda: ksuf.LAUNCHES)
    for shape in shapes:
        ins = _suffix_inputs(device, shape, 31, numerics)
        nan_in = [int(x.isnan().sum()) for x in ins]
        if lut:
            lab, gamma = _lut_fallbacks(ins, device)
            print(f"  {shape[0]}x{shape[1]} 'lut': {lab} of the to_lab input's "
                  f"{3 * shape[0] * shape[1]} XYZ lookups and {gamma} of the gamma input's take "
                  f"the out-of-range fallback")
        cases = [(o, bits, False) for o in SUFFIX_ORIENTATIONS for bits in (8, 16)]
        cases += [("Normal", bits, True) for bits in (8, 16)]
        for orientation, bits, mono in cases:
            seg = tdk.suffix_segment(device, bits, orientation, mono)
            checked = []
            for k, start in enumerate(tdk.SUFFIX_STARTS):
                if mono and k:
                    break
                real = [(s, p) for s, p in seg[k:] if s is not None]
                if not real:          # 16-bit Normal from gamma: nothing to launch
                    continue
                stages, params = [s for s, _ in real], [p for _, p in real]
                for keep_all in (True, False):
                    keep = [keep_all or i == len(stages) - 1 for i in range(len(stages))]
                    before = launched()
                    got = ksuf.run_suffix(ins[k], stages, params, bits, keep, numerics)
                    if device.type == "cuda" and launched() != before + 1:
                        raise AssertionError(f"the suffix kernel did not launch once in "
                                             f"'{numerics}'")
                    want = ksuf.suffix_plain(ins[k], stages, params, bits, keep, numerics)
                    _sync(device)
                    for name, g, w in zip(stages + ["quantize"], got[0] + [got[1]],
                                          want[0] + [want[1]]):
                        if (g is None) != (w is None):
                            raise AssertionError(f"{start}: output {name} kept by one side only")
                        if g is None:
                            continue
                        same, maxd = _same_bits(g, w)
                        worst = max(worst, maxd)
                        if not same:
                            raise AssertionError(
                                f"suffix '{numerics}' {shape} {orientation} {bits}-bit "
                                f"mono={mono} from {start}, keep {keep}: {name} differs from "
                                f"the plain version (max |diff| {maxd})")
                    del got, want
                checked.append(start)
            print(f"  {shape[0]}x{shape[1]} '{numerics}' {orientation}"
                  f"{' monochrome' if mono else ''} {bits}-bit{' linear' if bits == 16 else ''}: "
                  f"from {', '.join(checked)}, every stage kept and the last only: bit-equal "
                  f"to the plain version (inputs' NaN {nan_in})")
        del ins
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return worst


# -- the develop kernels' stage_limit cuts (finish.cuh develop_rgb) ----------

CUT_WIDTHS = (1024, 160)       # phase 1g: the scaled kernel's cut geometries (160: chunked on a TPU)


def phase1g(device, bayer, xtrans, card) -> tuple[dict, dict, dict]:
    """The develop kernels cut at stage_limit 1, 2 and 3 (the back end
    stopped after the demosaic, Lab or the spline and quantized without
    gamma: the JAX package's _finish_tile(stage_limit) profiling knob),
    through their public wrappers with the counts set to 0 just before and
    read just after: develop(plan, plane, stage_limit=k) on 24 MP Bayer
    8-bit and 16-bit linear and 26 MP X-Trans 8-bit, develop_scaled(...,
    stage_limit=k) on 24 MP Bayer to each width of CUT_WIDTHS; one launch of
    the cut's own count each, nothing else; each held to its plain version
    (contract). Then each cut timed at 24 MP Bayer 8-bit beside the whole
    kernel (tdk.cut_times: full size and -> 1024), the plain versions one
    call from idle, and the split printed: everything up to the demosaic
    (cut 1), Lab (2 - 1), the spline (3 - 2), Lab^-1 + XYZ->RGB + gamma
    (4 - 3). Returns ({row: launches}, {row: max |diff|}, {row: timing})
    for the kernels line's rows develop_cut{k} and develop_scaled_cut{k}."""
    cuts = tdk.CUTS[:-1]
    b, x = traw.synthetic_bayer(*bayer, seed=21), traw.synthetic_xtrans(*xtrans, seed=21)
    bname, xname = f"{bayer[0]}x{bayer[1]} Bayer", f"{xtrans[0]}x{xtrans[1]} X-Trans"
    cases = [("develop", f"{bname} 8-bit", b, 8, 0),
             ("develop", f"{bname} 16-bit linear", b, 16, 0),
             ("develop", f"{xname} 8-bit", x, 8, 0)]
    cases += [("develop_scaled", f"{bname} 8-bit -> {w}", b, 8, w) for w in CUT_WIDTHS]
    runs = []
    for kernel, label, raw, bits, maxwidth in cases:
        plan = _plan(raw, bits, device, maxwidth=maxwidth)
        plane = _upload(raw, device)
        wrapper = kdev.develop if kernel == "develop" else kds.develop_scaled
        plain = kdev.develop_plain if kernel == "develop" else kds.develop_scaled_plain
        runs.append((kernel, label, plan, plane, wrapper, plain))
    _sync(device)
    _reset_counts()
    outs = [[wrapper(plan, plane, stage_limit=k) for k in cuts]
            for _, _, plan, plane, wrapper, _ in runs]
    _sync(device)
    counts = _counts()
    want = {k: 0 for k in counts}
    for kernel, *_ in runs:
        for k in cuts:
            want[f"{kernel}_cut{k}"] += 1
    print(f"  {len(runs)} frames x cuts {cuts} through develop / develop_scaled: launches "
          f"{({k: v for k, v in counts.items() if v})}")
    if device.type == "cuda" and counts != want:
        raise AssertionError(f"cuts: launches {counts}, want {want}")
    launches = {k: v for k, v in counts.items() if "_cut" in k}
    errors = dict.fromkeys(launches, 0)
    for (kernel, label, plan, plane, _, plain), got in zip(runs, outs):
        for k, g in zip(cuts, got):
            errors[f"{kernel}_cut{k}"] = max(errors[f"{kernel}_cut{k}"], _check(
                f"{kernel} {label} stage_limit {k} vs plain", g, plain(plan, plane, k)))
    del outs
    if device.type != "cuda":
        print("  cut timings: not measured off the card")
        return launches, errors, {}

    timed = tdk.cut_times(device)
    times = {}
    for kernel, maxwidth, (_, _, plan, plane, _, plain) in (("develop", 0, runs[0]),
                                                            ("develop_scaled", 1024, runs[3])):
        ms = {}
        for k in tdk.CUTS:
            label = tdk.cut_label(kernel, k, maxwidth)
            t = timed[label]
            _show(label, t, card)
            ms[k] = t["ms"]
            if k == 4:
                continue
            pms = _plain_ms(lambda: plain(plan, plane, k), device)
            print(f"    plain {pms:.4f} ms one call from idle")
            times.update(_timing(f"{kernel}_cut{k}", t["ms"], pms, (t["bound_ms"],
                                                                    t["bound_by"])))
        print(f"  split of {kernel}'s {ms[4]:.4f} ms device (24 MP Bayer 8-bit"
              f"{f' -> {maxwidth}' if maxwidth else ''}): up to the demosaic (cut 1) "
              f"{ms[1]:.4f}, Lab {ms[2] - ms[1]:.4f}, spline {ms[3] - ms[2]:.4f}, "
              f"Lab^-1 + XYZ->RGB + gamma {ms[4] - ms[3]:.4f} (on {card})")
    del runs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches, errors, times


# -- the develop kernel's ablation ladder (csrc/develop_variants.cu) ---------

# The kernels line's rung for each form: A its top, comparable with the
# develop kernel; B its floor, beside the library call that computes it.
LADDER_ROWS = {"develop_variants": "full_A_u16_u8", "develop_variants3": "noop_B_u16_u8"}
LADDER_TILE2 = (32, 768)      # a second TPU tile dma_floor form A is held at
LADDER_ODD = (6001, 4001)     # (width, height): rows off 16 bytes, the vector-load route


def _hold_rung(r, tile, got, want, errors) -> None:
    """Print a rung's comparison with its plain version and raise unless u8
    is within 1 LSB on < 2% of values and float32 bit-equal."""
    maxd, frac = kv.compare_variant(got, want)
    bits = torch.equal(got, want)
    ok = bits if r.output == "f32" else maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION
    print(f"    {r.name}{f' tile {tile}' if tile else ''}: max |diff| {maxd}, differing "
          f"{frac:.6f}{', bit-equal' if bits else ''}")
    if not ok:
        raise AssertionError(f"{r.name}: max |diff| {maxd}, differing {frac}, bit-equal {bits} "
                             f"against the plain version")
    entry = "develop_variants" if r.form == "A" else "develop_variants3"
    errors[entry] = max(errors[entry], maxd)


def phase1f(device, size, card, odd=LADDER_ODD) -> tuple[dict, dict, dict]:
    """The ladder's path: every rung of both experiments' kernels
    (tkv.rungs(): each variant and form, u16 and f32 planes, u8 and f32
    outputs) once through kernels.variants.run_variant on a `size` synthetic
    Bayer plane, the counts set to 0 just before and read just after (one
    launch per rung of each form, no other kernel). Each output is then held
    to its plain version on the card: u8 max |diff| <= 1 LSB on < 2% of
    values, f32 bit for bit; dma_floor form A also at a second TPU tile.
    Then every rung again on an `odd` plane (width and height odd: the
    vector-load route), held the same way, with the route launches checked.
    Then the ladder is timed beside the develop kernel on the same plan
    (tkv.time_ladder: device ms back to back over 3 cold planes, plain
    versions from idle, noop beside one PyTorch call) and printed beside the
    previous design's times and the bounds. Returns ({entry: launches}, {entry: max
    |diff|}, {entry: timing}) for the kernels line's two entries
    (LADDER_ROWS)."""
    plan, scal, planes = tkv.ladder_inputs(size, device, tdk.INPUTS)
    rungs = tkv.rungs()
    _reset_counts()
    outs = [tkv.run_rung(r, planes[r.input][0], scal) for r in rungs]
    _sync(device)
    counts = _counts()
    routes = dict(kv.ROUTE_LAUNCHES)
    want = {k: 0 for k in counts}
    for r in rungs:
        want["develop_variants" if r.form == "A" else "develop_variants3"] += 1
    print(f"  {len(rungs)} rungs at {size[0]}x{size[1]}: launches {counts}, load routes {routes}")
    if device.type == "cuda" and counts != want:
        raise AssertionError(f"ladder: launches {counts}, want {want}")
    errors = {"develop_variants": 0.0, "develop_variants3": 0.0}
    checks = [(r, None, got) for r, got in zip(rungs, outs)]
    for inp in ("u16", "f32"):
        got = kv.run_variant(planes[inp][0], scal, height=size[1], width=size[0],
                             variant="dma_floor", form="A", tile=LADDER_TILE2)
        checks.append((tkv.Rung("dma_floor", "A", inp, "u8"), LADDER_TILE2, got))
    for r, tile, got in checks:
        args = dict(height=size[1], width=size[0], variant=r.variant, form=r.form,
                    out_dtype=r.out_dtype, tile=tile or r.tile)
        _hold_rung(r, tile, got, kv.variant_plain(planes[r.input][0], scal, **args), errors)
    del outs, checks
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # The vector-load route: rows that do not start on 16 bytes.
    _, _, odd_planes = tkv.ladder_inputs(odd, device)
    before = dict(kv.ROUTE_LAUNCHES)
    print(f"  every rung at {odd[0]}x{odd[1]}:")
    for r in rungs:
        p = odd_planes[r.input][0]
        got = tkv.run_rung(r, p, scal)
        plan_r = tkv.rung_plan(r, p)
        print(f"    {r.name}: route {plan_r['route']}, tile rows {plan_r['tile_rows']}")
        _hold_rung(r, None, got, tkv.plain_rung(r, p, scal), errors)
    staged = sum(r.variant != "noop" for r in rungs)
    vector = kv.ROUTE_LAUNCHES["vector"] - before["vector"]
    print(f"  load routes at {odd[0]}x{odd[1]}: vector {vector} of {staged} staged rungs")
    if device.type == "cuda" and (vector != staged or routes["vector"] != 0):
        raise AssertionError(f"ladder routes: {vector} vector launches at {odd}, want {staged}; "
                             f"{routes} at {size}, want no vector launch")
    del odd_planes
    if device.type == "cuda":
        torch.cuda.empty_cache()

    print(f"  the ladder timed beside the develop kernel (on {card}):")
    rows = {row["exp"]: row for row in tkv.time_ladder(
        plan, scal, planes, device, card, emit=lambda line: print(f"    {line}"))}
    print(f"  rung: device ms (previous design's), bound, library call, route, tile rows "
          f"(on {card})")
    for r in rungs:
        row = rows[r.name]
        lib = "" if row["library_ms"] is None else f", library {row['library_ms']:.4f}"
        print(f"    {r.name}: {row['ms']:.4f} ({tkv.PREVIOUS_MS[r.name]:.4f}), bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']}{lib}, route {row['route']}, tile rows "
              f"{row['tile_rows']}")
    for line in tkv.gap_lines(list(rows.values())):
        print(f"  gap: {line} (on {card})")
    times = {}
    for entry, exp in LADDER_ROWS.items():
        row = rows[exp]
        times[entry] = {"rung": exp, "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]}
    dev = rows["develop"]
    print(f"  develop in this phase: {dev['ms']:.4f} ms ({dev['clock']} clock); ladder top "
          f"full_A_u16_u8 {rows['full_A_u16_u8']['ms']:.4f}, floor noop_B_u16_u8 "
          f"{rows['noop_B_u16_u8']['ms']:.4f} (zero_() {rows['noop_B_u16_u8']['library_ms']:.4f})"
          f" (on {card})")
    del planes
    if device.type == "cuda":
        torch.cuda.empty_cache()
    launches = {e: counts[e] for e in LADDER_ROWS}
    return launches, errors, times


def _stage_key(pipe, nstages) -> bytes:
    """The chain hash of stage `nstages` - 1 of `pipe`'s last staged run."""
    h = BufHasher()
    h.write(image_content_hash(pipe.globals.image))
    pipe.globals.settings.hash(h)
    for op in pipe.ops.all_ops()[:nstages]:
        op.hash(h)
    return h.result()


def _first_render_vs_plain(pipe, cache, got) -> int:
    """The first render against the same edit with its rotate step replaced
    by the plain version, called on the cached demosaic stage and finished
    by the later ops' run."""
    dem = cache.get(_stage_key(pipe, 2))
    if dem is None:
        raise AssertionError("the demosaic stage is not in the cache")
    tl, tr, bl, nw, nh = pipe.ops.rotatecrop.geometry(dem.width, dem.height)
    buf = OpBuffer(nw, nh, dem.colors, dem.monochrome, krot.rotate_resample_plain(
        dem.data, dem.width, dem.height, tl, tr, bl, nw, nh, dem.colors))
    for op in pipe.ops.all_ops()[3:]:
        buf = op.run(pipe.globals, buf)
    return _check("first render vs its rotate step in the plain version", got,
                  planar_to_hwc(output8bit(buf.data)))


def _edits(device, path, fuse, first_render_check=False) -> tuple[list, dict]:
    """EDITS through a fresh RenderService with pipeline.FUSE_SUFFIX =
    `fuse`, each stage (segment) synchronized; checks each edit's launches
    (rotate as EDITS says, suffix as EDITS says when fused, else none) and
    cache entries. Returns (the host outputs, summed launches)."""
    import logging

    none = {k: 0 for k in _counts()}
    pkg_log = logging.getLogger("imagepipe_tpu_torch")
    baseline = _allocated(device)
    svc = RenderService(cache_bytes=EDIT_CACHE_BYTES, device=device)
    pipe = svc.open_file("frame", path).pipeline
    outs, total = [], dict(none)
    old_level, old_fuse = pkg_log.level, ppl.FUSE_SUFFIX
    pkg_log.setLevel(logging.DEBUG)      # each stage ends in a synchronize
    ppl.FUSE_SUFFIX = fuse
    try:
        for i, (label, patch, want_rotate, want_suffix, want_len) in enumerate(EDITS):
            _reset_counts()
            t = time.perf_counter()
            img = svc.edit("frame", patch)
            ms = (time.perf_counter() - t) * 1e3
            counts = _counts()
            total = {k: total[k] + counts[k] for k in total}
            held = _allocated(device) - baseline
            print(f"  edit '{label}'{'' if fuse else ', FUSE_SUFFIX = False'}: {img.data.shape} "
                  f"{img.data.dtype}, host wall {ms:.1f} ms; launches {counts}; cache "
                  f"{len(svc.cache)} entries, total_bytes {svc.cache.total_bytes}, device "
                  f"memory beyond the baseline {held} B")
            print(f"    stage host ms (each stage synchronized): "
                  f"{ {k: round(v, 3) for k, v in pipe.stage_ms.items()} }")
            want = dict(none, rotate=want_rotate, suffix=want_suffix if fuse else 0)
            if device.type == "cuda" and counts != want:
                raise AssertionError(f"{label}: launches {counts}, want {want}")
            if len(svc.cache) != want_len:
                raise AssertionError(f"{label}: {len(svc.cache)} cache entries, want {want_len}")
            if first_render_check and i == 0:
                _first_render_vs_plain(pipe, svc.cache, img.data)
            outs.append(img.data)
    finally:
        pkg_log.setLevel(old_level)
        ppl.FUSE_SUFFIX = old_fuse
    del svc, pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return outs, total


def phase2c(device, bayer, card) -> tuple[int, int]:
    """The staged edit path through RenderService, fused, then again with
    FUSE_SUFFIX = False, which must give the same pixels bit for bit;
    returns the rotate and suffix kernels' launches on the fused run."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "edit.dng")
        dng.write_dng(path, traw.synthetic_bayer(*bayer, seed=6))
        fused, launches = _edits(device, path, True, first_render_check=True)
        staged, _ = _edits(device, path, False)
        for (label, *_), f, s in zip(EDITS, fused, staged):
            if f.shape != s.shape or f.dtype != s.dtype or not np.array_equal(f, s):
                raise AssertionError(f"edit '{label}': fused and per-stage outputs differ")
        print(f"  FUSE_SUFFIX = False: every edit's output bit-equal to the fused run's")
        del staged
        svc = RenderService(cache_bytes=EDIT_CACHE_BYTES, device=device)
        svc.open_file("frame", path)
        for _, patch, *_ in EDITS:
            svc.edit("frame", patch)

        # One more edit under the profiler, stages not synchronized.
        _profiled_edit(svc, [(f"edit 'rotation {r}'", {"rotatecrop": {"rotation": r}})
                             for r in (0.07, 0.08, 0.09)], card)
        del svc
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # The unedited frame staged against the fused develop kernel.
        p = ipt.Pipeline.new_from_file(path, device)
        staged = p.output_8bit(MultiCache(EDIT_CACHE_BYTES)).data
        before = kdev.LAUNCHES
        fused = p.output_8bit(None).data
        _sync(device)
        if device.type == "cuda" and kdev.LAUNCHES != before + 1:
            raise AssertionError("the fused render did not launch the develop kernel once")
        _check("unedited frame, staged vs fused develop kernel", staged, fused)
    return launches["rotate"], launches["suffix"]


def phase3c(device, bayer, card) -> dict:
    """The rotate and suffix kernels timed at the 24 MP shapes (the timing
    script's method) with their plain versions one call from idle, the
    eager stages the suffix kernel replaces (device ms back to back), and
    the edit requests of phase 2c to host pixels, per-stage and fused in
    turns."""
    width, height = bayer
    kt = tdk.rotate_times(device)
    src = _rotate_source(device, (4, height, width), 7)
    times = {}
    for (label, t), (_, rotation, crop) in zip(kt.items(), ROTATE_CASES):
        tl, tr, bl, nw, nh = tdk.rotatecrop_geometry(rotation, crop, width, height)
        pms = _plain_ms(lambda: krot.rotate_resample_plain(src, width, height, tl, tr, bl, nw, nh, 4),
                        device)
        _show(label, t, card)
        print(f"    plain {pms:.4f} ms one call from idle")
        if not times:
            times.update(_timing("rotate", t["ms"], pms, (t["bound_ms"], t["bound_by"])))
    del src
    torch.cuda.empty_cache()

    # The CFA route at phase 2f's launch and, in both forms, at the same
    # geometries on a 24 MP RGGB sensor plane (the kernels line's row is
    # phase 2f's: no main path runs these geometries).
    for label, t in tdk.rotate_cfa_times(device).items():
        _show(label, t, card)
    torch.cuda.empty_cache()

    st = tdk.suffix_times(device)
    for label, t in st.items():
        _show(label, t, card)
        print(f"    eager stages it replaces, same inputs: {t['eager_ms']:.4f} ms device "
              f"(runs {t['eager_runs']}), {t['eager_ms'] / t['ms']:.2f}x the kernel")
    # The main path's segment: the first render's, from the no-op
    # rotatecrop on the rotated 5981x4458 frame.
    width, height = SUFFIX_SHAPES[1]
    main = [label for label in st if f"{width}x{height} from to_lab" in label][0]
    seg = [(s, p) for s, p in tdk.suffix_segment(device) if s is not None]
    x = _rotate_source(device, (4, height, width), 8)
    pms = _plain_ms(lambda: ksuf.suffix_plain(x, [s for s, _ in seg], [p for _, p in seg], 8),
                    device)
    print(f"  {main}: plain version {pms:.4f} ms one call from idle")
    times.update(_timing("suffix", st[main]["ms"], pms,
                         (st[main]["bound_ms"], st[main]["bound_by"])))
    # The kernel's 'lut' form on the same segment (phase 2i's main path).
    lt = tdk.suffix_times(device, "lut", ("to_lab",), (), SUFFIX_SHAPES[1:])
    (lut_label, t), = lt.items()
    _show(lut_label, t, card)
    print(f"    eager stages it replaces in 'lut', same inputs: {t['eager_ms']:.4f} ms device "
          f"(runs {t['eager_runs']}), {t['eager_ms'] / t['ms']:.2f}x the kernel; the 'direct' "
          f"form {st[main]['ms']:.4f} ms in this call")
    lpms = _plain_ms(lambda: ksuf.suffix_plain(x, [s for s, _ in seg], [p for _, p in seg], 8,
                                               numerics="lut"), device)
    print(f"  {lut_label}: plain version {lpms:.4f} ms one call from idle")
    times.update(_timing("suffix_lut", t["ms"], lpms, (t["bound_ms"], t["bound_by"])))
    del x
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "edit.dng")
        dng.write_dng(path, traw.synthetic_bayer(*bayer, seed=6))
        source = decode_file(path)
    # Per-stage (the parent's loop, FUSE_SUFFIX = False) and fused in turns.
    walls = {(fuse, label): [] for fuse in (False, True) for label, *_ in EDITS[:3]}
    old_fuse = ppl.FUSE_SUFFIX
    try:
        for fuse in (False, True, True, False):
            ppl.FUSE_SUFFIX = fuse
            for _ in range(EDIT_RUNS):
                svc = RenderService(cache_bytes=EDIT_CACHE_BYTES, device=device)
                svc.open_source("frame", source)
                for label, patch, *_ in EDITS[:3]:
                    t = time.perf_counter()
                    svc.edit("frame", patch)
                    walls[fuse, label].append((time.perf_counter() - t) * 1e3)
                del svc
                torch.cuda.empty_cache()
    finally:
        ppl.FUSE_SUFFIX = old_fuse
    for (fuse, label), runs in walls.items():
        print(f"  edit request '{label}' to host pixels, {'fused' if fuse else 'per-stage'}: "
              f"median {statistics.median(runs):.3f} ms of {len(runs)} fresh services in two "
              f"turns, runs {[round(x, 3) for x in runs]} (the first edit of a service uploads "
              f"the plane and hashes the frame) (on {card})")
    return times


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device) -> int:
    """Device memory held by tensors, after a synchronize (0 on the CPU)."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


KERNELS = (   # name, source, the TPU kernel it replaces
    ("develop", "imagepipe_tpu_torch/csrc/develop.cu",
     "imagepipe_tpu/kernels/develop_pallas.py:143"),
    ("develop_scaled", "imagepipe_tpu_torch/csrc/develop_scaled.cu",
     "imagepipe_tpu/kernels/develop_scaled.py:391,500"),
    ("develop_batch", "imagepipe_tpu_torch/csrc/develop.cu",
     "imagepipe_tpu/kernels/develop_pallas.py:584,930"),
    ("develop_scaled_batch", "imagepipe_tpu_torch/csrc/develop_scaled.cu",
     "imagepipe_tpu/kernels/develop_scaled.py:846,861"),
    ("rotate", "imagepipe_tpu_torch/csrc/rotate.cu",
     "imagepipe_tpu/kernels/rotate_pallas.py:288"),
    ("develop_sp", "imagepipe_tpu_torch/csrc/develop.cu",
     "imagepipe_tpu/kernels/develop_pallas.py:680,701"),
    ("suffix", "imagepipe_tpu_torch/csrc/suffix.cu",
     "imagepipe_tpu/pipeline.py:329 (_dispatch_fused, an XLA jit; no Pallas)"),
    ("rotate_cfa", "imagepipe_tpu_torch/csrc/rotate.cu",
     "imagepipe_tpu/scaling.py:79 (_transform_impl, CFA mode; XLA)"),
    ("develop_variants", "imagepipe_tpu_torch/csrc/develop_variants.cu",
     "scripts/exp_kernel_variants.py:37 (make_kernel, launched :203)"),
    ("develop_variants3", "imagepipe_tpu_torch/csrc/develop_variants.cu",
     "scripts/exp_kernel_variants3.py:37 (make_kernel, launched :207)"),
    ("suffix_lut", "imagepipe_tpu_torch/csrc/suffix.cu",
     "imagepipe_tpu/pipeline.py:329 (_dispatch_fused under color.numerics_mode('lut'), an "
     "XLA jit; no Pallas)"),
    *((f"develop_cut{k}", "imagepipe_tpu_torch/csrc/develop.cu",
       f"imagepipe_tpu/kernels/develop_pallas.py:402 (_finish_tile, stage_limit={k}, via "
       f"_develop_pallas_jit :531)") for k in (1, 2, 3)),
    *((f"develop_scaled_cut{k}", "imagepipe_tpu_torch/csrc/develop_scaled.cu",
       f"imagepipe_tpu/kernels/develop_scaled.py:391,500 (_scaled_kernel, "
       f"_scaled_kernel_chunked, stage_limit={k})") for k in (1, 2, 3)),
)


def _phase(label, fn, *args):
    """Run one phase: print its label, call fn(*args), print its wall."""
    print(label)
    t = time.perf_counter()
    out = fn(*args)
    print(f"  ({label.split(':')[0]}: {time.perf_counter() - t:.1f} s wall)")
    return out


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
    start = time.perf_counter()

    t = time.perf_counter()
    lib = kdev.build()
    print(f"phase 0: built {lib.name} from {sorted(p.name for p in kdev._CSRC.glob('*.cu'))} "
          f"in {time.perf_counter() - t:.1f} s")

    max_err, max_err_scaled = _phase("phase 1: kernels vs plain versions, full size",
                                     phase1, device, BAYER, XTRANS, BIG)
    bayer_bases = [traw.synthetic_bayer(*BAYER, seed=10 + i) for i in range(4)]
    xtrans_bases = [traw.synthetic_xtrans(*XTRANS, seed=10 + i) for i in range(2)]
    errors = dict(develop=max_err, develop_scaled=max_err_scaled,
                  **_phase("phase 1b: batched kernels vs single launches and plain versions",
                           phase1b, device, bayer_bases, xtrans_bases))
    errors["rotate"] = _phase("phase 1c: the rotate kernel vs its plain version",
                              phase1c, device, BAYER)
    errors["rotate_cfa"] = _phase("phase 1c (CFA): the rotate kernel's CFA route",
                                  phase1c_cfa, device, BAYER)
    errors["develop_sp"] = _phase(
        "phase 1d: the width-sharded develop's shard launches vs the unsharded kernel and "
        "the plain version", phase1d, device, SP_CASES, bayer_bases)
    errors["suffix"] = _phase("phase 1e: the suffix kernel vs its plain version, bit for bit",
                              phase1e, device, SUFFIX_SHAPES)
    errors["suffix_lut"] = _phase(
        "phase 1e (lut): the suffix kernel's 'lut' form vs its plain version, bit for bit",
        phase1e, device, SUFFIX_SHAPES[1:], "lut")
    cut_launches, cut_errors, cut_times = _phase(
        "phase 1g: the develop kernels' stage_limit cuts", phase1g, device, BAYER, XTRANS, card)
    errors.update(cut_errors)
    ladder_launches, ladder_errors, ladder_times = _phase(
        "phase 1f: the develop kernel's ablation ladder", phase1f, device, BAYER, card)
    errors.update(ladder_errors)
    launches, scaled_launches = _phase("phase 2: main paths", phase2, device, BAYER)
    rotate_launches, suffix_launches = _phase("phase 2c: the staged edit path, RenderService",
                                              phase2c, device, BAYER, card)
    cfa_launches, cfa_times = _phase(
        "phase 2f: the CFA route's path, a staged scaled demosaic to a 1-px-wide stage",
        phase2f, device, card)
    with tempfile.TemporaryDirectory() as td:
        paths, corrupt = _batch_files(td, bayer_bases, xtrans_bases)
        batch_counts, flat, thumbs = _phase("phase 2b: the batch path, BatchEngine.develop_files",
                                            phase2b, device, paths, corrupt)
        sp_launches = _phase(
            "phase 2d: the width-sharded batch path, BatchEngine(spatial=2).develop_files",
            phase2d, device, paths, corrupt, flat)
        _phase("phase 2d (eager): the width-sharded eager route, BatchEngine(spatial=2) vs "
               "spatial=1", phase2d_eager, device, paths, corrupt, flat, thumbs, td, BAYER, card)
        _phase("phase 2g: the banded eager develop, develop_fused(bands=None) vs bands=1",
               phase_bands, device, BIG, card)
        _phase("phase 2h: a staged output with no pixels", phase_empty, device, td)
        lut_launches = _phase(
            "phase 2i: the staged edit path in 'lut' numerics, and develop_batch_fn",
            phase_lut, device, BAYER, bayer_bases, card)
        _phase(f"phase 2e: the multi-process feed, {FLEET_RANKS} ranks of MultiHostBatchEngine "
               f"on one card", phase2e, device, paths, corrupt, flat, thumbs)
        del flat, thumbs
        counts = dict(develop=launches, develop_scaled=scaled_launches, rotate=rotate_launches,
                      develop_sp=sp_launches, suffix=suffix_launches, rotate_cfa=cfa_launches,
                      suffix_lut=lut_launches, **cut_launches, **ladder_launches,
                      **batch_counts)
        times = _phase("phase 3: timing", phase3, device, BAYER, card)
        times.update(_phase("phase 3c: timing the rotate and suffix kernels and the edits",
                            phase3c, device, BAYER, card),
                     **cfa_times, **ladder_times, **cut_times)
        bayer_paths = [p for p in paths[:17] if p != paths[corrupt]]
        batch_times, single_mps = _phase("phase 3b: timing the batch path", phase3b, device,
                                         bayer_paths, bayer_bases, card)
        times.update(batch_times)
        _phase("phase 3e: timing the multi-process feed", phase3e, device, bayer_paths,
               single_mps, card)
        times.update(_phase("phase 3d: timing the width-sharded develop", phase3d, device,
                            card))
    print(f"all phases: {time.perf_counter() - start:.1f} s wall")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": counts[name], "max_abs_err": errors[name], "library_ms": None,
         **times[name]}
        for name, source, replaces in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
