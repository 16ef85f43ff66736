#!/usr/bin/env python3
"""Time the develop kernel's ablation ladder on the card, beside the develop kernel.

The counterpart of the TPU experiments scripts/exp_kernel_variants.py and
scripts/exp_kernel_variants3.py for the PyTorch port. Run from the
repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_kernel_variants.py [--size 6000x4000] [--json PATH]
        [--tile-rows 16,32,64]

It builds the 24 MP (6000 x 4000) `synthetic_bayer` plan through the port's
`Pipeline` and `make_develop_plan`, as the experiments' `main()` does, and
runs every rung of `kernels.variants.run_variant` (csrc/develop_variants.cu):
each variant, each form (A: exp_kernel_variants.py, B:
exp_kernel_variants3.py), a u16 and a float32 plane, u8 and (form B)
float32 outputs; dma_floor form A on the experiments' 96 x 384 TPU tile. It
ends with `kernels.develop.develop` on the same plan and planes, cut after
the demosaic (`stage_limit=1`) and whole (the counterpart of the
experiments' `real_path_cf`), and prints each rung beside the develop
kernel's matching cut (`GAPS`): the gap a redesign of csrc/develop.cu could
close.

Each rung prints one JSON line: `exp` (variant_form_input_output), `ms` and
`min_ms` (median and least device ms per launch over
time_develop_kernels.py's runs: launches back to back behind a device
sleep, rotating over three distinct 24 MP planes so each is read cold),
`mp_s` (source megapixels per second at the median), `plain_ms` (the plain
PyTorch version, one call from idle), `library_ms` (noop only, one PyTorch
call that computes the same function, timed the same way: form B
`Tensor.zero_()` on the [3, H, W] output, form A `out.copy_()` of the
three values expanded), `bound_ms` and `bound_by` (the larger of the rung's
bytes over 3.35 TB/s and its least float32 operations over 67 TFLOP/s:
time_develop_kernels.py's `roofline` and `OPS_*`, `rung_bound` below),
`route` and `tile_rows` (the launch plan, `kernels.variants.variant_plan`)
and `card` (`nvidia-smi` name and power limit). Before the rows it prints
each variant kernel instantiation's registers (`nvcc -Xptxas -v`) and
static SASS instruction counts (time_develop_kernels.py's `sass_counts`:
the LDG and STS of the staging show that every rung from dma_floor on
loads its tile). `--tile-rows` times every rung that stages a tile again
at each of those tile heights (the "sweep" rows: device ms only). The last
line is one JSON object of every row, the sweep and those counts (also
written to `--json PATH`).

`--device cpu` runs the same rungs through the plain versions, at `--size`
(a small one: the plain versions are slow), timed with the host clock
("clock": "host"); such a run measures nothing of the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

try:
    import imagepipe_tpu_torch  # noqa: F401
except ImportError:        # run from a checkout without PYTHONPATH: its own package
    sys.path.append(str(Path(__file__).resolve().parent.parent))
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.kernels import library
from imagepipe_tpu_torch.kernels import variants as kv

sys.path.insert(1, str(Path(__file__).resolve().parent))
import time_develop_kernels as tdk  # noqa: E402

SIZE = (6000, 4000)
TPU_TILE = (96, 384)        # the experiments' tile, for dma_floor form A
# The develop kernel's launch each u16 -> u8 rung is printed beside: its
# stage_limit cut that does the same prefix of the work (the demosaic:
# cut 1), or the whole kernel (full: the ladder's back end has no tone
# curve and truncates).
GAPS = {"demosaic": "develop_cut1", "full": "develop"}
# Each rung's device ms with the kernel's previous design (csrc/develop.cu's
# 128 x 8 block geometry, 2-byte staging loads, 32-bit stores), from this
# script on an NVIDIA H100 80GB HBM3 at 700 W: printed beside the new times.
PREVIOUS_MS = {
    "noop_A_u16_u8": 0.0279, "noop_A_f32_u8": 0.0278, "dma_floor_A_u16_u8": 0.1316,
    "dma_floor_A_f32_u8": 0.1287, "levels_A_u16_u8": 0.0873, "levels_A_f32_u8": 0.0863,
    "demosaic_A_u16_u8": 0.1573, "demosaic_A_f32_u8": 0.1569, "color_only_A_u16_u8": 0.4066,
    "color_only_A_f32_u8": 0.4057, "full_A_u16_u8": 0.4706, "full_A_f32_u8": 0.4704,
    "noop_B_u16_u8": 0.0292, "noop_B_u16_f32": 0.0901, "noop_B_f32_u8": 0.0291,
    "noop_B_f32_f32": 0.09, "dma_floor_B_u16_u8": 0.069, "dma_floor_B_u16_f32": 0.1213,
    "dma_floor_B_f32_u8": 0.0691, "dma_floor_B_f32_f32": 0.1363, "levels_B_u16_u8": 0.0872,
    "levels_B_u16_f32": 0.1206, "levels_B_f32_u8": 0.0862, "levels_B_f32_f32": 0.1355,
    "demosaic_B_u16_u8": 0.1573, "demosaic_B_f32_u8": 0.1569, "color_only_B_u16_u8": 0.4066,
    "color_only_B_u16_f32": 0.5076, "color_only_B_f32_u8": 0.4057,
    "color_only_B_f32_f32": 0.5051, "full_B_u16_u8": 0.4707, "full_B_u16_f32": 0.5507,
    "full_B_f32_u8": 0.4704, "full_B_f32_f32": 0.5437,
}
# Least float32 operations of one quantized value: the scale, two clamps
# and, for u8, the conversion (time_develop_kernels.py's OPS_FINISH counts
# 12 for three u8 values).
OPS_QUANT = {torch.uint8: 4, torch.float32: 3}
_OUT_DTYPES = {"u8": torch.uint8, "f32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Rung:
    variant: str
    form: str
    input: str              # "u16" or "f32"
    output: str             # "u8" or "f32"

    @property
    def name(self) -> str:
        return f"{self.variant}_{self.form}_{self.input}_{self.output}"

    @property
    def out_dtype(self):
        return _OUT_DTYPES[self.output]

    @property
    def tile(self):
        return TPU_TILE if (self.variant, self.form) == ("dma_floor", "A") else None


def rungs() -> list[Rung]:
    """Every rung the two experiments' kernels define: form A writes u8,
    form B u8 and float32 but for demosaic; each on u16 and float32 planes."""
    out = []
    for form in kv.FORMS:
        for variant in kv.VARIANTS:
            for inp in ("u16", "f32"):
                outs = ("u8",) if form == "A" or variant == "demosaic" else ("u8", "f32")
                out += [Rung(variant, form, inp, o) for o in outs]
    return out


def ladder_inputs(size, device, count: int = 1):
    """(plan, scal, {"u16": [planes], "f32": [planes]}): the 8-bit develop
    plan of a synthetic Bayer RAW of `size` (width, height) made through the
    port's Pipeline, its calibration as the experiments pack it, and
    `count` distinct sensor planes (seeds 20, 21, ...) on `device`, each as
    u16 and as float32."""
    raws = [traw.synthetic_bayer(*size, seed=20 + i) for i in range(count)]
    plan = tdk.plan_for(raws[0], 8, device)
    scal = library.upload(kv.variant_scal(plan), device)
    u16 = [torch.from_numpy(np.ascontiguousarray(r.data)).to(device) for r in raws]
    return plan, scal, {"u16": u16, "f32": [p.float() for p in u16]}


def _args(rung: Rung, plane):
    return dict(height=plane.shape[0], width=plane.shape[1], variant=rung.variant,
                form=rung.form, out_dtype=rung.out_dtype, tile=rung.tile)


def run_rung(rung: Rung, plane, scal, **launch):
    """The rung through its wrapper: one kernel launch on CUDA (counted);
    `launch` (tile_rows) overrides the plan's."""
    return kv.run_variant(plane, scal, **_args(rung, plane), **launch)


def rung_plan(rung: Rung, plane) -> dict:
    """The launch plan of the rung on `plane` ({} for a package without one)."""
    if not hasattr(kv, "variant_plan"):
        return {}
    return kv.variant_plan(plane.shape[0], plane.shape[1], rung.variant, rung.form,
                           plane.dtype, rung.out_dtype, plane.data_ptr())


def plain_rung(rung: Rung, plane, scal):
    return kv.variant_plain(plane, scal, **_args(rung, plane))


def rung_bound(rung: Rung, height: int, width: int) -> tuple[float, str]:
    """The least time of the rung's function: the plane read once (not by
    noop), the three planes written once, and its least float32 work:
    levels per sample, the Bayer demosaic and the back end
    (time_develop_kernels.py's OPS_*) per pixel, the quantize per value."""
    px = height * width
    q = OPS_QUANT[rung.out_dtype]
    per_px = {"noop": 0, "dma_floor": 0,
              "levels": tdk.OPS_LEVELS + q,
              "demosaic": tdk.OPS_LEVELS + tdk.OPS_DEMOSAIC_BAYER + 3 * q,
              "color_only": tdk.OPS_LEVELS + tdk.OPS_FINISH - 12 + 3 * q,
              "full": tdk.OPS_LEVELS + tdk.OPS_DEMOSAIC_BAYER + tdk.OPS_FINISH - 12 + 3 * q,
              }[rung.variant]
    read = 0 if rung.variant == "noop" else px * (2 if rung.input == "u16" else 4)
    return tdk.roofline(read, 3 * px * rung.out_dtype.itemsize, px * per_px)


def _host_ms(fns, repeats: int = 3) -> dict:
    """Host ms per call of `fns` in turn (the CPU has no device clock)."""
    for fn in fns:
        fn()
    runs = []
    for _ in range(repeats):
        t = time.perf_counter()
        for fn in fns:
            fn()
        runs.append((time.perf_counter() - t) * 1e3 / len(fns))
    return {"ms": statistics.median(runs), "runs": runs, "host_bound": False}


def _time(fns, device) -> dict:
    return tdk.device_ms(fns, device) if device.type == "cuda" else _host_ms(fns)


def _plain_ms(fn, device) -> float:
    return tdk.from_idle_ms(fn, device) if device.type == "cuda" else _host_ms([fn])["ms"]


def _row(exp, t, plain_ms, library_ms, bound, px, device, card, plan=None) -> dict:
    return {"exp": exp, "ms": t["ms"], "min_ms": min(t["runs"]), "runs": t["runs"],
            "host_bound": t["host_bound"], "mp_s": px / 1e6 / (t["ms"] / 1e3),
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "route": (plan or {}).get("route"),
            "tile_rows": (plan or {}).get("tile_rows"),
            "clock": "device" if device.type == "cuda" else "host", "card": card}


def library_call(rung: Rung, scal, height: int, width: int, device):
    """One PyTorch call computing a noop rung's function into a [3, height,
    width] output, or None: form B `zero_()`, form A a copy of its three
    values (1, 2, 3 x (black > 0)) expanded over the planes."""
    if rung.variant != "noop":
        return None
    out = torch.empty((3, height, width), dtype=rung.out_dtype, device=device)
    if rung.form == "B":
        return out.zero_
    c = (torch.tensor([1, 2, 3], device=device) * (scal[0, 0] > 0)).to(rung.out_dtype)
    return lambda: out.copy_(c.view(3, 1, 1).expand_as(out))


def time_ladder(plan, scal, planes, device, card, emit=print) -> list[dict]:
    """One row per rung of `rungs()`, then the develop kernel's rows (cut
    after the demosaic, and whole), each passed to `emit` as a JSON line as
    it is timed. `planes` is `ladder_inputs`' dict; the launches rotate
    over its planes."""
    height, width = planes["u16"][0].shape
    px = height * width
    rows = []
    for rung in rungs():
        ins = planes[rung.input]
        fns = [lambda p=p: run_rung(rung, p, scal) for p in ins]
        t = _time(fns, device)
        plain = _plain_ms(lambda: plain_rung(rung, ins[0], scal), device)
        call = library_call(rung, scal, height, width, device)
        library = None if call is None else _time([call], device)["ms"]
        rows.append(_row(rung.name, t, plain, library, rung_bound(rung, height, width), px,
                         device, card, rung_plan(rung, ins[0])))
        emit(json.dumps(rows[-1]))
    for name, k in (("develop_cut1", 1), ("develop", 4)):
        extra = {} if k == 4 else {"stage_limit": k}
        fns = [lambda p=p: kdev.develop(plan, p, **extra) for p in planes["u16"]]
        t = _time(fns, device)
        plain = _plain_ms(lambda: kdev.develop_plain(plan, planes["u16"][0], **extra), device)
        rows.append(_row(name, t, plain, None, tdk.develop_bound(plan, planes["u16"][0], k), px,
                         device, card))
        emit(json.dumps(rows[-1]))
    return rows


def gap_lines(rows) -> list[str]:
    """Each u16 -> u8 rung of both forms beside the develop kernel's
    matching launch (GAPS): ladder ms, develop.cu ms, their difference."""
    by = {r["exp"]: r for r in rows}
    out = []
    for rung in rungs():
        if (rung.input, rung.output) != ("u16", "u8") or rung.variant not in GAPS:
            continue
        mine, dev = by[rung.name], by[GAPS[rung.variant]]
        out.append(f"{rung.name} {mine['ms']:.4f} ms beside {GAPS[rung.variant]} "
                   f"{dev['ms']:.4f} ms: gap {dev['ms'] - mine['ms']:.4f} ms "
                   f"({dev['ms'] / mine['ms']:.2f}x)")
    return out


def sweep_tile_rows(scal, planes, device, values) -> list[dict]:
    """Device ms of every rung that stages a tile at each tile height of
    `values` ({exp, tile_rows, ms, runs})."""
    out = []
    for n in values:
        for rung in rungs():
            if rung.variant == "noop":
                continue
            fns = [lambda p=p: run_rung(rung, p, scal, tile_rows=n) for p in planes[rung.input]]
            t = _time(fns, device)
            out.append({"exp": rung.name, "tile_rows": n, "ms": t["ms"], "runs": t["runs"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default=f"{SIZE[0]}x{SIZE[1]}", help="WIDTHxHEIGHT")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu (plain versions)")
    ap.add_argument("--json", help="also write the last line to this file")
    ap.add_argument("--tile-rows", default="",
                    help="comma-separated tile heights to time every rung at too")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    card = tdk.card() if device.type == "cuda" else "cpu"
    print(card)
    size = tuple(int(v) for v in args.size.split("x"))
    sass, ptxas = {}, {}
    if device.type == "cuda":
        t = time.perf_counter()
        lib = library.build()
        print(f"built {lib.name} in {time.perf_counter() - t:.1f} s")
        pkg = Path(kdev.__file__).resolve().parent.parent
        ptxas = tdk.ptxas_report(pkg / "csrc", pkg / "build", ("develop_variants.cu",))
        for k, v in ptxas.items():
            print(f"  ptxas {k}: {'; '.join(v)}")
        sass = {k: v for k, v in tdk.sass_counts(lib).items() if "variant_kernel" in k}
        for k, v in sass.items():
            print(f"  sass {k}: {v}")
    plan, scal, planes = ladder_inputs(size, device, tdk.INPUTS if device.type == "cuda" else 1)
    rows = time_ladder(plan, scal, planes, device, card)
    for line in gap_lines(rows):
        print(f"  gap: {line} (on {card})")
    sweep = sweep_tile_rows(scal, planes, device,
                            [int(v) for v in args.tile_rows.split(",") if v])
    for r in sweep:
        print(f"  sweep {r['exp']} tile_rows {r['tile_rows']}: {r['ms']:.4f} ms (on {card})")
    line = json.dumps({"card": card, "size": list(size), "torch": torch.__version__,
                       "cuda": torch.version.cuda, "ptxas": ptxas, "sass": sass, "rows": rows,
                       "sweep": sweep})
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
