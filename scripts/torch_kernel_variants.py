#!/usr/bin/env python3
"""Time the develop kernel's ablation ladder on the card, beside the develop kernel.

The counterpart of the TPU experiments scripts/exp_kernel_variants.py and
scripts/exp_kernel_variants3.py for the PyTorch port. Run from the
repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_kernel_variants.py [--size 6000x4000] [--json PATH]

It builds the 24 MP (6000 x 4000) `synthetic_bayer` plan through the port's
`Pipeline` and `make_develop_plan`, as the experiments' `main()` does, and
runs every rung of `kernels.variants.run_variant` (csrc/develop_variants.cu):
each variant, each form (A: exp_kernel_variants.py, B:
exp_kernel_variants3.py), a u16 and a float32 plane, u8 and (form B)
float32 outputs; dma_floor form A on the experiments' 96 x 384 TPU tile. It
ends with `kernels.develop.develop` on the same plan and planes (the
counterpart of the experiments' `real_path_cf`).

Each rung prints one JSON line: `exp` (variant_form_input_output), `ms` and
`min_ms` (median and least device ms per launch over
time_develop_kernels.py's runs: launches back to back behind a device
sleep, rotating over three distinct 24 MP planes so each is read cold),
`mp_s` (source megapixels per second at the median), `plain_ms` (the plain
PyTorch version, one call from idle), `library_ms` (noop form B only:
`Tensor.zero_()` on the [3, H, W] output, which computes the same function,
timed the same way), `bound_ms` and `bound_by` (the larger of the rung's
bytes over 3.35 TB/s and its least float32 operations over 67 TFLOP/s:
time_develop_kernels.py's `roofline` and `OPS_*`, `rung_bound` below), and
`card` (`nvidia-smi` name and power limit). Before the rows it prints
the static SASS instruction counts of each variant kernel instantiation
(time_develop_kernels.py's `sass_counts`: the LDG and STS of the staging
show that every rung from dma_floor on loads its tile). The last line is
one JSON object of every row and those counts (also written to `--json
PATH`).

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
from imagepipe_tpu_torch.kernels import variants as kv

sys.path.insert(1, str(Path(__file__).resolve().parent))
import time_develop_kernels as tdk  # noqa: E402

SIZE = (6000, 4000)
TPU_TILE = (96, 384)        # the experiments' tile, for dma_floor form A
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
    scal = kdev.upload(kv.variant_scal(plan), device)
    u16 = [torch.from_numpy(np.ascontiguousarray(r.data)).to(device) for r in raws]
    return plan, scal, {"u16": u16, "f32": [p.float() for p in u16]}


def _args(rung: Rung, plane):
    return dict(height=plane.shape[0], width=plane.shape[1], variant=rung.variant,
                form=rung.form, out_dtype=rung.out_dtype, tile=rung.tile)


def run_rung(rung: Rung, plane, scal):
    """The rung through its wrapper: one kernel launch on CUDA (counted)."""
    return kv.run_variant(plane, scal, **_args(rung, plane))


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


def _row(exp, t, plain_ms, library_ms, bound, px, device, card) -> dict:
    return {"exp": exp, "ms": t["ms"], "min_ms": min(t["runs"]), "runs": t["runs"],
            "host_bound": t["host_bound"], "mp_s": px / 1e6 / (t["ms"] / 1e3),
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "clock": "device" if device.type == "cuda" else "host",
            "card": card}


def time_ladder(plan, scal, planes, device, card, emit=print) -> list[dict]:
    """One row per rung of `rungs()`, then the develop kernel's row, each
    passed to `emit` as a JSON line as it is timed. `planes` is
    `ladder_inputs`' dict; the launches rotate over its planes."""
    height, width = planes["u16"][0].shape
    px = height * width
    rows = []
    for rung in rungs():
        ins = planes[rung.input]
        fns = [lambda p=p: run_rung(rung, p, scal) for p in ins]
        t = _time(fns, device)
        plain = _plain_ms(lambda: plain_rung(rung, ins[0], scal), device)
        library = None
        if (rung.variant, rung.form) == ("noop", "B"):
            out = torch.empty((3, height, width), dtype=rung.out_dtype, device=device)
            library = _time([out.zero_], device)["ms"]
        rows.append(_row(rung.name, t, plain, library, rung_bound(rung, height, width), px,
                         device, card))
        emit(json.dumps(rows[-1]))
    fns = [lambda p=p: kdev.develop(plan, p) for p in planes["u16"]]
    t = _time(fns, device)
    plain = _plain_ms(lambda: kdev.develop_plain(plan, planes["u16"][0]), device)
    rows.append(_row("develop", t, plain, None, tdk.develop_bound(plan, planes["u16"][0]), px,
                     device, card))
    emit(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default=f"{SIZE[0]}x{SIZE[1]}", help="WIDTHxHEIGHT")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu (plain versions)")
    ap.add_argument("--json", help="also write the last line to this file")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    card = tdk.card() if device.type == "cuda" else "cpu"
    print(card)
    size = tuple(int(v) for v in args.size.split("x"))
    sass = {}
    if device.type == "cuda":
        t = time.perf_counter()
        lib = kdev.build()
        print(f"built {lib.name} in {time.perf_counter() - t:.1f} s")
        sass = {k: v for k, v in tdk.sass_counts(lib).items() if "variant_kernel" in k}
        for k, v in sass.items():
            print(f"  sass {k}: {v}")
    plan, scal, planes = ladder_inputs(size, device, tdk.INPUTS if device.type == "cuda" else 1)
    rows = time_ladder(plan, scal, planes, device, card)
    line = json.dumps({"card": card, "size": list(size), "torch": torch.__version__,
                       "cuda": torch.version.cuda, "sass": sass, "rows": rows})
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
