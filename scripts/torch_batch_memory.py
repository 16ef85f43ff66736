"""Host memory of `BatchEngine.develop_files` over a long file list.

Usage: python3 scripts/torch_batch_memory.py [--files 400] [--distinct 16]
       [--slice 0] [--device cuda] [--dir dngs] [--label name] [--json out.json]

Writes `--distinct` synthetic 24 MP RGGB DNGs (Normal and Rotate90 in turn)
into `--dir` (kept, and reused by a later run; default a temporary
directory) and develops a list of `--files` paths that
repeats them: in one call that keeps every result (`--slice 0`), or in
calls of `--slice` files whose results are dropped before the next call,
as `examples/torch_batch_serve.py` does. After a warm pass over the
distinct files it prints, as one JSON line: the wall and MP/s of the list,
how many results are views of pinned blocks, the pinned pool's bytes
(`torch.cuda.host_memory_stats`, current and peak) and the process's
VmRSS (and VmHWM, VmLck, VmPin where given) from /proc/self/status and
the peak resident size from `getrusage`, each read while the
results are held and after they are dropped. Run each mode in a process
of its own: the pinned pool keeps its high-water mark for the process's
life. The package is the one on `PYTHONPATH`, so an older version runs
with `PYTHONPATH=<its checkout>`.
"""

import argparse
import gc
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

from imagepipe_tpu_torch import engine as tengine
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.dng import write_dng
from imagepipe_tpu_torch.parallel import BatchEngine
from imagepipe_tpu_torch.parallel import batch


def _status() -> dict:
    """VmRSS, VmHWM, VmLck and VmPin of this process where the system
    gives them, and the peak resident size from `getrusage`, in bytes."""
    out = {"maxrss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in ("VmRSS", "VmHWM", "VmLck", "VmPin"):
                out[key] = int(value.split()[0]) * 1024
    return out


def _pinned_pool() -> dict:
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.host_memory_stats()
    return {k: stats[k] for k in ("allocated_bytes.current", "allocated_bytes.peak",
                                  "num_host_alloc") if k in stats}


def _is_pinned_view(result) -> bool:
    base = result.base
    return (isinstance(base, np.ndarray) and isinstance(base.base, torch.Tensor)
            and base.base.is_pinned())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=400)
    ap.add_argument("--distinct", type=int, default=16)
    ap.add_argument("--slice", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="6000x4000")
    ap.add_argument("--dir", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    width, height = map(int, args.size.split("x"))

    with tempfile.TemporaryDirectory() as tmp:
        where = args.dir or tmp
        os.makedirs(where, exist_ok=True)
        distinct = []
        for s in range(args.distinct):
            distinct.append(os.path.join(where, f"f{s}_{args.size}.dng"))
            if not os.path.exists(distinct[-1]):
                raw = traw.synthetic_bayer(width, height, seed=1000 + s)
                raw.orientation = traw.Orientation("Normal" if s % 2 == 0 else "Rotate90")
                write_dng(distinct[-1], raw)
        paths = [distinct[i % len(distinct)] for i in range(args.files)]
        engine = BatchEngine(devices=[args.device], max_batch=8, decode_workers=8)
        engine.develop_files(distinct)
        gc.collect()
        before = dict(pool=_pinned_pool(), proc=_status())

        step = args.slice or len(paths)
        views = 0
        t0 = time.perf_counter()
        for start in range(0, len(paths), step):
            held = []       # the slice before is dropped before the call
            held.append(engine.develop_files(paths[start:start + step]))
            views += sum(map(_is_pinned_view, held[-1]))
        wall = time.perf_counter() - t0
        holding = dict(pool=_pinned_pool(), proc=_status())
        del held
        gc.collect()
        dropped = dict(pool=_pinned_pool(), proc=_status())

    line = dict(label=args.label, files=args.files, slice=args.slice, size=args.size,
                wall_s=wall, mp_s=args.files * width * height / 1e6 / wall,
                pinned_views=views,
                # engine's since every host output shares it; batch's before.
                pinned_results_bytes=getattr(tengine, "PINNED_RESULTS_BYTES",
                                             getattr(batch, "PINNED_RESULTS_BYTES", None)),
                before=before, holding=holding, dropped=dropped,
                torch=torch.__version__)
    print(json.dumps(line), flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
