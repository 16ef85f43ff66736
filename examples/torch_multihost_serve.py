"""Multi-process batched RAW serving over torch.distributed.

The PyTorch port's counterpart of examples/multihost_serve.py. Run the SAME
script in every process of the fleet (one per host, or per card); each
decodes its own round-robin partition of the global file list from its
local disk and develops it on its own cards. Pixel bytes never cross
processes: the group carries only each rank's status
(parallel/multihost.py).

Single-process usage degenerates to BatchEngine semantics, so this example
runs standalone too:

    python examples/torch_multihost_serve.py <dir-with-raws> [out-dir]

For a fleet, give each process the group's rendezvous, its rank and the
world size, e.g. over a file on a shared filesystem:

    INIT_METHOD=file:///shared/fleet.rdv WORLD_SIZE=4 RANK=$I \\
        python examples/torch_multihost_serve.py /data/shoot out/

(INIT_METHOD=tcp://<host0>:<port> works as well). Every process walks
the global list in the same slices of SLICE files, one `develop_files` call
each, and writes and drops a slice's results before the next. `main(argv,
device="cpu")` develops on the CPU.
"""

import os
import pathlib
import sys

import numpy as np
import torch.distributed as dist
from PIL import Image

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from imagepipe_tpu_torch.parallel import (BatchError, MultiHostBatchEngine,  # noqa: E402
                                          partition_files)


# Files of the global list per call: a rank holds at most its part of one
# slice's results.
SLICE = 256


def main(argv, device=None) -> int:
    if not argv:
        print(__doc__)
        return 1
    indir = argv[0]
    outdir = argv[1] if len(argv) > 1 else "."

    init = os.environ.get("INIT_METHOD")
    if init:
        dist.init_process_group("gloo", init_method=init,
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]))

    exts = (".dng", ".nef", ".nrw", ".cr2", ".arw", ".sr2", ".raf",
            ".orf", ".pef", ".rw2", ".mrw", ".pgm", ".synraw", ".npz",
            ".erf", ".rwl", ".srw", ".mef", ".mos", ".kdc", ".dcr",
            ".3fr", ".fff")
    paths = sorted(os.path.join(indir, n) for n in os.listdir(indir)
                   if n.lower().endswith(exts))
    if not paths:
        print(f"no RAW files under {indir!r}")
        return 1

    eng = MultiHostBatchEngine(devices=None if device is None else [device],
                               maxwidth=2048, maxheight=2048)
    os.makedirs(outdir, exist_ok=True)
    ok = mine = 0
    for start in range(0, len(paths), SLICE):
        part = paths[start:start + SLICE]
        ok += _write_slice(eng, part, outdir)
        mine += len(partition_files(part, eng.rank, eng.world))
    print(f"host developed {ok}/{mine} of its partition "
          f"({len(paths)} files globally)")
    return 0


def _write_slice(eng, paths, outdir) -> int:
    """Develop this rank's part of `paths` in one call, write each result
    as a JPEG, and return how many were written."""
    ok = 0
    results = eng.develop_files(paths, errors="skip")
    for path, res in zip(partition_files(paths, eng.rank, eng.world), results):
        base = os.path.splitext(os.path.basename(path))[0]
        if isinstance(res, BatchError):   # carrier names the failure
            print(f"SKIP {path}: {res.error}")
            continue
        Image.fromarray(np.asarray(res)).save(
            os.path.join(outdir, base + ".jpg"), quality=90)
        ok += 1
    return ok


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
