"""One rank of a gloo fleet of `imagepipe_tpu_torch.parallel.MultiHostBatchEngine`
on the CPU, the target that tests/test_torch_multihost.py starts in spawned
processes. It imports only torch and the port.

`run_rank(rank, world, store, paths, out_dir)` joins a gloo group over the
FileStore file `store` (no TCP port is chosen, so concurrent fleets cannot
collide), develops `paths` with errors="skip" and then with errors="raise",
and writes what it got to `out_dir/rank{rank}.npz` (the skip run's results;
an undecodable slot as an empty array) and `out_dir/rank{rank}.json` (the
exception the raise run ended in, as its type and message).

`develop_and_keep(paths)` develops `paths` once and returns with the engine
still alive, held by a module global, so that the process ends with its
decode pool open.
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np

TIMEOUT = datetime.timedelta(seconds=60)
_kept = []


def run_rank(rank: int, world: int, store: str, paths: list, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from imagepipe_tpu_torch.parallel import BatchError, MultiHostBatchEngine

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        eng = MultiHostBatchEngine(devices=["cpu"], decode_workers=2, max_batch=4)
        outs = eng.develop_files(paths)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 *[np.zeros(0, np.uint8) if isinstance(o, BatchError) else o for o in outs])
        try:
            eng.develop_files(paths, errors="raise")
            raised = None
        except Exception as e:
            raised = {"type": type(e).__name__, "message": str(e)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": eng.rank, "world": eng.world, "raised": raised}, f)
    finally:
        dist.destroy_process_group()


def develop_and_keep(paths: list) -> None:
    from imagepipe_tpu_torch.parallel import BatchEngine

    _kept.append(BatchEngine(devices=["cpu"], decode_workers=2, max_batch=4))
    _kept[-1].develop_files(paths)
