"""Multi-process input feed: each rank of a torch.distributed group develops
its own slice of one global file list.

Counterpart of `imagepipe_tpu/parallel/multihost.py`. Every rank receives
the same global list and takes the deterministic round-robin slice
`paths[rank::world]` (`partition_files`), so each host's decode I/O rides
its own disk and NIC. Each rank develops its slice through one local
`BatchEngine` on its own devices: on CUDA the batched kernels
(`develop_batch`, `develop_scaled_batch`). Each rank forks its own pool of
`decode_workers` decode processes, so R ranks on one host run R times
that many. Pixel bytes never cross ranks;
the collectives carry only host metadata, each rank's status, over a gloo
group (`all_gather_object`):

  * gloo, because two ranks that share one card cannot form an NCCL group
    (NCCL refuses a duplicate GPU), and NCCL's `all_gather_object` stages
    its pickles on the card;
  * the status gather is the one collective of `develop_files`, and every
    rank enters it, whatever happened to it before. A rank that failed with
    errors="raise" (a decode, plan or develop error) raises its own
    exception after the gather; its peers raise a RuntimeError naming the
    failing rank and path. No rank raises alone and leaves its peers
    waiting in a collective (the JAX package's rule, :196-204 and
    :250-255 there). The group's timeout bounds the wait for a lost peer.

Not ported, because each torch rank runs its own program where the JAX
package runs one jitted SPMD program across every host: the global batch
mesh (`global_batch_mesh`, :73), the assembly of global arrays from each
host's rows (`_make_global`, :95), the globally agreed step count and its
padding rows (:259-300), the union of every host's statics buckets in
hash order and its collision check (:202-256), and the int32-only gather
(`_allgather_i32`, :80-92). A rank here buckets, batches and dispatches
its own files as `BatchEngine` does, and needs no agreement on any of it.

Start one process per host (or per card; two ranks may share a card with
`devices=["cuda:0"]`), each calling `torch.distributed.init_process_group`
with its rank and the world size, over a `FileStore` (`init_method=
"file://..."`) or `env://`, then build the engine on every rank.
"""

from __future__ import annotations

import datetime

import torch.distributed as dist

from .batch import BatchEngine, BatchError

__all__ = ["MultiHostBatchEngine", "partition_files", "GROUP_TIMEOUT"]

# The timeout of the gloo group the engine makes when the default group is
# not gloo: a peer lost for longer fails the gather instead of hanging it.
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def _rank_and_world(group=None) -> tuple[int, int]:
    """(rank, world size) in `group` (None: the default group), or (0, 1)
    when no process group is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def partition_files(paths, process_index: int | None = None,
                    process_count: int | None = None) -> list:
    """This rank's deterministic slice of the global file list (round-robin:
    adjacent shots usually share camera and shape, so striding balances
    shape buckets across ranks). The index and count default to the rank
    and world size in the default group when a process group is
    initialized, else 0 and 1."""
    rank, world = _rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if not 0 <= pi < pc:
        raise ValueError(f"process index {pi} outside 0..{pc - 1}")
    return list(paths[pi::pc])


def _gloo_group(group):
    """`group` if given; else the default group when its backend is gloo,
    else a new gloo group over every rank (a collective call: every rank
    builds its engine in the same order). None when single-process."""
    if group is not None or not (dist.is_available() and dist.is_initialized()):
        return group
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)


class MultiHostBatchEngine:
    """Batched develop whose input feed spans the ranks of a process group.

    devices: this rank's own devices, as `BatchEngine` takes them (default
    every CUDA device the rank sees; ["cuda:0"] lets ranks share one card,
    ["cpu"] runs the plain versions). group: the gloo group of the status
    gather (default: the default group if it is gloo, else a new gloo group
    with GROUP_TIMEOUT). The other arguments are `BatchEngine`'s.

    develop_files(paths) returns THIS rank's partition of the global list,
    in partition order (`partition_files(paths, engine.rank, engine.world)`
    gives the matching paths). `engine.engine` is the local `BatchEngine`
    (its `timings` the rank's host split); the results are its results, so
    a long list is passed in parts (examples/torch_multihost_serve.py)."""

    def __init__(self, devices=None, out_bits: int = 8, decode_workers: int | None = None,
                 maxwidth: int = 0, maxheight: int = 0, inflight_batches: int = 2,
                 max_batch: int = 8, spatial: int = 1, group=None):
        self.group = _gloo_group(group)
        self.engine = BatchEngine(devices=devices, out_bits=out_bits, max_batch=max_batch,
                                  decode_workers=decode_workers, maxwidth=maxwidth,
                                  maxheight=maxheight, inflight_batches=inflight_batches,
                                  spatial=spatial)
        self.rank, self.world = _rank_and_world(self.group)

    def develop_files(self, paths: list[str], errors: str = "skip"):
        """Develop this rank's partition of `paths`; returns [H', W', 3]
        numpy outputs in partition order.

        errors='skip' (the default, the production policy) puts a
        BatchError in an undecodable file's slot. errors='raise': the
        rank's partition runs to its end (a peer cannot learn of a failure
        before the gather), then every rank raises if any failed: the
        failing rank its own exception, the others a RuntimeError naming
        the failing rank and path."""
        if errors not in ("raise", "skip"):
            raise ValueError(f"errors {errors!r}: 'raise' or 'skip'")
        mine = partition_files(paths, self.rank, self.world)
        results, failure, status = None, None, None
        try:
            results = self.engine.develop_files(mine, errors="skip")
            if errors == "raise":
                failed = next((r for r in results if isinstance(r, BatchError)), None)
                if failed is not None:
                    failure, status = failed.error, (self.rank, failed.path, repr(failed.error))
        except Exception as e:        # a develop error: reported through the gather
            failure, status = e, (self.rank, None, repr(e))
        statuses = [status]
        if self.world > 1:
            statuses = [None] * self.world
            dist.all_gather_object(statuses, status, group=self.group)
        if failure is not None:
            raise failure
        for peer in statuses:
            if peer is not None:
                rank, path, error = peer
                where = f"on {path}" if path is not None else "developing its partition"
                raise RuntimeError(f"rank {rank} failed {where}: {error}")
        return results
