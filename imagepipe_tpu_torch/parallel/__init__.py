"""Batched and multi-device develop (counterpart of
`imagepipe_tpu/parallel/`): the batch engine over a grid of devices, data
parallel over its rows and width-sharded across each row
(`make_batch_mesh`, `BatchEngine(spatial=...)`), and the multi-process
input feed over torch.distributed (`MultiHostBatchEngine`,
`partition_files`). Not ported: width sharding of the eager route, which
runs whole on a row's first device (parallel/batch.py)."""

from __future__ import annotations

from .batch import BatchEngine, BatchError, default_decode_workers, make_batch_mesh
from .multihost import MultiHostBatchEngine, partition_files

__all__ = ["BatchEngine", "BatchError", "MultiHostBatchEngine", "default_decode_workers",
           "make_batch_mesh", "partition_files"]
