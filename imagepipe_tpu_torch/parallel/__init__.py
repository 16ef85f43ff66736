"""Batched and multi-device develop (counterpart of
`imagepipe_tpu/parallel/`): the batch engine over a grid of devices, data
parallel over its rows and width-sharded across each row
(`make_batch_mesh`, `BatchEngine(spatial=...)`), and the multi-process
input feed over torch.distributed (`MultiHostBatchEngine`,
`partition_files`). `shard_batch` places a batch of planes over the grid,
as the JAX package's does."""

from __future__ import annotations

from .batch import (BatchEngine, BatchError, default_decode_workers, make_batch_mesh,
                    shard_batch)
from .multihost import MultiHostBatchEngine, partition_files

__all__ = ["BatchEngine", "BatchError", "MultiHostBatchEngine", "default_decode_workers",
           "make_batch_mesh", "partition_files", "shard_batch"]
