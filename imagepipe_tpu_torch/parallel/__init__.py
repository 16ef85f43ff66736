"""Batched and multi-device develop (counterpart of
`imagepipe_tpu/parallel/`): the batch engine over a grid of devices, data
parallel over its rows and width-sharded across each row
(`make_batch_mesh`, `BatchEngine(spatial=...)`). The multi-host engine is
not ported yet."""

from __future__ import annotations

from .batch import BatchEngine, BatchError, default_decode_workers, make_batch_mesh

__all__ = ["BatchEngine", "BatchError", "MultiHostBatchEngine", "default_decode_workers",
           "make_batch_mesh"]


class MultiHostBatchEngine:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("MultiHostBatchEngine (multihost): ROADMAP A11")
