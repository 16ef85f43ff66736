"""Batched and multi-device develop (counterpart of
`imagepipe_tpu/parallel/`): the batch engine. The width-sharded and
multi-host engines are not ported yet."""

from __future__ import annotations

from .batch import BatchEngine, BatchError, default_decode_workers

__all__ = ["BatchEngine", "BatchError", "MultiHostBatchEngine", "default_decode_workers"]


class MultiHostBatchEngine:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("MultiHostBatchEngine (sp / multihost): ROADMAP A11")
