"""The op contract.

Counterpart of `imagepipe_tpu/ops/base.py` (the ImageOp trait,
pipeline.rs:82-108). Each op is a small host-side parameter object whose
hash covers its name plus a canonical binary serialization of every field;
the bytes are those of the JAX package, so content hashes and YAML serials
agree across the two packages. `run(globals, buf)` is the op's stage of the
staged pipeline: an OpBuffer in, an OpBuffer out, on the buffer's device.
`device_chain(globals, meta)` says whether and how the op joins a fused
segment of the dirty suffix (pipeline._dispatch_fused, kernels/suffix.py).
"""

from __future__ import annotations

from ..hasher import BufHasher

__all__ = ["ImageOp"]


class ImageOp:
    NAME = "op"

    def name(self) -> str:
        return self.NAME

    def run(self, globals_, buf):
        raise NotImplementedError

    def serialize_binary(self) -> bytes:
        raise NotImplementedError

    # YAML settings dict, in declared field order (serde_yaml schema parity).
    def to_settings_dict(self) -> dict:
        raise NotImplementedError

    def load_settings_dict(self, d: dict) -> None:
        raise NotImplementedError

    def to_settings(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_settings_dict(), sort_keys=False)

    def hash(self, hasher: BufHasher) -> None:
        # Name first: a field-less op would otherwise hash nothing
        # (pipeline.rs:88-92).
        hasher.write(self.name().encode())
        hasher.from_serialize(self)

    def shash(self) -> bytes:
        h = BufHasher()
        h.from_serialize(self)
        return h.result()

    def device_chain(self, globals_, meta):
        """How the op joins a fused segment of the dirty suffix.

        `meta` is the descriptor `(width, height, colors, monochrome)` of
        the buffer the op would receive. None: the op does not join (the
        pipeline runs its `run`). Else `(key, stage, params, out_meta)`:

        - `key`: every static that changes what the segment computes
          (orientation flips, knot count, linear or not, monochrome): two
          calls with equal settings (`shash`) and equal keys give equal
          params, so a memo keyed on (shash, key) would be exact;
        - `stage`: the name of the op's stage in kernels/suffix.py
          (`suffix.STAGES`), or None for an identity (a no-op crop,
          linear-mode gamma, ...), whose cache entry is its input;
        - `params`: the stage's host values (kernels/suffix.py);
        - `out_meta`: the descriptor of the op's output.

        The fused segment is bit-equal to the ops' `run` in turn."""
        return None

    def transform_forward(self, width: int, height: int) -> tuple[int, int]:
        return (width, height)

    def transform_reverse(self, width: int, height: int) -> tuple[int, int]:
        return (width, height)

    def reset(self) -> None:
        pass
