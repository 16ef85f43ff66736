"""The op contract.

Counterpart of `imagepipe_tpu/ops/base.py` (the ImageOp trait,
pipeline.rs:82-108). Each op is a small host-side parameter object whose
hash covers its name plus a canonical binary serialization of every field;
the bytes are those of the JAX package, so content hashes and YAML serials
agree across the two packages. `run(globals, buf)` is the op's stage of the
staged pipeline: an OpBuffer in, an OpBuffer out, on the buffer's device.
The JAX package's `device_chain` (a fused dirty suffix, to save TPU
dispatch round trips) is not ported: the port runs the suffix stage by
stage.
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

    def transform_forward(self, width: int, height: int) -> tuple[int, int]:
        return (width, height)

    def transform_reverse(self, width: int, height: int) -> tuple[int, int]:
        return (width, height)

    def reset(self) -> None:
        pass
