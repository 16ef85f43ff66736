"""The kernels' CUDA library: every csrc/*.cu built by nvcc into one shared
library, and loaded with ctypes.

* `build()` compiles each source with one nvcc, all started together, and
  links the objects into `imagepipe_tpu_torch/build/kernels_<key>.so`,
  keyed by a hash of every source, header and flag (`build_key`); a build
  of the same key is reused. Importing this module builds nothing.
* `load()` is the library, built if needed and loaded once per process.
  It binds no entry point: each kernel's wrapper declares the ctypes
  signatures of the entry points it calls. Adding a kernel is a `.cu` file
  under csrc/ and its wrapper.
* `upload` brings a host table to a device: from pinned memory without
  blocking the host on CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = ["build", "build_key", "load", "upload", "MAX_SMEM"]

# The most dynamic shared memory a block can have on Hopper (227 KB).
MAX_SMEM = 232448

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the develop kernels need the CUDA toolkit")


def build_key(csrc: Path = _CSRC) -> str:
    """Hash of the nvcc flags and of every `*.cu` and `*.cuh` under `csrc`
    (names and bytes): an edit to any source or header changes it."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for f in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every csrc/*.cu into one shared library unless a build of the
    same sources, headers and flags exists; returns its path. One nvcc per
    source, all started together, then one link."""
    key = build_key()
    lib = _BUILD_DIR / f"kernels_{key}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{key}.{os.getpid()}"
    jobs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = _BUILD_DIR / f"{src.stem}_{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = _BUILD_DIR / f"kernels_{tag}.tmp.so"
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
                          capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, loaded once per process. Its
    entry points' signatures are declared by the wrappers that call them."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def upload(array, device) -> torch.Tensor:
    """A host array as a tensor on `device`. To a CUDA device it is copied
    from pinned memory without blocking the host, ordered on the device's
    current stream (torch keeps the pinned block until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
