"""PyTorch port: the kernels' CUDA library and the wrappers' bindings, on the CPU.

`kernels/library.py` builds every `csrc/*.cu` into one library and loads
it; each kernel's wrapper declares the ctypes signatures of the entry
points it calls, in its own `_lib()`. Here, with a stand-in for the loaded
library (nothing is built):

* every `extern "C"` entry point of `csrc/` is declared by exactly one
  wrapper, the one for its source, with a restype of int and one argtype
  per C parameter of the same kind (pointer, int, long long, float), so a
  signature written in Python cannot drift from the source;
* every source under `csrc/` has its wrapper;
* only `kernels/library.py` runs nvcc.
"""

import ast
import ctypes
import importlib
import re
from pathlib import Path

import pytest

from imagepipe_tpu_torch.kernels import library

PORT = Path(__file__).resolve().parents[1] / "imagepipe_tpu_torch"
CSRC = PORT / "csrc"

# Each wrapper and the sources whose entry points it calls.
WRAPPERS = {
    "develop": ("develop.cu", "division_check.cu"),
    "develop_scaled": ("develop_scaled.cu",),
    "rotate": ("rotate.cu",),
    "suffix": ("suffix.cu",),
    "variants": ("develop_variants.cu",),
}

_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_longlong: "long long",
          ctypes.c_float: "float"}


def _c_kind(param: str) -> str:
    """The kind of one C parameter declaration, as ctypes passes it."""
    if "*" in param:
        return "pointer"
    ctype = param.rsplit(None, 1)[0]
    kinds = {"int": "int", "long long": "long long", "float": "float", "cudaStream_t": "pointer"}
    if ctype not in kinds:
        raise ValueError(f"unknown C parameter {param!r}")
    return kinds[ctype]


def _entry_points() -> dict:
    """{name: (source, [kind of each parameter])} of every `extern "C"`
    function of csrc/."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(', text):
            params = text[m.end():text.index(")", m.end())]
            params = " ".join(params.split())
            out[m.group(1)] = (src.name, [_c_kind(p.strip()) for p in params.split(",")
                                          if p.strip()])
    return out


ENTRY_POINTS = _entry_points()


class _FakeLib:
    """Stands in for the loaded library: an attribute per entry point."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, type("Entry", (), {})())


@pytest.fixture
def declared(monkeypatch):
    """{wrapper: {entry point: (restype, argtypes)}} as each wrapper's
    `_lib()` declares them on a stand-in library."""
    out = {}
    for name in WRAPPERS:
        module = importlib.import_module(f"imagepipe_tpu_torch.kernels.{name}")
        fake = _FakeLib()
        monkeypatch.setattr(library, "load", lambda fake=fake: fake)
        module._lib.cache_clear()
        try:
            assert module._lib() is fake
        finally:
            module._lib.cache_clear()
        out[name] = {e: (getattr(f, "restype", None), getattr(f, "argtypes", None))
                     for e, f in fake.entries.items()}
    return out


def test_entry_points_found():
    assert len(ENTRY_POINTS) == 9, sorted(ENTRY_POINTS)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_declared_by_its_wrapper_only(declared, entry):
    source, kinds = ENTRY_POINTS[entry]
    owners = [w for w, entries in declared.items() if entry in entries]
    assert owners == [w for w, sources in WRAPPERS.items() if source in sources], owners
    restype, argtypes = declared[owners[0]][entry]
    assert restype is ctypes.c_int
    assert argtypes is not None and [_KINDS[t] for t in argtypes] == kinds


def test_every_source_has_its_wrapper(declared):
    sources = {s.name for s in CSRC.glob("*.cu")}
    assert sources == {s for ss in WRAPPERS.values() for s in ss}
    for name, entries in declared.items():
        assert set(entries) == {e for e, (s, _) in ENTRY_POINTS.items()
                                if s in WRAPPERS[name]}, name


def test_only_the_library_runs_nvcc():
    """No module of the port but kernels/library.py names nvcc in its
    code (docstrings and comments aside) or builds the library."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            named = (isinstance(node, ast.Constant) and isinstance(node.value, str)
                     and "nvcc" in node.value and id(node) not in docs)
            named |= isinstance(node, ast.Name) and node.id == "_nvcc"
            named |= isinstance(node, ast.FunctionDef) and node.name in ("_nvcc", "build")
            if named:
                found.append(path.relative_to(PORT).as_posix())
    assert set(found) == {"kernels/library.py"}, sorted(set(found))
