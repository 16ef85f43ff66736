"""PyTorch port: the JAX package's public surface, name by name.

Read with `ast` from both packages' sources, nothing imported. For each
module of `imagepipe_tpu/`, every public module-level name and every
`__all__` entry exists in the port's module of the same name, and every
keyword of a public function or method the two share is a keyword of the
port's, in the same order, unless `imagepipe_tpu_torch._surface.
NOT_PORTED` lists it with its reason. Each key of that list must still
name something of the JAX package that the port lacks, so that it cannot
go stale.
"""

import ast
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "imagepipe_tpu"
PORT = ROOT / "imagepipe_tpu_torch"


def _not_ported() -> dict:
    spec = importlib.util.spec_from_file_location("_surface", PORT / "_surface.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.NOT_PORTED


NOT_PORTED = _not_ported()
KEEP_DUNDER = ("__init__", "__call__")


def _dotted(rel: Path) -> str:
    """kernels/develop_scaled.py -> 'kernels.develop_scaled'; a package's
    __init__.py -> its package ('' for the root)."""
    parts = rel.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


MODULES = sorted(_dotted(p.relative_to(JAX)) for p in JAX.rglob("*.py"))
MODULE_IDS = [m or "(package)" for m in MODULES]


def _path(root: Path, dotted: str) -> Path | None:
    if not dotted:
        return root / "__init__.py"
    base = root.joinpath(*dotted.split("."))
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.exists():
            return p
    return None


class _Module:
    """A module's top-level names: definitions, imports and __all__."""

    def __init__(self, path: Path):
        self.defs, self.imported, self.all = {}, set(), []
        self._visit(ast.parse(path.read_text()).body)

    def _visit(self, body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self.defs[n.name] = n
            elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in targets:
                    for x in ast.walk(t):
                        if isinstance(x, ast.Name):
                            self.defs.setdefault(x.id, n)
                    if isinstance(t, ast.Name) and t.id == "__all__" and n.value is not None:
                        self.all += list(ast.literal_eval(n.value))
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                self.imported |= {a.asname or a.name.split(".")[0] for a in n.names}
            elif isinstance(n, (ast.If, ast.Try, ast.With)):
                for block in ("body", "orelse", "finalbody"):
                    self._visit(getattr(n, block, []))
                for h in getattr(n, "handlers", []):
                    self._visit(h.body)

    def public(self) -> set:
        return {k for k in self.defs if not k.startswith("_")} | set(self.all)

    def has(self, name: str) -> bool:
        return name in self.defs or name in self.imported


def _module(root: Path, dotted: str) -> _Module | None:
    path = _path(root, dotted)
    return None if path is None else _Module(path)


def _methods(cls: ast.ClassDef) -> dict:
    return {n.name: n for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _params(fn) -> list:
    """The named parameters (a *args or **kwargs names no keyword)."""
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _qual(module: str, name: str) -> str:
    return f"{module}.{name}" if module else name


def _functions(mod: _Module, module: str):
    """(qualified name for NOT_PORTED keys, JAX-side path) of every public
    function, class __init__ and public method of `mod`."""
    for name in sorted(mod.public()):
        node = mod.defs.get(name)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield _qual(module, name), (name,)
        elif isinstance(node, ast.ClassDef):
            for m in sorted(_methods(node)):
                if not m.startswith("_") or m in KEEP_DUNDER:
                    key = _qual(module, name) if m == "__init__" else _qual(module, f"{name}.{m}")
                    yield key, (name, m)


def _lookup(mod: _Module, path: tuple):
    node = mod.defs.get(path[0])
    if len(path) == 1:
        return node if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) else None
    return _methods(node).get(path[1]) if isinstance(node, ast.ClassDef) else None


@pytest.mark.parametrize("module", MODULES, ids=MODULE_IDS)
def test_public_names_exist_in_port(module):
    """Every public name (and __all__ entry) of the JAX module, and every
    public method of its classes, is in the port's module of the same
    name, or NOT_PORTED gives the reason it is not."""
    if module in NOT_PORTED:
        assert _path(PORT, module) is None
        return
    jax_mod, port_mod = _module(JAX, module), _module(PORT, module)
    assert port_mod is not None, f"the port has no module {module!r}"
    missing = [n for n in sorted(jax_mod.public())
               if not port_mod.has(n) and _qual(module, n) not in NOT_PORTED]
    for name in sorted(jax_mod.public()):
        jcls, pcls = jax_mod.defs.get(name), port_mod.defs.get(name)
        if isinstance(jcls, ast.ClassDef) and isinstance(pcls, ast.ClassDef):
            missing += [f"{name}.{m}" for m in sorted(_methods(jcls))
                        if not m.startswith("_") and m not in _methods(pcls)
                        and _qual(module, f"{name}.{m}") not in NOT_PORTED]
    assert not missing, f"{module}: not in the port and not in NOT_PORTED: {missing}"


@pytest.mark.parametrize("module", MODULES, ids=MODULE_IDS)
def test_shared_functions_take_the_jax_keywords(module):
    """Each public function and method both packages have takes the JAX
    one's keywords, less those NOT_PORTED lists, in the JAX order (the port
    may add its own, such as `device`)."""
    if module in NOT_PORTED:
        return
    jax_mod, port_mod = _module(JAX, module), _module(PORT, module)
    wrong = []
    for key, path in _functions(jax_mod, module):
        jfn, pfn = _lookup(jax_mod, path), _lookup(port_mod, path)
        if jfn is None or pfn is None:
            continue
        want = [p for p in _params(jfn) if f"{key}({p}=)" not in NOT_PORTED]
        got = [p for p in _params(pfn) if p in want]
        if got != want:
            wrong.append(f"{key}: JAX {want}, port {_params(pfn)}")
    assert not wrong, f"{module}: keywords differ: {wrong}"


def _resolve(root: Path, key: str):
    """What a NOT_PORTED key names under `root`: True/False for a module,
    a name, a method or a parameter being there."""
    path, _, param = key.partition("(")
    param = param.rstrip("=)")
    parts = path.split(".")
    for i in range(len(parts), -1, -1):
        module, rest = ".".join(parts[:i]), parts[i:]
        if _path(root, module) is None:
            continue
        if not rest:
            return not param
        mod = _module(root, module)
        if not param:
            if len(rest) == 1:
                return mod.has(rest[0])
            cls = mod.defs.get(rest[0])
            return isinstance(cls, ast.ClassDef) and rest[1] in _methods(cls)
        fn = _lookup(mod, tuple(rest) if len(rest) == 2 else (rest[0],))
        if fn is None and len(rest) == 1 and isinstance(mod.defs.get(rest[0]), ast.ClassDef):
            fn = _methods(mod.defs[rest[0]]).get("__init__")
        return fn is not None and param in _params(fn)
    return False


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_names_a_jax_name_the_port_lacks(key):
    """Every NOT_PORTED key still names a module, name, method or
    parameter of the JAX package, the port still lacks it, and its reason
    is not empty."""
    assert NOT_PORTED[key].strip()
    assert _resolve(JAX, key), f"{key} is not in the JAX package"
    assert not _resolve(PORT, key), f"{key} is in the port: take it off NOT_PORTED"
