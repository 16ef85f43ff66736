"""PyTorch port: the examples (`examples/torch_*.py`).

Each example's `main(argv, device="cpu")` runs on a synthetic input and
writes what its JAX counterpart writes: batch_serve a JPEG per decodable
file (a corrupt one is skipped), editor_loop its timings, superccd_develop
`--demo` a square-pixel JPEG, multihost_serve a JPEG per file of its
partition (a single process here). Each imports the port and nothing of
the JAX package, in a fresh interpreter.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from imagepipe_tpu_torch import dng, raw

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("torch_batch_serve", "torch_editor_loop", "torch_superccd_develop",
         "torch_multihost_serve")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def shoot(tmp_path):
    """Two small DNGs (Bayer, X-Trans) and a corrupt file in one directory."""
    d = tmp_path / "shoot"
    d.mkdir()
    dng.write_dng(str(d / "a.dng"), raw.synthetic_bayer(120, 80, seed=1))
    dng.write_dng(str(d / "b.dng"), raw.synthetic_xtrans(96, 72, seed=2))
    (d / "c.dng").write_bytes(b"II*\x00 not a raw file")
    return d


def test_batch_serve(shoot, tmp_path, capsys):
    out = tmp_path / "out"
    assert _load("torch_batch_serve").main([str(shoot), "--out", str(out)], device="cpu") == 0
    assert sorted(p.name for p in out.iterdir()) == ["a.jpg", "b.jpg"]
    assert Image.open(out / "a.jpg").size == (120, 80)
    assert "c.dng: SKIPPED" in capsys.readouterr().err


def test_editor_loop(shoot, capsys):
    assert _load("torch_editor_loop").main([str(shoot / "a.dng")], device="cpu") == 0
    printed = capsys.readouterr().out
    assert "first render" in printed and "(120x80)" in printed
    assert printed.count("edit ") == 4 and "full export" in printed


def test_superccd_demo(tmp_path, capsys):
    out = tmp_path / "demo.jpg"
    assert _load("torch_superccd_develop").main(["--demo", str(out)], device="cpu") == 0
    assert "lattice 192x128 -> square-pixel 136x181" in capsys.readouterr().out
    img = np.asarray(Image.open(out))
    assert img.shape == (181, 136, 3) and img.std() > 0


def test_multihost_serve_single_process(shoot, tmp_path, capsys):
    out = tmp_path / "out"
    assert _load("torch_multihost_serve").main([str(shoot), str(out)], device="cpu") == 0
    assert sorted(p.name for p in out.iterdir()) == ["a.jpg", "b.jpg"]
    printed = capsys.readouterr().out
    assert "SKIP" in printed and "host developed 2/3 of its partition" in printed


@pytest.mark.parametrize("name", ["torch_batch_serve", "torch_multihost_serve"])
def test_serve_examples_develop_in_slices(shoot, tmp_path, capsys, monkeypatch, name):
    """With slices of one file each the serving examples make one
    `develop_files` call a file and write what a single call writes."""
    from imagepipe_tpu_torch.parallel import BatchEngine

    module = _load(name)
    monkeypatch.setattr(module, "SLICE", 1)
    calls = []
    develop_files = BatchEngine.develop_files

    def counted(self, paths, errors="raise"):
        calls.append(len(paths))
        return develop_files(self, paths, errors)

    monkeypatch.setattr(BatchEngine, "develop_files", counted)
    out = tmp_path / "out"
    argv = [str(shoot), str(out)]
    if name == "torch_batch_serve":
        argv.insert(1, "--out")
    assert module.main(argv, device="cpu") == 0
    assert calls == [1, 1, 1]
    assert sorted(p.name for p in out.iterdir()) == ["a.jpg", "b.jpg"]
    printed = capsys.readouterr()
    if name == "torch_batch_serve":
        assert "c.dng: SKIPPED" in printed.err
    else:
        assert "host developed 2/3 of its partition" in printed.out


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port(name):
    """Importing the example loads imagepipe_tpu_torch and no module of the
    JAX package, nor jax itself."""
    code = "\n".join([
        "import importlib.util, sys",
        f"spec = importlib.util.spec_from_file_location('ex', {str(EXAMPLES / name)!r} + '.py')",
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)",
        "assert callable(m.main)",
        "bad = [k for k in sys.modules if k in ('jax', 'imagepipe_tpu')",
        "       or k.startswith(('jax.', 'imagepipe_tpu.'))]",
        "assert not bad, bad",
        "assert 'imagepipe_tpu_torch' in sys.modules"])
    env = dict(os.environ, PYTHONPATH=str(EXAMPLES.parent))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env)
    assert done.returncode == 0, done.stderr
