"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names; the plain reference loads nothing of the port."""

import os
import subprocess
import sys

from portbench import harness

LOAD_ALL = r"""
import sys, glob, os
sys.path.insert(0, {root!r})
import importlib
import portbench.run, portbench.harness, portbench.control, portbench.drivers
from portbench import harness
for path in sorted(glob.glob(os.path.join(harness.HERE, "metrics", "*.py"))):
    harness.metric_reader(os.path.basename(path)[:-3])
for sub in ("kinds", "containers"):
    for path in sorted(glob.glob(os.path.join(harness.HERE, sub, "*.py"))):
        importlib.import_module(f"portbench.{{sub}}.{{os.path.basename(path)[:-3]}}")
harness.launch_counts()
import imagepipe_tpu_torch.parallel, imagepipe_tpu_torch.service, imagepipe_tpu_torch.decode
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = r"""
import sys
sys.path.insert(0, {root!r})
import portbench.reference.develop, portbench.reference.staged, portbench.reference.color
import portbench.bounds, portbench.synth, portbench.summary
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=harness.ROOT)], env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    names = _top_level_names(LOAD_ALL)
    assert "imagepipe_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "imagepipe_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_names(REFERENCE_ONLY)
    assert not names & {"jax", "jaxlib", "flax", "imagepipe_tpu", "imagepipe_tpu_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "imagepipe_tpu_torch_like", sys)
    assert "imagepipe_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
