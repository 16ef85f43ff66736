"""PyTorch port: the package never imports JAX.

In a fresh interpreter, import `imagepipe_tpu_torch`, write a small DNG with
the host `dng` module it loads, develop it to 8 and 16 bits and as a
thumbnail on the CPU and through the CLI, and check that `jax` never
entered `sys.modules`.
"""

import os
import subprocess
import sys

_SCRIPT = r"""
import sys, os
import imagepipe_tpu_torch as tip
from imagepipe_tpu_torch import _host, cli
path = os.path.join(sys.argv[1], "tiny.dng")
_host.write_dng(path, _host.synthetic_bayer(64, 48, seed=7))
p = tip.Pipeline.new_from_file(path, device="cpu")
assert p.output_8bit().data.shape == (48, 64, 3)
assert p.output_16bit().data.shape == (48, 64, 3)
# A thumbnail: the scaled demosaic and the resampler.
p.globals.settings.maxwidth = 16
assert p.output_8bit().data.shape == (12, 16, 3)
assert tip.simple_decode_8bit(path, maxwidth=20, device="cpu").data.shape == (15, 20, 3)
assert cli.main(["converter", path]) == 0
# cameras' lazy `from .color import SRGB_D65_33` resolves to the port's module.
m = _host._load("cameras").xyz_to_cam_from_cam2srgb([[1, 0, 0], [0, 1, 0], [0, 0, 1]])
assert m.shape == (4, 3)
mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "imagepipe_tpu.")))
print("JAXMODS", mods)
"""


def test_port_never_imports_jax(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAXMODS []" in proc.stdout, proc.stdout
