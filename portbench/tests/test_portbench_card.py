"""On the card: a short run of each cell through the command's own entry,
`correct` true and the result line's keys."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_runs_on_the_card(card, name):
    out = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                          name, "--seed", str(2**31 + 101), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
