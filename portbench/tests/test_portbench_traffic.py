"""The traffic generators and the inputs are fixed by the seed."""

import itertools

import numpy as np
import pytest

from portbench import synth
from portbench.containers import dng_uncompressed
from portbench.drivers import Reservoir
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_frames_follow_the_seed(name):
    config, traffic = tiny.cell_files(name)
    kw = dict(n_files=4, n_bases=2, orientations=["Normal", "Rotate90"], device="cpu")
    a = synth.make_frames(config, seed=2**31 + 3, **kw)
    b = synth.make_frames(config, seed=2**31 + 3, **kw)
    c = synth.make_frames(config, seed=2**31 + 4, **kw)
    assert [dng_uncompressed.encode(f) for f in a] == [dng_uncompressed.encode(f) for f in b]
    assert not np.array_equal(a[0].data, c[0].data)
    assert a[0].neutral != c[0].neutral
    # Every seed gives the same sizes, CFA and orientations.
    assert [(f.width, f.height, f.cfa, f.orientation) for f in a] == \
        [(f.width, f.height, f.cfa, f.orientation) for f in c]


def test_the_dng_reads_back_as_written(tmp_path):
    from imagepipe_tpu_torch.dng import read_dng

    config, _ = tiny.cell_files("xtrans26.ingest_thumb")
    frame = synth.make_frames(config, 1, 1, ["Rotate90"], 7, "cpu")[0]
    path = synth.write_files([frame], str(tmp_path), config)[0]
    assert path.endswith(".dng")
    raw = read_dng(path)
    assert np.array_equal(raw.data, frame.data)
    assert (raw.width, raw.height, raw.cfa.name) == (frame.width, frame.height, frame.cfa)
    assert raw.blacklevels == (512,) * 4 and raw.whitelevels == (16383,) * 4
    assert raw.orientation.value == "Rotate90"
    assert raw.wb_coeffs[:3] == tuple(1.0 / (n / synth.RATIONAL_DEN) for n in frame.neutral)


def _edit_patches(seed, n):
    d = tiny.driver("bayer24.edit_loop", seed)
    return list(itertools.islice(d._script(seed), n))


def test_edit_script_follows_the_seed():
    assert _edit_patches(11, 60) == _edit_patches(11, 60)
    assert _edit_patches(11, 60) != _edit_patches(12, 60)


@pytest.mark.parametrize("seed", [1, 2**31 + 9, 2**33 + 1])
def test_edit_script_blocks_hold_the_same_work(seed):
    """Each block of 20 holds 12 exposure steps, 5 rotations (3 positive,
    2 negative) and 3 crops, in [-2, 2], magnitude [0.005, 0.1] and
    [0, 0.1]."""
    patches = _edit_patches(seed, 40)
    for block in (patches[:20], patches[20:]):
        exposure = [p["basecurve"]["exposure"] for p in block if "basecurve" in p]
        rotation = [p["rotatecrop"]["rotation"] for p in block
                    if "rotation" in p.get("rotatecrop", {})]
        crop = [p["rotatecrop"]["crop_left"] for p in block
                if "crop_left" in p.get("rotatecrop", {})]
        assert (len(exposure), len(rotation), len(crop)) == (12, 5, 3)
        assert sum(r > 0 for r in rotation) == 3
        assert all(-2.0 <= x <= 2.0 for x in exposure)
        assert all(0.005 <= abs(r) <= 0.1 for r in rotation)
        assert all(0.0 <= c <= 0.1 for c in crop)


def test_exposure_steps_are_a_walk():
    xs = [p["basecurve"]["exposure"] for p in _edit_patches(5, 200) if "basecurve" in p]
    steps = np.abs(np.diff(xs))
    assert steps.min() >= 0.05 - 1e-12 and steps.max() <= 0.3 + 1e-12


def test_reservoir_is_a_seeded_uniform_sample():
    def sample(seed, n=1000):
        r = Reservoir(8, [seed, 1])
        for i in range(n):
            r.offer(i)
        return sorted(r.items)

    assert sample(3) == sample(3) and sample(3) != sample(4)
    counts = np.zeros(10)
    for seed in range(400):
        for i in sample(seed, 10 * 20):
            counts[i // 20] += 1
    assert counts.min() > 0.7 * counts.mean()
