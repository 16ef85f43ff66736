"""PyTorch port: the multi-process input feed (parallel/multihost.py) on the CPU.

* Single process, the counterparts of tests/test_multihost.py: the
  round-robin partition for 1-4 processes; `MultiHostBatchEngine(devices=
  ["cpu"])` bit-equal to the port's `BatchEngine(devices=["cpu"])` over the
  whole list (a single process's partition is the list), with mixed sensor
  sizes interleaved, and the error policies.
* The port against the JAX package's `MultiHostBatchEngine` in its
  single-process form on the same synraw files: max |diff| <= 1 LSB and
  under 2% of values differing, tests/test_torch_batch.py's contract.
* A real two-process fleet: two spawned processes (tests/torch_fleet.py)
  form a gloo group over a FileStore under tmp_path, so no TCP port is
  chosen and concurrent test workers cannot collide. Each rank's results
  must be bit-equal to `BatchEngine` over `partition_files(paths, rank, 2)`;
  with a corrupt file on rank 1, errors="raise" must make both ranks raise
  (rank 1 its decode error, rank 0 a RuntimeError naming rank 1 and the
  path) within the fleet's timeout, and neither hang.

On the card the fleet is chip_smoke.py's phase 2e (two ranks sharing one
card, the batched kernels in each).
"""

import json
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

from imagepipe_tpu.decode import save_synraw
from imagepipe_tpu.parallel.multihost import MultiHostBatchEngine as JMultiHostBatchEngine
from imagepipe_tpu.raw import synthetic_bayer
from imagepipe_tpu_torch.kernels import develop as kdev
from imagepipe_tpu_torch.parallel import BatchEngine, BatchError, MultiHostBatchEngine
from imagepipe_tpu_torch.parallel import multihost

import torch_fleet

torch.set_num_threads(1)

FLEET_TIMEOUT_S = 120


def _files(tmp_path, n, w=96, h=64, seed0=0):
    paths = []
    for s in range(n):
        p = str(tmp_path / f"mh{w}x{h}_{s}.synraw.npz")
        save_synraw(p, synthetic_bayer(w, h, seed=seed0 + s))
        paths.append(p)
    return paths


def _corrupt(tmp_path, paths, at):
    bad = tmp_path / "corrupt.synraw.npz"
    bad.write_bytes(b"not an npz")
    paths.insert(at, str(bad))
    return str(bad)


def _mixed(tmp_path, seed0):
    """Two sensor sizes interleaved, so buckets are not contiguous."""
    paths = _files(tmp_path, 3, 96, 64, seed0) + _files(tmp_path, 2, 48, 32, seed0 + 10)
    paths += _files(tmp_path, 2, 96, 64, seed0 + 20)
    return [paths[i] for i in (0, 3, 1, 4, 5, 2, 6)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, BatchError):
            assert isinstance(a, BatchError) and a.path == b.path
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_partition_files_deterministic_cover(count):
    paths = [f"f{i}" for i in range(11)]
    got = [multihost.partition_files(paths, pi, count) for pi in range(count)]
    assert sorted(p for part in got for p in part) == sorted(paths)
    assert got == [paths[pi::count] for pi in range(count)]
    with pytest.raises(ValueError, match="process index"):
        multihost.partition_files(paths, count, count)
    with pytest.raises(ValueError, match="process index"):
        multihost.partition_files(paths, -1, count)
    # No process group: the whole list is this process's.
    assert multihost.partition_files(paths) == paths


def test_matches_batch_engine_single_process(tmp_path):
    paths = _files(tmp_path, 5, seed0=30)
    eng = MultiHostBatchEngine(devices=["cpu"])
    assert (eng.rank, eng.world, eng.group) == (0, 1, None)
    mh = eng.develop_files(paths)
    assert len(mh) == 5 and eng.engine.timings["decode"] > 0
    _assert_same(mh, BatchEngine(devices=["cpu"]).develop_files(paths))


def test_mixed_sensor_sizes_interleaved(tmp_path):
    paths = _mixed(tmp_path, 80)
    mh = MultiHostBatchEngine(devices=["cpu"], max_batch=2).develop_files(paths)
    big, small = (64, 96, 3), (32, 48, 3)
    assert [m.shape for m in mh] == [big, small, big, small, big, big, big]
    _assert_same(mh, BatchEngine(devices=["cpu"], max_batch=2).develop_files(paths))


def test_errors_skip_and_raise(tmp_path):
    paths = _files(tmp_path, 4, seed0=70)
    bad = _corrupt(tmp_path, paths, 2)
    eng = MultiHostBatchEngine(devices=["cpu"])
    mh = eng.develop_files(paths)                     # the default: skip
    assert isinstance(mh[2], BatchError) and mh[2].path == bad and not mh[2]
    assert sum(1 for r in mh if not isinstance(r, BatchError)) == 4
    _assert_same(mh, BatchEngine(devices=["cpu"]).develop_files(paths, errors="skip"))
    # errors="raise": the file's own exception, as BatchEngine raises it.
    with pytest.raises(Exception) as raised:
        eng.develop_files(paths, errors="raise")
    assert not isinstance(raised.value, RuntimeError) or "rank" not in str(raised.value)
    with pytest.raises(ValueError, match="errors"):
        eng.develop_files(paths, errors="ignore")


def test_develop_error_raises(tmp_path, monkeypatch):
    """An error of the develop itself (not of a file) reaches the caller."""
    paths = _files(tmp_path, 2, seed0=60)
    eng = MultiHostBatchEngine(devices=["cpu"])

    def fail(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(eng.engine, "develop_files", fail)
    for errors in ("skip", "raise"):
        with pytest.raises(RuntimeError, match="launch failed"):
            eng.develop_files(paths, errors=errors)


def test_defaults_to_cuda_never_the_cpu(monkeypatch):
    """Without devices the engine takes every CUDA device; without one it
    raises rather than develop on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiHostBatchEngine()


@pytest.mark.parametrize("case", ["uniform", "mixed sizes, corrupt file"])
def test_port_matches_jax_multihost_engine(tmp_path, case):
    """The port's engine against the JAX package's, single-process, on the
    same files: the cross-package contract."""
    if case == "uniform":
        paths = _files(tmp_path, 5, seed0=100)
    else:
        paths = _mixed(tmp_path, 120)
        _corrupt(tmp_path, paths, 1)
    got = MultiHostBatchEngine(devices=["cpu"]).develop_files(paths)
    want = JMultiHostBatchEngine().develop_files(paths)
    assert len(got) == len(want) == len(paths)
    for g, w in zip(got, want):
        if isinstance(g, BatchError):
            assert not w
            continue
        assert g.shape == w.shape and g.dtype == w.dtype
        maxd, frac = kdev.compare(g, w)
        assert maxd <= kdev.MAX_LSB and frac < kdev.MAX_FLIP_FRACTION, (maxd, frac)


def test_two_process_gloo_fleet(tmp_path):
    """Two ranks over a FileStore: each bit-equal to BatchEngine over its
    partition; errors="raise" with a corrupt file on rank 1 raises on both."""
    paths = _mixed(tmp_path, 140)
    bad = _corrupt(tmp_path, paths, 5)                # index 5: rank 1's
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_fleet.run_rank,
                         args=(r, 2, str(tmp_path / "store"), paths, str(out_dir)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {FLEET_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]

    for r in range(2):
        mine = multihost.partition_files(paths, r, 2)
        want = BatchEngine(devices=["cpu"], max_batch=4).develop_files(mine, errors="skip")
        with np.load(out_dir / f"rank{r}.npz") as z:
            got = [z[f"arr_{i}"] for i in range(len(z.files))]
        assert len(got) == len(want) == len(mine)
        for g, w, path in zip(got, want, mine):
            if isinstance(w, BatchError):
                assert path == bad and g.size == 0
            else:
                np.testing.assert_array_equal(g, w)
        with open(out_dir / f"rank{r}.json") as f:
            report = json.load(f)
        assert (report["rank"], report["world"]) == (r, 2)
        raised = report["raised"]
        assert raised is not None, f"rank {r} did not raise"
        if r == 1:
            assert raised["type"] != "RuntimeError" or "rank 1" not in raised["message"]
        else:
            assert raised["type"] == "RuntimeError"
            assert "rank 1" in raised["message"] and bad in raised["message"]
