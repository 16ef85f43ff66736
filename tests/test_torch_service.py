"""PyTorch port: the render service (sessions, setting patches, cached
re-renders, settings round trip, a shared cache, threads) against the JAX
package.

The five scenarios of tests/test_service.py, run on the port's
`RenderService(device="cpu")` and, request for request, on the JAX
package's: outputs within the cross-path contract (max |diff| <= 1 LSB on
under 2% of values), cache lengths equal. Within the port the scenarios'
own checks hold exactly (a restored setting is a full cache hit, bit-equal).
"""

import threading

import numpy as np
import pytest
import torch

from imagepipe_tpu import ImageSource as JSource
from imagepipe_tpu.raw import synthetic_bayer
from imagepipe_tpu.service import RenderService as JService
from imagepipe_tpu_torch import ImageSource as TSource
from imagepipe_tpu_torch import raw as traw
from imagepipe_tpu_torch.dng import write_dng
from imagepipe_tpu_torch.kernels.develop import MAX_FLIP_FRACTION, MAX_LSB, compare
from imagepipe_tpu_torch.service import RenderService as TService

torch.set_num_threads(1)


def _assert_contract(got, want):
    assert got.data.shape == want.data.shape and got.data.dtype == want.data.dtype
    maxd, frac = compare(got.data, want.data)
    assert maxd <= MAX_LSB and frac < MAX_FLIP_FRACTION, (maxd, frac)


def _services(cache_bytes):
    return JService(cache_bytes=cache_bytes), TService(cache_bytes=cache_bytes, device="cpu")


def _open(svcs, key, w, h, seed):
    js, ts = svcs
    return (js.open_source(key, JSource.from_raw(synthetic_bayer(w, h, seed=seed))),
            ts.open_source(key, TSource.from_raw(traw.synthetic_bayer(w, h, seed=seed))))


def test_service_edit_loop():
    svcs = _services(500 << 20)
    _open(svcs, "img1", 160, 100, 3)

    def both(method, *args, **kwargs):
        want, got = (getattr(s, method)("img1", *args, **kwargs) for s in svcs)
        _assert_contract(got, want)
        assert len(svcs[1].cache) == len(svcs[0].cache)
        return got

    base = both("render")
    assert (base.width, base.height) == (160, 100)
    brighter = both("edit", {"basecurve": {"exposure": 0.8}})
    assert brighter.data.mean() > base.data.mean() + 5
    # Restoring the setting is a full cache hit: identical bits.
    restored = both("edit", {"basecurve": {"exposure": 0.0}})
    np.testing.assert_array_equal(base.data, restored.data)
    prev = both("render", max_size=64)
    assert (prev.width, prev.height) == (64, 40)
    cropped = both("edit", {"rotatecrop": {"crop_left": 0.25}}, max_size=0)
    assert cropped.width == 120
    rotated = both("edit", {"rotatecrop": {"rotation": 0.1}})
    assert rotated.width > cropped.width
    out16 = both("render", bits=16)
    assert out16.data.dtype == np.uint16
    for patch in ({"nosuch": {"x": 1}}, {"basecurve": {"nope": 1}}):
        with pytest.raises(KeyError):
            svcs[1].edit("img1", patch)


def test_service_settings_roundtrip():
    svcs = _services(100 << 20)
    outs = []
    for svc, src in zip(svcs, (JSource, TSource)):
        raw = (synthetic_bayer if src is JSource else traw.synthetic_bayer)(96, 64, seed=4)
        s = svc.open_source("a", src.from_raw(raw))
        s.apply({"basecurve": {"exposure": 0.4}, "rotatecrop": {"rotation": 0.05}})
        serial = s.save_settings()
        out_a = s.render()
        s2 = svc.open_source("b", src.from_raw(raw))
        s2.load_settings(serial)
        out_b = svc.sessions["b"].render()
        np.testing.assert_array_equal(out_a.data, out_b.data)
        outs.append(out_a)
    assert svcs[1].sessions["b"].pipeline.device == torch.device("cpu")
    _assert_contract(outs[1], outs[0])


def _raster_source(module, seed):
    rng = np.random.default_rng(seed)
    return module.from_raster(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))


def test_service_load_settings_keeps_the_staged_route():
    """A raster session with default ops after save_settings/load_settings
    still renders staged: through its session cache, whose entries grow."""
    svc = TService(cache_bytes=100 << 20, device="cpu")
    s = svc.open_source("r", _raster_source(TSource, 7))
    s.load_settings(s.save_settings())
    assert s.pipeline.globals.settings.use_fastpath is False
    first = s.render()
    assert len(svc.cache) == 8 and s.cache_bytes() > 0
    s.apply({"basecurve": {"exposure": 0.3}})
    s.render()
    assert len(svc.cache) > 8
    assert first.data.shape == (48, 64, 3)


def test_jax_service_load_settings_drops_the_staged_route():
    """The JAX package's session loses its staged routing on load_settings
    (ROADMAP C): the raster renders through the fast path and the cache
    stays empty. The port keeps the route (test above)."""
    svc = JService(cache_bytes=100 << 20)
    s = svc.open_source("r", _raster_source(JSource, 7))
    assert s.pipeline.globals.settings.use_fastpath is False
    s.load_settings(s.save_settings())
    assert s.pipeline.globals.settings.use_fastpath is True
    s.render()
    assert len(svc.cache) == 0


def test_service_two_sessions_share_cache():
    svcs = _services(500 << 20)
    _open(svcs, "x", 96, 64, 5)
    _open(svcs, "y", 96, 64, 6)
    for key in ("x", "y"):
        _assert_contract(svcs[1].render(key), svcs[0].render(key))
    assert not np.array_equal(svcs[1].render("x").data, svcs[1].render("y").data)
    assert len(svcs[1].cache) == len(svcs[0].cache) == 16  # 8 stages per image


def test_service_per_session_byte_accounting():
    """Owner-tagged accounting: per-session bytes sum to the cache total and
    fall as a session's entries are evicted, as in the JAX package."""
    svcs = _services(500 << 20)
    sessions = [_open(svcs, "x", 96, 64, 5), _open(svcs, "y", 96, 64, 6)]
    for svc in svcs:
        svc.render("x")
    assert sessions[0][1].cache_bytes() > 0 and sessions[1][1].cache_bytes() == 0
    for svc in svcs:
        svc.render("y")
    before_x = sessions[0][1].cache_bytes()
    for i, svc in enumerate(svcs):
        sx, sy = sessions[0][i], sessions[1][i]
        assert sx.cache_bytes() + sy.cache_bytes() == svc.cache.total_bytes
        svc.cache.max_bytes = sy.cache_bytes() // 2
        svc.edit("y", {"basecurve": {"exposure": 0.3}})
        assert sx.cache_bytes() + sy.cache_bytes() == svc.cache.total_bytes
    assert sessions[0][1].cache_bytes() < before_x
    assert [s[1].cache_bytes() for s in sessions] == [s[0].cache_bytes() for s in sessions]


def test_service_concurrent_sessions_threads():
    """Edits and renders of different sessions from threads: every result
    equals the same edit applied alone, and agrees with the JAX package."""
    svc = TService(cache_bytes=500 << 20, device="cpu")
    for i in range(4):
        svc.open_source(f"s{i}", TSource.from_raw(traw.synthetic_bayer(96, 64, seed=10 + i)))
    results, errors = {}, []

    def worker(key, expo):
        try:
            svc.render(key)
            results[key] = svc.edit(key, {"basecurve": {"exposure": expo}})
        except Exception as e:  # pragma: no cover
            errors.append((key, e))

    threads = [threading.Thread(target=worker, args=(f"s{i}", 0.1 * i)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in range(4):
        alone = TService(cache_bytes=100 << 20, device="cpu")
        alone.open_source("one", TSource.from_raw(traw.synthetic_bayer(96, 64, seed=10 + i)))
        np.testing.assert_array_equal(results[f"s{i}"].data,
                                      alone.edit("one", {"basecurve": {"exposure": 0.1 * i}}).data)
        jalone = JService(cache_bytes=100 << 20)
        jalone.open_source("one", JSource.from_raw(synthetic_bayer(96, 64, seed=10 + i)))
        _assert_contract(results[f"s{i}"], jalone.edit("one", {"basecurve": {"exposure": 0.1 * i}}))


def test_service_device_and_close(tmp_path):
    """The service's device reaches every session (open_file too), and
    close forgets a session."""
    svc = TService(cache_bytes=64 << 20, device="cpu")
    path = str(tmp_path / "f.dng")
    write_dng(path, traw.synthetic_bayer(64, 48, seed=1))
    s = svc.open_file("f", path)
    assert s.pipeline.device == torch.device("cpu")
    assert not s.pipeline.globals.settings.use_fastpath
    assert svc.render("f").data.shape == (48, 64, 3)
    svc.close("f")
    with pytest.raises(KeyError):
        svc.render("f")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TService()
