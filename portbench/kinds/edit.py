"""`RenderService.edit` after each setting change: a seeded script of
exposure, rotation and crop steps, in blocks that hold the same number of
each kind for every seed.

Traffic keys: `cache_bytes` (the service's stage cache), `first_render`
(the settings of the opening render, made in set-up), `block` (edits of
each kind in a block), `exposure` (`range` of the walk, `step` sizes),
`rotation` (magnitudes; signs alternate), `crop_left` (range),
`percentiles` ({metric: q}), `checked`, and `stage_block`: edits replayed
in the traced run alone, after the window, to read the stages' times, on
a second session whose stage cache keeps nothing and with the program's
logger at DEBUG (each stage then ends in a device synchronize, so the
window itself stays at the program's own level).
"""

from __future__ import annotations

import itertools
import logging
import time
import traceback

import numpy as np

from .. import bounds
from ..drivers import Requests, frame_meta, reference_plane
from ..reference import develop as rdev
from ..reference import staged as rstaged

KEY = "frame"


class Driver(Requests):
    def setup(self):
        from imagepipe_tpu_torch.service import RenderService

        t = self.traffic
        self._frame()
        t0 = time.perf_counter()
        self.service = RenderService(cache_bytes=t["cache_bytes"], device=self.device)
        self.session = self.service.open_file(KEY, self.path)
        t0 = self._part("open_file", t0)
        self.settings = {}
        self._edit(self._patch(t["first_render"]))
        t0 = self._part("first_render", t0)
        for patch in self._script([self.seed, 2], warm=True):
            self._edit(patch)
        self._part("warm_edits", t0)
        self.script = self._script([self.seed, 3])
        self.done = []

    @staticmethod
    def _patch(settings: dict) -> dict:
        ops = {"exposure": "basecurve", "rotation": "rotatecrop", "crop_left": "rotatecrop"}
        patch = {}
        for k, v in settings.items():
            patch.setdefault(ops[k], {})[k] = v
        return patch

    def _script(self, seed, warm=False):
        """Patches: blocks of the traffic's kinds in a seeded order; `warm`
        gives one block of one edit of each kind (both rotation signs)."""
        t = self.traffic
        rng = np.random.default_rng(seed)
        lo, hi = t["exposure"]["range"]
        x = float(rng.uniform(lo, hi))
        kinds = [k for k, n in t["block"].items() for _ in range(n)]
        if warm:
            kinds = list(t["block"]) + ["rotation"]
        while True:
            signs = [-1.0, 1.0] * (len(kinds) // 2 + 1)
            for kind in (kinds if warm else list(rng.permutation(kinds))):
                if kind == "exposure":
                    step = rng.uniform(*t["exposure"]["step"]) * rng.choice([-1.0, 1.0])
                    x = x + step if lo <= x + step <= hi else x - step
                    yield self._patch({"exposure": float(x)})
                elif kind == "rotation":
                    rotation = signs.pop() * float(rng.uniform(*t["rotation"]))
                    yield self._patch({"rotation": rotation})
                else:
                    yield self._patch({"crop_left": float(rng.uniform(*t["crop_left"]))})
            if warm:
                return

    def _edit(self, patch):
        for fields in patch.values():
            self.settings.update(fields)
        return self.service.edit(KEY, patch, bits=self.bits)

    def step(self, i):
        patch = next(self.script)
        t0 = time.perf_counter()
        try:
            img = self._edit(patch)
            failed = 0
        except Exception:    # a failed request counts; the loop goes on
            traceback.print_exc()
            img, failed = None, 1
        t1 = time.perf_counter()
        if img is not None:
            self.sample.offer((i, dict(self.settings), img.data))
        if self.trace:
            self.done.append((dict(self.settings), "rotatecrop" in patch))
        return dict(t0=t0, t1=t1, attempted=1, failed=failed)

    def stage_times(self) -> list[dict]:
        """`Pipeline.stage_ms` of each of `stage_block` edits of the script
        (seeded apart from the window's), replayed after the opening
        render on a second session of the frame whose stage cache keeps
        nothing, so that every stage runs on every edit, with the program's
        logger at DEBUG."""
        from imagepipe_tpu_torch.service import RenderService

        service = RenderService(cache_bytes=1, device=self.device)
        session = service.open_file(KEY, self.path)
        patches = itertools.chain([self._patch(self.traffic["first_render"])],
                                  itertools.islice(self._script([self.seed, 4]),
                                                   self.traffic["stage_block"]))
        log = logging.getLogger("imagepipe_tpu_torch")
        level, times = log.level, []
        log.setLevel(logging.DEBUG)
        try:
            for patch in patches:
                service.edit(KEY, patch, bits=self.bits)
                times.append(dict(session.pipeline.stage_ms))
        finally:
            log.setLevel(level)
        return times[1:]

    def readings(self, records):
        meta = frame_meta(self.frame)
        n_knots = len(rdev.make_plan(meta).spline.xs)
        work = {"rotate": 0.0, "suffix": 0.0}
        for settings, geometry in self.done:
            rc = rstaged.RotateCrop(rotation=settings.get("rotation", 0.0),
                                    crop_left=settings.get("crop_left", 0.0))
            dw, dh = rstaged.demosaic_size(meta["width"], meta["height"], rc, (False,) * 3)
            g = rc.geometry(dw, dh)
            nw, nh = (g[3], g[4]) if g is not None else (dw, dh)
            stages = (["to_lab"] if geometry else []) + ["basecurve", "from_lab", "gamma"]
            work["suffix"] += bounds.suffix_s(nw, nh, stages, n_knots)
            rotated = g is not None and not (int(g[1][1]) == int(g[0][1])
                                              and int(g[2][0]) == int(g[0][0])
                                              and nw > 1 and nh > 1)
            if geometry and rotated:
                work["rotate"] += bounds.rotate_s(dw, dh, nw, nh)
        stage_ms = self.stage_times() if self.trace else []
        return dict(requests=len(records), stage_ms=stage_ms, bounds=work)

    def release(self):
        del self.session, self.service

    def checks(self, dtype):
        plane = reference_plane(self.frame, self.device)
        for i, settings, out in sorted(self.sample.items, key=lambda item: item[0]):
            yield (f"request {i} {settings}", out,
                   rstaged.render(plane, frame_meta(self.frame), settings, dtype, self.bits))
