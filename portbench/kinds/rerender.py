"""`Pipeline.output_8bit(None)` (`output_16bit` for a 16-bit output) with the
sensor plane on the card, after a new seeded exposure each time: the fused
path.

Traffic keys: `exposure_range`, `percentiles` ({metric: q}), `checked`.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from .. import bounds
from ..drivers import Requests, frame_meta, reference_plane
from ..reference import develop as rdev


class Driver(Requests):
    def setup(self):
        from imagepipe_tpu_torch.decode import decode_file
        from imagepipe_tpu_torch.pipeline import Pipeline

        self._frame()
        t0 = time.perf_counter()
        self.pipe = Pipeline.new_from_source(decode_file(self.path), self.device)
        t0 = self._part("decode", t0)
        warm = np.random.default_rng([self.seed, 2])
        for _ in range(3):
            self._render(float(warm.uniform(*self.traffic["exposure_range"])))
        self._part("warm_renders", t0)
        self.rng = np.random.default_rng([self.seed, 3])

    def _render(self, exposure):
        self.pipe.ops.basecurve.exposure = exposure
        if self.bits == 16:
            return self.pipe.output_16bit(None)
        return self.pipe.output_8bit(None)

    def step(self, i):
        exposure = float(self.rng.uniform(*self.traffic["exposure_range"]))
        t0 = time.perf_counter()
        try:
            img, failed = self._render(exposure), 0
        except Exception:    # a failed request counts; the loop goes on
            traceback.print_exc()
            img, failed = None, 1
        t1 = time.perf_counter()
        if img is not None:
            self.sample.offer((i, exposure, img.data))
        return dict(t0=t0, t1=t1, attempted=1, failed=failed)

    def readings(self, records):
        f = self.frame
        plan = rdev.make_plan(frame_meta(f))
        return dict(requests=len(records),
                    bounds={"develop": len(records)
                            * bounds.develop_s(f.width, f.height, plan.grid, self.bits // 8)})

    def release(self):
        del self.pipe

    def checks(self, dtype):
        plane = reference_plane(self.frame, self.device)
        meta = frame_meta(self.frame)
        for i, exposure, out in sorted(self.sample.items, key=lambda item: item[0]):
            plan = rdev.make_plan(meta, exposure=exposure, bits=self.bits)
            yield f"request {i} exposure {exposure}", out, rdev.develop(plane, plan, dtype)
