"""Passes of `BatchEngine.develop_files` over the cell's files, back to back.

Traffic keys: `files`, `base_frames`, `orientations` (the files: file i
shows scene i % base_frames in orientation i % len(orientations)),
`max_batch`, `maxwidth` (0: full size), `decode_workers` (the engine's
decode threads, fixed so that the pool does not follow the host) and
`checked` (outputs of the window compared with the reference). The files
sit in the page cache after the warm pass.
"""

from __future__ import annotations

import os
import time

import numpy as np

from .. import bounds, summary, synth
from ..drivers import Driver as Base
from ..drivers import Reservoir, frame_meta, reference_plane
from ..reference import develop as rdev


def host_cores() -> str:
    try:
        affinity = len(os.sched_getaffinity(0))
    except AttributeError:
        affinity = None
    return f"{affinity} in this process's affinity, {os.cpu_count()} on the host"


class Driver(Base):
    def setup(self):
        from imagepipe_tpu_torch.parallel import BatchEngine

        t = self.traffic
        t0 = time.perf_counter()
        self.frames = synth.make_frames(self.config, t["files"], t["base_frames"],
                                        t["orientations"], self.seed, self.device)
        t0 = self._part("frames", t0)
        self.paths = synth.write_files(self.frames, self.scratch, self.config)
        t0 = self._part("write_files", t0)
        self.engine = BatchEngine(devices=[self.device], out_bits=self.bits,
                                  max_batch=t["max_batch"], maxwidth=t["maxwidth"],
                                  decode_workers=t["decode_workers"])
        print(f"decode workers: {self.engine.decode_workers}; CPU cores: {host_cores()}",
              flush=True)
        self.engine.develop_files(self.paths, errors="skip")
        self._part("warm_pass", t0)
        self.engine.timings.clear()
        self.sample = Reservoir(t["checked"], [self.seed, 1])

    def step(self, i):
        t0 = time.perf_counter()
        outs = self.engine.develop_files(self.paths, errors="skip")
        t1 = time.perf_counter()
        failed = 0
        for k, out in enumerate(outs):
            if isinstance(out, np.ndarray):
                self.sample.offer((i, k, out))
            else:
                failed += 1
        return dict(t0=t0, t1=t1, attempted=len(outs), failed=failed,
                    mp=sum(f.megapixels for f, o in zip(self.frames, outs)
                           if isinstance(o, np.ndarray)))

    def end_to_end(self, records):
        return {"ingest_mp_s": summary.rate([r["mp"] for r in records], [r["t0"] for r in records],
                                            [r["t1"] for r in records])}

    def _plan(self, frame):
        return rdev.make_plan(frame_meta(frame), maxwidth=self.traffic["maxwidth"],
                              bits=self.bits)

    def readings(self, records):
        files = sum(r["attempted"] - r["failed"] for r in records)
        work = {"develop": 0.0, "develop_scaled": 0.0}
        for frame in self.frames:
            plan = self._plan(frame)
            w, h = frame.width, frame.height
            if plan.path == "scaled":
                axes = rdev.aligned_axes(w, h, (0, 0), (w - 1, 0), (0, h - 1), plan.dem_w,
                                         plan.dem_h)
                work["develop_scaled"] += bounds.scaled_s(w, h, axes, self.bits // 8)
            else:
                work["develop"] += bounds.develop_s(w, h, plan.grid, self.bits // 8)
        passes = files / len(self.frames)
        work = {k: v * passes for k, v in work.items() if v}
        return dict(files=files, timings=dict(self.engine.timings), bounds=work)

    def release(self):
        del self.engine

    def checks(self, dtype):
        refs = {}
        for p, k, out in sorted(self.sample.items, key=lambda item: item[:2]):
            if k not in refs:
                refs[k] = rdev.develop(reference_plane(self.frames[k], self.device),
                                       self._plan(self.frames[k]), dtype)
            yield f"pass {p} file {k}", out, refs[k]
