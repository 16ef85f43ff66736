"""What every traffic kind shares: how a cell drives the program, one unit
of work at a time, and what it hands the plain reference afterwards.

A traffic file (`traffic/<mix>.json`) names its kind and the kind's
parameters; the kind is the module `kinds/<kind>.py`, found by that name,
whose `Driver` class runs it. The configuration file
(`configs/<name>.json`) gives the frames' shape, their container and the
output's bits. Each driver:

* `setup()` makes the inputs from the seed, builds the program's object and
  warms it with the traffic's own kinds of work;
* `step(i)` runs one unit (an ingest pass, or one request) and returns its
  host-clock record;
* `end_to_end(records)` reduces the window's records to its end-to-end
  metrics;
* `readings(records)` gives the per-layer metrics' readers what the window
  left (engine timings, stage times, the launches' bounds);
* `release()` frees the program's state; `checks(dtype)` then yields
  (label, output, reference) for a sample of the window's outputs drawn
  from the seed, the reference computed in `dtype`.

A traffic file may also name the program's `numerics` ('lut' or 'direct');
`numerics(traffic)` holds that override for the driver's whole life.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch

from . import summary, synth


def load_kind(name: str):
    """The `Driver` class of `kinds/<name>.py`."""
    return importlib.import_module(f"portbench.kinds.{name}").Driver


def numerics(traffic: dict):
    """The traffic's numerics override of the program, for as long as the
    context is open; none where the traffic names none."""
    if "numerics" not in traffic:
        return contextlib.nullcontext()
    from imagepipe_tpu_torch import color

    return color.numerics_mode(traffic["numerics"])


class Reservoir:
    """A uniform sample of at most k items of a stream, drawn from a seeded
    generator (reservoir sampling)."""

    def __init__(self, k: int, seed):
        self.k, self.n, self.items = k, 0, []
        self.rng = np.random.default_rng(seed)

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = item
        self.n += 1


def frame_meta(frame: synth.Frame) -> dict:
    """The reference's view of a frame: what its DNG file states."""
    return dict(width=frame.width, height=frame.height, cfa=frame.cfa, cfa_dims=frame.cfa_dims,
                black=frame.black, white=frame.white, color_matrix=frame.color_matrix,
                neutral=frame.neutral, exif=synth.EXIF_ORIENTATION[frame.orientation],
                den=synth.RATIONAL_DEN)


def reference_plane(frame: synth.Frame, device) -> torch.Tensor:
    return torch.from_numpy(frame.data.astype(np.int32)).to(device)


class Driver:
    def __init__(self, config, traffic, seed, device, scratch, trace):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.scratch, self.trace = torch.device(device), scratch, trace
        self.bits = config["output"]["bits"]
        self.parts: dict[str, float] = {}

    def _part(self, name, t0) -> float:
        t = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + t - t0
        return t

    def attempted(self, records) -> int:
        return sum(r["attempted"] for r in records)

    def failed(self, records) -> int:
        return sum(r["failed"] for r in records)


class Requests(Driver):
    """A closed loop of one user on one frame: each request starts when the
    last has returned its host pixels."""

    def end_to_end(self, records):
        """Each of the traffic's `percentiles` ({metric: q}) over the ms of
        all the window's requests."""
        ms = [(r["t1"] - r["t0"]) * 1e3 for r in records]
        return {name: summary.percentile(ms, q) for name, q in self.traffic["percentiles"].items()}

    def _frame(self):
        t0 = time.perf_counter()
        self.frame = synth.make_frames(self.config, 1, 1, ["Normal"], self.seed, self.device)[0]
        t0 = self._part("frames", t0)
        self.path = synth.write_files([self.frame], self.scratch, self.config)[0]
        self._part("write_files", t0)
        self.sample = Reservoir(self.traffic["checked"], [self.seed, 1])

