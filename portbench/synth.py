"""The benchmark's inputs: synthetic sensor frames made from the seed, and the
files that carry them to the program, written by the container that the
configuration names (`container.writer`: the module
`containers/<writer>.py`, with its file `SUFFIX` and `encode(frame)`).

A frame is a smooth scene (gradients plus 16-pixel blocks of Gaussian noise
of 0.03, the form of the program's `raw._synthetic_raw`) sampled through the
configuration's CFA and scaled to its black and white levels. It is made on
the card with a seeded `torch.Generator` in a few large calls. Its metadata
is what the DNG file states, held as the file holds it (rationals over
10000), so that the plain reference and the program read the same numbers.
"""

from __future__ import annotations

import importlib
import os
from dataclasses import dataclass, field

import numpy as np
import torch

# EXIF orientation values (TIFF 6.0 tag 274) by name.
EXIF_ORIENTATION = {"Normal": 1, "Rotate90": 6}
RATIONAL_DEN = 10000
NOISE_BLOCK = 16
NOISE_SIGMA = 0.03


@dataclass
class Frame:
    """One DNG's content: the sensor plane (u16 [H, W], host) and the
    metadata the file states."""
    width: int
    height: int
    cfa: str                       # row-major pattern letters, R G B
    cfa_dims: tuple[int, int]      # (rows, cols) of the pattern
    black: int
    white: int
    color_matrix: list[int]        # ColorMatrix1, 9 numerators over RATIONAL_DEN
    neutral: list[int]             # AsShotNeutral, 3 numerators over RATIONAL_DEN
    orientation: str               # key of EXIF_ORIENTATION
    data: np.ndarray = field(repr=False)
    model: str = ""

    @property
    def megapixels(self) -> float:
        return self.width * self.height / 1e6


def cfa_grid(cfa: str, dims) -> np.ndarray:
    """[rows, cols] colour index (R 0, G 1, B 2) of a pattern string."""
    idx = {"R": 0, "G": 1, "B": 2}
    return np.array([idx[c] for c in cfa], np.int64).reshape(dims)


def scene_planes(gen: torch.Generator, width: int, height: int, device) -> torch.Tensor:
    """[3, H, W] float32 linear scene in [0, 1] from `gen`."""
    yy = torch.linspace(0, 1, height, device=device)[:, None].expand(height, width)
    xx = torch.linspace(0, 1, width, device=device)[None, :].expand(height, width)
    base = torch.stack([0.55 * xx + 0.15 * yy, 0.35 + 0.3 * yy * xx, 0.65 - 0.4 * xx])
    bh, bw = height // NOISE_BLOCK + 1, width // NOISE_BLOCK + 1
    noise = torch.randn((3, bh, bw), generator=gen, device=device) * NOISE_SIGMA
    noise = noise.repeat_interleave(NOISE_BLOCK, 1).repeat_interleave(NOISE_BLOCK, 2)
    return torch.clamp(base + noise[:, :height, :width], 0.0, 1.0)


def mosaic(rgb: torch.Tensor, grid: np.ndarray, black: int, white: int) -> np.ndarray:
    """Sample [3, H, W] through the CFA grid and scale to the levels ->
    host u16 [H, W] (truncated, as a sensor's counts)."""
    _, h, w = rgb.shape
    g = torch.from_numpy(grid).to(rgb.device)
    colors = g[(torch.arange(h, device=rgb.device) % g.shape[0])[:, None],
               (torch.arange(w, device=rgb.device) % g.shape[1])[None, :]]
    plane = torch.gather(rgb, 0, colors[None])[0]
    counts = plane * float(white - black) + float(black)
    return counts.to(torch.int16).cpu().numpy().view(np.uint16)


def neutral_for(rng: np.random.Generator, spread) -> list[int]:
    """AsShotNeutral numerators: green 1, red and blue the inverse of a white
    balance multiplier drawn from `spread` ([[r_lo, r_hi], [b_lo, b_hi]])."""
    (r_lo, r_hi), (b_lo, b_hi) = spread
    r = rng.uniform(r_lo, r_hi)
    b = rng.uniform(b_lo, b_hi)
    return [int(round(RATIONAL_DEN / r)), RATIONAL_DEN, int(round(RATIONAL_DEN / b))]


def make_frames(config: dict, n_files: int, n_bases: int, orientations, seed: int,
                device) -> list[Frame]:
    """`n_files` frames over `n_bases` scenes from `seed`: file i shows
    scene i % n_bases in orientation i % len(orientations) with its own
    white balance. Every seed gives the same sizes, CFA and orientations;
    the seed draws the scenes' noise and the white balances."""
    s = config["sensor"]
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    grid = cfa_grid(s["cfa"], s["cfa_dims"])
    planes = [mosaic(scene_planes(gen, s["width"], s["height"], device), grid,
                     s["black_level"], s["white_level"]) for _ in range(n_bases)]
    frames = []
    for i in range(n_files):
        frames.append(Frame(
            width=s["width"], height=s["height"], cfa=s["cfa"], cfa_dims=tuple(s["cfa_dims"]),
            black=s["black_level"], white=s["white_level"],
            color_matrix=list(config["color_matrix"]),
            neutral=neutral_for(rng, config["white_balance_spread"]),
            orientation=orientations[i % len(orientations)],
            data=planes[i % n_bases], model=config["name"]))
    return frames


def write_files(frames: list[Frame], directory: str, config: dict) -> list[str]:
    """Write each frame as `<directory>/<config name>_<i><suffix>` in the
    configuration's container; returns the paths."""
    container = importlib.import_module(f"portbench.containers.{config['container']['writer']}")
    paths = []
    for i, frame in enumerate(frames):
        path = os.path.join(directory, f"{config['name']}_{i:02d}{container.SUFFIX}")
        with open(path, "wb") as f:
            f.write(container.encode(frame))
            # On the disk before the window, so that the kernel's write-back
            # does not run inside it.
            f.flush()
            os.fsync(f.fileno())
        paths.append(path)
    return paths
