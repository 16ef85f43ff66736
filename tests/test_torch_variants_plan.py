"""PyTorch port: the launch plan of the ablation ladder's kernel (kernels/variants.py).

csrc/develop_variants.cu takes its plan from the host: the load route (TMA
or vector loads) chosen from the plane's row stride, the tile height, and
the vectors each block stores. These tests hold the plan's host side on the
CPU, through a mirror of the kernel's indexing (`plan_coverage`,
`interior_pixels`): every output pixel is stored exactly once, the route follows the
stride's alignment per plane type, every pixel the plan sends down the
demosaic's interior path has its eight neighbours in the image, and the
exact-arithmetic identities the kernel's design rests on hold bit for bit
(the interior averages as products, the quantize's scale folded into them,
u16 samples as floats through 2^23). The kernel itself is held to its plain
version on the card by tests/test_torch_variants.py.
"""

import numpy as np
import pytest
import torch

from imagepipe_tpu_torch.kernels import variants as kv

# (variant, form, out dtype): each distinct plan geometry (tile height and
# vector width) the kernel launches.
GEOMETRIES = [("noop", "B", torch.uint8), ("noop", "B", torch.float32),
              ("dma_floor", "A", torch.uint8), ("dma_floor", "B", torch.float32),
              ("levels", "B", torch.uint8), ("demosaic", "B", torch.uint8),
              ("full", "B", torch.float32)]
SIZES = [(1, 1), (1, 7), (5, 8), (3, 129), (67, 130), (67, 301), (100, 500), (192, 768),
         (33, 4097)]


def _plan_vectors(plan):
    """(y, x) of every vector the kernel stores under `plan`, indexed as it
    does: block (bx, by) takes vectors v < (kv.TILE_COLS / vec) * rows, rows =
    its tile rows inside the image, at row by * tile_rows + v // (kv.TILE_COLS
    / vec) and column bx * kv.TILE_COLS + (v % (kv.TILE_COLS / vec)) * vec, and
    skips a vector that starts past the width. noop: thread t of block b
    fills the flat output [3, height, width] from (b * 256 + t) * vec, given
    here as (0, flat index) over an output one row high."""
    height, width = plan["shape"]
    vec, tile_rows = plan["vec"], plan["tile_rows"]
    if tile_rows is None:
        starts = np.arange(plan["tiles"][0] * kv.THREADS) * vec
        starts = starts[starts < 3 * height * width]
        return np.zeros_like(starts), starts
    per_row = kv.TILE_COLS // vec
    bx, by, v = np.meshgrid(np.arange(plan["tiles"][0]), np.arange(plan["tiles"][1]),
                            np.arange(per_row * tile_rows), indexing="ij")
    rows = np.minimum(tile_rows, height - by * tile_rows)
    y = by * tile_rows + v // per_row
    x = bx * kv.TILE_COLS + (v % per_row) * vec
    keep = (v < per_row * rows) & (x < width)
    return y[keep], x[keep]


def plan_coverage(plan) -> np.ndarray:
    """[3, height, width] int32: how many of the plan's vectors write each
    output value (a vector writes its pixels left of the width in each
    plane; noop's, left of the output's end)."""
    height, width = plan["shape"]
    rows, cols = (1, 3 * height * width) if plan["tile_rows"] is None else (height, width)
    y, x = _plan_vectors(plan)
    diff = np.zeros((rows, cols + 1), np.int32)
    np.add.at(diff, (y, x), 1)
    np.add.at(diff, (y, np.minimum(x + plan["vec"], cols)), -1)
    cover = np.cumsum(diff, axis=1)[:, :cols]
    return (cover.reshape(3, height, width) if plan["tile_rows"] is None
            else np.broadcast_to(cover, (3, height, width)))


def interior_pixels(plan) -> np.ndarray:
    """[height, width] bool: the pixels of the vectors the kernel's
    demosaic takes without validity tests (y >= 1, y + 1 < height, x >= 1,
    x + vec < width for the vector at (y, x))."""
    height, width = plan["shape"]
    y, x = _plan_vectors(plan)
    keep = (y >= 1) & (y + 1 < height) & (x >= 1) & (x + plan["vec"] < width)
    diff = np.zeros((height, width + 1), np.int32)
    np.add.at(diff, (y[keep], x[keep]), 1)
    np.add.at(diff, (y[keep], np.minimum(x[keep] + plan["vec"], width)), -1)
    return np.cumsum(diff, axis=1)[:, :width] > 0


def _plan(size, variant, form, out_dtype, plane_dtype=torch.uint16, **kw):
    return kv.variant_plan(size[0], size[1], variant, form, plane_dtype, out_dtype, **kw)


def _id(g):
    return f"{g[0]}_{g[1]}_{str(g[2]).split('.')[-1]}"


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=_id)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plan_covers_every_pixel_once(size, geometry):
    cover = plan_coverage(_plan(size, *geometry))
    assert cover.shape == (3, *size)
    assert (cover == 1).all(), np.argwhere(cover != 1)[:5]


@pytest.mark.parametrize("geometry", [GEOMETRIES[0], GEOMETRIES[1], GEOMETRIES[5],
                                      GEOMETRIES[6]], ids=_id)
def test_plan_covers_24_mp_once(geometry):
    """6000 x 4000, the size the ladder is timed at."""
    assert (plan_coverage(_plan((4000, 6000), *geometry)) == 1).all()


@pytest.mark.parametrize("tile_rows", [1, 5, 16, 64, 254])
def test_plan_covers_every_pixel_at_any_tile_height(tile_rows):
    plan = _plan((301, 257), "levels", "B", torch.uint8, tile_rows=tile_rows)
    assert plan["tiles"] == (3, -(-301 // tile_rows))
    assert (plan_coverage(plan) == 1).all()


@pytest.mark.parametrize("tile_rows", [0, 255])
def test_plan_refuses_tile_heights_the_tma_box_cannot_hold(tile_rows):
    with pytest.raises(ValueError, match="tile_rows"):
        _plan((64, 64), "levels", "B", torch.uint8, tile_rows=tile_rows)


@pytest.mark.parametrize("width", [1, 2, 4, 7, 8, 12, 16, 129, 130, 301, 500, 6000, 6001])
@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32], ids=["u16", "f32"])
def test_route_follows_the_row_stride(width, dtype):
    """TMA where each row starts on 16 bytes (u16: width % 8 == 0, f32:
    width % 4 == 0), vector loads otherwise, per plane type."""
    want = "tma" if width % (16 // dtype.itemsize) == 0 else "vector"
    assert kv.variant_route(width, dtype) == want
    assert _plan((3, width), "full", "B", torch.uint8, dtype)["route"] == want


@pytest.mark.parametrize("data_ptr", [2, 4, 8, 12, 48])
def test_route_follows_the_base_pointer(data_ptr):
    """A plane whose data does not start on 16 bytes loads by vector loads,
    whatever its width."""
    want = "tma" if data_ptr % 16 == 0 else "vector"
    assert kv.variant_route(6000, torch.uint16, data_ptr) == want
    assert kv.variant_route(6000, torch.float32, data_ptr) == want


def test_route_of_a_tensor_and_of_noop():
    plane = torch.zeros((4, 6000), dtype=torch.uint16)
    assert kv.variant_route(6000, plane.dtype, plane.data_ptr()) == "tma"
    assert kv.variant_route(6000, plane.dtype, plane[:, 1:].data_ptr()) == "vector"
    assert _plan((4, 6000), "noop", "B", torch.uint8)["route"] is None


@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("size", SIZES + [(4000, 6000)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_interior_pixels_have_all_eight_neighbours(size, out_dtype):
    height, width = size
    inside = interior_pixels(_plan(size, "full", "B", out_dtype))
    ys, xs = np.nonzero(inside)
    assert ((ys >= 1) & (ys <= height - 2) & (xs >= 1) & (xs <= width - 2)).all()
    if size == (4000, 6000):
        assert inside.mean() > 0.99        # the interior path is the main path


def _float_patterns(n=1 << 20, seed=0):
    """float32 values from random bit patterns, every sign and exponent,
    every 97th subnormal, and the edges (zeros, the smallest and largest
    normals and subnormals, infinities); NaN patterns left out."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    sub = np.arange(1, 1 << 23, 97, dtype=np.uint32)
    edges = np.array([0, 1, 0x007FFFFF, 0x00800000, 0x7F7FFFFF, 0x7F800000], np.uint32)
    bits = np.concatenate([bits, sub, edges])
    bits = np.concatenate([bits, bits | np.uint32(0x80000000)])
    f = bits.view(np.float32)
    return f[~np.isnan(f)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("count,factor", [(4, 0.25), (2, 0.5)])
def test_interior_average_is_the_division_bit_for_bit(count, factor):
    """s / 4 == s * 0.25 and s / 2 == s * 0.5 in IEEE float32, subnormals
    included: the interior path's products give the border path's (and the
    plain version's) quotients."""
    s = _float_patterns()
    with np.errstate(all="ignore"):
        assert np.array_equal(_bits(s / np.float32(count)), _bits(s * np.float32(factor)))
    t = torch.from_numpy(s)
    assert torch.equal((t / count).view(torch.int32), (t * factor).view(torch.int32))


def _quant(v):
    """The plain version's u8 quantize: trunc(clip(v * 256, 0, 255))."""
    return np.clip(v * np.float32(256.0), 0, 255).astype(np.int32)


@pytest.mark.parametrize("count,scaled", [(4, 64.0), (2, 128.0), (1, 256.0)])
def test_folded_quantize_scale_gives_the_same_bytes(count, scaled):
    """The demosaic rung quantizes s * 64 (s * 128, c * 256) where the plain
    version quantizes (s / 4) * 256 ((s / 2) * 256, c * 256): the same byte
    for every float32 s (they differ only where s / count is subnormal, far
    below one step of the output)."""
    s = _float_patterns(seed=1)
    with np.errstate(all="ignore"):
        assert np.array_equal(_quant((s / np.float32(count)).astype(np.float32)),
                              np.clip(s * np.float32(scaled), 0, 255).astype(np.int32))


def test_u16_samples_through_2_pow_23_are_exact():
    """The kernel turns a u16 sample v into float as (2^23 | v) - 2^23
    (two full-rate ALU operations): equal to float(v) for every v."""
    v = np.arange(1 << 16, dtype=np.uint32)
    f = (v | np.uint32(0x4B000000)).view(np.float32) - np.float32(2.0 ** 23)
    assert np.array_equal(f, v.astype(np.float32))


def test_quantize_floor_through_2_pow_23():
    """The u8 quantize takes floor(s) for s = clip(v * 256, 0, 255) from
    s + 2^23 rounded down (its low byte): that sum is exact in float64 and
    its floor is 2^23 + floor(s), so rounding down on the float32 grid of
    spacing 1 keeps floor(s) for every s in [0, 255]."""
    s = np.clip(_float_patterns(seed=2), 0, 255).astype(np.float32)
    rounded = np.floor(s.astype(np.float64) + 2.0 ** 23)
    assert np.array_equal(rounded.astype(np.float32).view(np.uint32) & 0xFF,
                          np.trunc(s).astype(np.uint32))
