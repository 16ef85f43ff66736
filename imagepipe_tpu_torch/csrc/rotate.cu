// Rotated (affine) resample for Hopper (sm_90a): the resampler behind
// rotatecrop, computing all C channels of an output pixel in one thread.
//
// Replaces the TPU kernel imagepipe_tpu/kernels/rotate_pallas.py::
// _rotate_kernel (:288), launched by _rotate_jit (:527 -> pallas_call :552)
// and planned by rotate_plan (:91). It computes the function of the JAX
// package's scaling._transform_impl (scaling.rs:51-130) for a planar
// float32 source [C, H, W], C <= 8, into [C, nh, nw]. Per output pixel
// (r, c):
//
//   from/to_y = sat(floor(rows[0/1][r] + cols[0/1][c]), H - 1)
//   from/to_x = sat(floor(rows[2/3][r] + cols[2/3][c]), W - 1)
//   cy, cx    = rows[4/5][r] + cols[4/5][c]
//   for ky < K_y, kx < K_x (ky outer):  y = from_y + ky, x = from_x + kx
//     w = ((1 - dx^2) - dy^2) clamped below at 0 (a NaN stays NaN),
//         dx = (x - cx) / sxx, dy = (y - cy) / syy, and 0 unless
//         y <= to_y and x <= to_x
//     sum[ch] += src[ch][min(y, H-1)][min(x, W-1)] * w;  count += w
//   out[ch] = count > 0 ? sum[ch] / count : 0
//
// sat() maps NaN to 0 and clips to [0, max], as Rust's saturating
// `floor() as usize` then min(). The row and column tables (6 x nh and
// 6 x nw floats) are the host's float32 values with two roundings
// (scaling.rotated_geometry); the device does one add of a row and a column
// term before each floor. K_x, K_y are _transform_impl's static bounds.
// Every operation is an explicit round-to-nearest intrinsic (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn) in the order above: nvcc contracts
// nothing, and both routes equal the plain PyTorch version
// (kernels/rotate.py) bit for bit.
//
// What bounds it: bytes. At 24 MP (6000 x 4000, C = 4) rotated 0.05 and
// cropped 0.05 it reads a 384 MB source once and writes a 427 MB output:
// 0.24 ms at 3.35 TB/s. The least work is about 3.7 valid samples of 11
// operations per pixel there, 0.02 ms at 67 TFLOP/s.
//
// Two routes, chosen on the host (kernels/rotate.py::rotate_tile_plan), and
// the CFA route in the same two forms:
//
// * staged (rotate_kernel_staged): a tile is kTileCols x tile_h output
//   pixels (32 columns here), walked by a block of 32 x 8 threads (a
//   column per lane in each group of 32, every 8th row per warp). Blocks
//   are persistent: one per free slot of the card, each
//   taking tiles blockIdx.x, + gridDim.x, ... in order, with two shared
//   memory buffers, so the copies of the next tile are in flight while the
//   block walks the current one. Per tile:
//   (a) The source box comes from the plan's band tables, the min and max
//       of rows[0..3] over the tile's band of rows and of cols[0..3] over
//       its band of columns, with the same single __fadd_rn and sat_idx as
//       the per-pixel indices. RN addition, floor and saturation are
//       monotone, so these are the exact min and max of from and to over
//       the tile's pixels (rotate_pallas.py:152-154 makes the same
//       argument). The box is [min from, min(max from + K - 1, H - 1 or
//       W - 1)] per axis: every sample the full walk reads, clamped ones
//       included.
//   (b) If max to < min from on either axis, every window of the tile is
//       empty: every weight is the select's +0, the count stays +0 and the
//       output is 0 whatever the source holds. The tile writes zeros and
//       stages nothing. (The `to` bands are built on c + 1, as the tables
//       are; rotate_pallas.py:353-358 records the bug that came from c.)
//   (c) The box's C planes, the tile's row terms and its column terms are
//       copied to shared memory with cp.async: 16 bytes a copy where the
//       source rows allow it (W % 4 == 0, a 16-byte aligned source; the
//       box then starts at a multiple of 4 columns), else 4. Each thread
//       checks the values it copied, and __syncthreads_or makes a
//       block-uniform flag: every staged source value is finite.
//   (d) With the flag, each pixel walks only ky < min(K_y, to_y - from_y +
//       1) and kx < min(K_x, to_x - from_x + 1), in the full walk's order;
//       every such sample is valid and inside the source, so this path
//       drops the validity select and the clamps. Without the flag, the
//       full K_y x K_x walk with both. Both read the box in shared memory.
//   (e) dy^2 is computed once per window row. Computing 1 - dx^2 once per
//       window column as well (kept per thread in shared memory) was
//       measured and lost at two of the three 24 MP geometries (PERF.md),
//       so dx is computed per sample, as the plain version does.
//   Why the tight walk is bit-equal to the full walk: a skipped sample lies
//   outside [from, to], so its weight is exactly +0 (the select); with a
//   finite source value its product is +0 or -0. Every sum and the count
//   start at +0, and in round-to-nearest x + y is -0 only when both are -0,
//   so a sum is never -0 and adding +-0 leaves it bit-unchanged. Every
//   sample inside the window is walked, weights of 0 or NaN included, in
//   the same order. Hence on finite boxes the tight walk equals the full
//   walk bit for bit; any other box takes the full walk through the flag.
// * direct (rotate_kernel_direct): one thread per output pixel reads its
//   full K_y x K_x window straight from device memory. The plan sends
//   here a geometry whose tables hold a non-finite value (an output 1
//   wide or high: inf * 0 gives NaN, and the min/max argument does not
//   hold) or whose staged block, two buffers of its largest box, would
//   exceed a block's shared memory (a deep rotated downscale).
// * cfa: the CFA-aware resample, the CFA mode of the JAX package's
//   scaling._transform_impl (:144-175; XLA there, no Pallas kernel). One
//   sensor plane [1, H, W] in, four colour planes [4, nh, nw] out, four sums
//   and four counts per pixel in registers; each sample's colour is the
//   CFA's pattern tile (raw.CFA.pattern_tile, nt x nt u8) at (min(y, H-1) %
//   nt, min(x, W-1) % nt), and the sample adds val * w to that colour's sum
//   and w to its count:
//     sum[c] += src[yc][xc] * w;  count[c] += w   (c the sample's colour)
//     out[c] = count[c] > 0 ? sum[c] / count[c] : 0
//   The plain version (scaling._transform_rotated with the CFA) adds
//   where(colour == c, val * w, +0) to every colour: a sum never becomes -0
//   (as argued above), so adding +0 to the other colours leaves them
//   bit-unchanged, and `if (colour == c)` adds only to its own. Two forms,
//   chosen on the host as the routes above (rotate_tile_plan(..., cfa=True)):
//   - staged (rotate_kernel_staged<1, true>): the staged route's machinery
//     with C = 1, (a)-(e) as above. (f) The pattern tile is staged in
//     shared memory once per block; a pixel's first pattern row and column
//     come from the box origin's, (y0 % nt + fy - y0) and (xa % nt + fx -
//     xa) less nt while not below it (fy - y0 and fx - xa are below the
//     box's size), then a running row and column phase. (g) Tiles are
//     kTileCols<true> = 96 columns wide (kernels/rotate.py CFA_TILE_COLS):
//     the output is [4, nh, nw] f32, and where nw is not a multiple of 8 a
//     row segment starts inside a 32-byte sector, which two blocks then
//     write in two parts (the stores alone ran at 0.86 TB/s at 5981 wide,
//     2.4 TB/s at 5984: PERF.md); a wider tile has fewer such edges.
//     Measured and lost at the 24 MP geometries (PERF.md): a box of colours
//     written beside each value box, an unrolled walk of windows up to 2 x
//     2, runs of 8 consecutive tiles per block, 32, 64 and 128 columns, and
//     whole-sector stores (each tile computing 8 columns more than it
//     stores: stores 2.3x faster, the walk's extra third slower than
//     that). The kernel asks for 3 blocks an SM (80 registers, no spills).
//     The tight walk is bit-equal to the full walk by the argument above,
//     per colour: a skipped sample lies outside the window, so its weight
//     is exactly +0 (the select); a finite value times +0 is +-0; every sum
//     and count starts at +0 and under round-to-nearest is never -0, so
//     adding +-0 to its colour's sum and +0 to its count leaves both
//     bit-unchanged, as the +0 the other colours get does. Any box with a
//     non-finite value takes the full walk through the flag, and there an
//     invalid sample adds val * +0 to its colour at the clamped index: a
//     NaN or +-Inf read there makes that colour's sum NaN, as in the plain
//     version. A pixel's bits do not depend on its tile: the walk's form
//     differs only by the flag, and both forms give the plain version's
//     bits. rotate_kernel_staged<1, true, true>, which treats every tile as
//     empty (it writes every output as zeros and stages and walks nothing),
//     is a probe of these stores alone for scripts/time_develop_kernels.py
//     (route 2 of rotate_cfa_launch); no path launches it.
//   - direct (rotate_kernel_cfa): a thread per output pixel walks the full
//     K_y x K_x window from device memory as the direct route does, the
//     pattern tile staged in shared memory per block and a running tile
//     column in place of a modulo; only the weight of an invalid sample, +0
//     whatever its factor, is not computed. For tables with a non-finite
//     value (an output 1 wide or high) or a staged block that would not fit.
//     (h) A pixel whose centre cy or cx is NaN writes zeros and walks
//     nothing. Every output 1 wide has cx NaN (cols[5] = sxx * 0 + sxx / 2,
//     sxx inf or NaN) and every output 1 high cy NaN (rows[4] likewise with
//     syy). Why zeros are its bits: then dy or dx is NaN at every sample, so
//     the factor (1 - dx^2) - dy^2 is NaN and stays NaN through the clamp
//     (NaN < 0 fails); a valid sample's weight is NaN and an invalid one's
//     the select's +0. Each colour's count is then +0 (only +0 added) or
//     NaN, `count > 0` fails for both, and the output is +0 whatever the
//     source holds, NaN and +-Inf included, as in the plain version.
//   What bounds it: bytes, a 96 MB plane read and a 427 MB output written
//   at 0.05 + crop 0.05 (0.156 ms at 3.35 TB/s).
//
// Not carried over from the Pallas kernel: the one-hot bf16 hi/mid/lo MXU
// selection (a TPU gather workaround), the 8/128-aligned DMA windows, the
// D_g/D_y bucketing for jit reuse, the lane-replicated row table and the
// TC = 64/128 cost model.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;      // output columns of a staged tile's column group: a warp
constexpr int kWarps = 8;       // warps per block: rows of a tile pass
constexpr int kThreads = kTileW * kWarps;
// Output columns per staged tile: 96 on the CFA route (kernels/rotate.py
// CFA_TILE_COLS), one column group on the per-channel route.
template <bool kCfa>
constexpr int kTileCols = kCfa ? 3 * kTileW : kTileW;
constexpr int kMaxSmem = 232448;
constexpr float kFltMax = 3.402823466e+38f;   // NaN and +-Inf fail |v| <= kFltMax
constexpr int kMaxPatternTile = 48;           // raw.PATTERN_TILE
constexpr int kCfaColours = 4;

struct RotateArgs {
  const float* src;       // [C, H, W]
  int height, width;      // source size
  const float* rows;      // [6, nh] row terms
  const float* cols;      // [6, nw] column terms
  int nh, nw;             // output size
  float sxx, syy;         // skips dividing dx and dy
  int k_x, k_y;           // window bounds
  // The staged route:
  const float* row_bands; // [8, nrb]: min of rows[0..3], then max, per band
  const float* col_bands; // [8, ncb]: the same over cols[0..3]
  int nrb, ncb;           // tile rows and columns
  int tile_h;             // output rows per tile (a multiple of 8)
  int box_floats;         // one box buffer: C planes of the largest box
  bool vec4;              // 16-byte copies: W % 4 == 0, src 16-byte aligned
  // The CFA route:
  const unsigned char* tile;  // [nt, nt] the pattern tile's colours
  int nt;
  float* out;             // [C, nh, nw]; [4, nh, nw] on the CFA route
};

__device__ __forceinline__ int sat_idx(float v, int maxv) {
  const float f = floorf(v);
  if (!(f >= 0.0f)) return 0;                 // NaN, negative
  return f >= static_cast<float>(maxv) ? maxv : static_cast<int>(f);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Output pixel (row, col): C planes from `sums` over one count, or on the
// CFA route (kCfa) four planes, each its colour's sum over its count.
template <int C, bool kCfa>
__device__ __forceinline__ void store_pixel(const RotateArgs& a, int row, int col,
                                            const float* sums, const float* counts) {
  float* const out = a.out + static_cast<long long>(row) * a.nw + col;
  const long long out_plane = static_cast<long long>(a.nh) * a.nw;
  if (kCfa) {
#pragma unroll
    for (int c = 0; c < kCfaColours; ++c) {
      out[c * out_plane] = counts[c] > 0.0f ? __fdiv_rn(sums[c], counts[c]) : 0.0f;
    }
  } else if (counts[0] > 0.0f) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[ch * out_plane] = __fdiv_rn(sums[ch], counts[0]);
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[ch * out_plane] = 0.0f;
  }
}

// One sample of value `v` (at the source index whose colour is `colour` on
// the CFA route) with weight w into the sums and counts.
template <int C, bool kCfa>
__device__ __forceinline__ void accumulate(float* sums, float* counts, const float* v,
                                           long long plane, int colour, float w) {
  if (kCfa) {
    const float val = __fmul_rn(*v, w);
#pragma unroll
    for (int c = 0; c < kCfaColours; ++c) {
      if (colour == c) {
        sums[c] = __fadd_rn(sums[c], val);
        counts[c] = __fadd_rn(counts[c], w);
      }
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) sums[ch] = __fadd_rn(sums[ch], __fmul_rn(v[ch * plane], w));
    counts[0] = __fadd_rn(counts[0], w);
  }
}

// Output pixel (row, col)'s window and centre from the global tables.
struct Window {
  int fy, ty, fx, tx;
  float cy, cx;
};

__device__ __forceinline__ Window window_at(const RotateArgs& a, int row, int col) {
  const float* __restrict__ rows = a.rows;
  const float* __restrict__ cols = a.cols;
  const int nh = a.nh, nw = a.nw;
  Window v;
  v.fy = sat_idx(__fadd_rn(rows[0 * nh + row], cols[0 * nw + col]), a.height - 1);
  v.ty = sat_idx(__fadd_rn(rows[1 * nh + row], cols[1 * nw + col]), a.height - 1);
  v.fx = sat_idx(__fadd_rn(rows[2 * nh + row], cols[2 * nw + col]), a.width - 1);
  v.tx = sat_idx(__fadd_rn(rows[3 * nh + row], cols[3 * nw + col]), a.width - 1);
  v.cy = __fadd_rn(rows[4 * nh + row], cols[4 * nw + col]);
  v.cx = __fadd_rn(rows[5 * nh + row], cols[5 * nw + col]);
  return v;
}

template <int C>
__global__ void __launch_bounds__(256) rotate_kernel_direct(const RotateArgs a) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= a.nw || row >= a.nh) return;

  const Window v = window_at(a, row, col);
  const int fy = v.fy, ty = v.ty, fx = v.fx, tx = v.tx;
  const float cy = v.cy, cx = v.cx;

  const long long plane = static_cast<long long>(a.height) * a.width;
  const float* __restrict__ src = a.src;
  float sums[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) sums[ch] = 0.0f;
  float count = 0.0f;

  for (int ky = 0; ky < a.k_y; ++ky) {
    const int y = fy + ky;
    const bool valid_y = y <= ty;
    const int yc = min(y, a.height - 1);
    const float dy = __fdiv_rn(__fsub_rn(static_cast<float>(y), cy), a.syy);
    const float dy2 = __fmul_rn(dy, dy);
    const float* __restrict__ srow = src + static_cast<long long>(yc) * a.width;
    for (int kx = 0; kx < a.k_x; ++kx) {
      const int x = fx + kx;
      const int xc = min(x, a.width - 1);
      const float dx = __fdiv_rn(__fsub_rn(static_cast<float>(x), cx), a.sxx);
      float w = __fsub_rn(__fsub_rn(1.0f, __fmul_rn(dx, dx)), dy2);
      w = w < 0.0f ? 0.0f : w;
      w = (valid_y && x <= tx) ? w : 0.0f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        sums[ch] = __fadd_rn(sums[ch], __fmul_rn(srow[ch * plane + xc], w));
      }
      count = __fadd_rn(count, w);
    }
  }
  store_pixel<C, false>(a, row, col, sums, &count);
}

// The CFA route's direct form: a.src is one sensor plane, a.out four
// colour planes; the pattern tile is staged in shared memory per block.
__global__ void __launch_bounds__(256) rotate_kernel_cfa(const RotateArgs a) {
  __shared__ unsigned char tile_s[kMaxPatternTile * kMaxPatternTile];
  const int nt = a.nt;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < nt * nt; i += blockDim.x * blockDim.y) tile_s[i] = a.tile[i];
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= a.nw || row >= a.nh) return;

  const Window v = window_at(a, row, col);
  float sums[kCfaColours], counts[kCfaColours];
#pragma unroll
  for (int c = 0; c < kCfaColours; ++c) sums[c] = counts[c] = 0.0f;
  const float* __restrict__ src = a.src;
  // The tile column of the window's first sample and of the last source
  // column, where min(x, W - 1) clamps.
  const int xm0 = v.fx % nt, xm_clamped = (a.width - 1) % nt;
  // (h): with a NaN centre every count ends +0 or NaN; walk nothing.
  const int ny = isnan(v.cy) || isnan(v.cx) ? 0 : a.k_y;

  for (int ky = 0; ky < ny; ++ky) {
    const int y = v.fy + ky;
    const bool valid_y = y <= v.ty;
    const int yc = min(y, a.height - 1);
    const float dy = __fdiv_rn(__fsub_rn(static_cast<float>(y), v.cy), a.syy);
    const float dy2 = __fmul_rn(dy, dy);
    const float* __restrict__ srow = src + static_cast<long long>(yc) * a.width;
    const unsigned char* trow = tile_s + (yc % nt) * nt;
    int xm = xm0;                           // x % nt, kept without a division
    for (int kx = 0; kx < a.k_x; ++kx) {
      const int x = v.fx + kx;
      const bool clamped = x > a.width - 1;
      const int xc = clamped ? a.width - 1 : x;
      // An invalid sample's weight is the select's +0 whatever its factor
      // would be, so the factor is computed for valid samples only.
      float w = 0.0f;
      if (valid_y && x <= v.tx) {
        const float dx = __fdiv_rn(__fsub_rn(static_cast<float>(x), v.cx), a.sxx);
        w = __fsub_rn(__fsub_rn(1.0f, __fmul_rn(dx, dx)), dy2);
        w = w < 0.0f ? 0.0f : w;
      }
      const int colour = trow[clamped ? xm_clamped : xm];
      xm = xm + 1 == nt ? 0 : xm + 1;
      accumulate<1, true>(sums, counts, srow + xc, 0, colour, w);
    }
  }
  store_pixel<1, true>(a, row, col, sums, counts);
}

// A staged tile: its first output row and column and its source box (origin
// y0, xa; bh rows of bw floats, bw a multiple of 4 with 16-byte copies,
// whose origin xa is then the least from_x rounded down to a multiple of 4).
struct Tile {
  int row0, col0;
  int y0, xa, bh, bw;
  bool empty;
};

// (a), (b): tile t's box from the band tables, and whether every window of
// the tile is empty (every tile with kStoresOnly, the stores probe).
template <bool kCfa, bool kStoresOnly>
__device__ __forceinline__ Tile tile_at(const RotateArgs& a, int t) {
  const int tr = t / a.ncb, tc = t - tr * a.ncb;
  const int nrb = a.nrb, ncb = a.ncb;
  const float* __restrict__ rb = a.row_bands;
  const float* __restrict__ cb = a.col_bands;
  const int hmax = a.height - 1, wmax = a.width - 1;
  const int y0 = sat_idx(__fadd_rn(rb[0 * nrb + tr], cb[0 * ncb + tc]), hmax);
  const int fy_hi = sat_idx(__fadd_rn(rb[4 * nrb + tr], cb[4 * ncb + tc]), hmax);
  const int ty_hi = sat_idx(__fadd_rn(rb[5 * nrb + tr], cb[5 * ncb + tc]), hmax);
  const int x0 = sat_idx(__fadd_rn(rb[2 * nrb + tr], cb[2 * ncb + tc]), wmax);
  const int fx_hi = sat_idx(__fadd_rn(rb[6 * nrb + tr], cb[6 * ncb + tc]), wmax);
  const int tx_hi = sat_idx(__fadd_rn(rb[7 * nrb + tr], cb[7 * ncb + tc]), wmax);
  Tile b;
  b.row0 = tr * a.tile_h;
  b.col0 = tc * kTileCols<kCfa>;
  b.empty = kStoresOnly || ty_hi < y0 || tx_hi < x0;
  const int y1 = min(fy_hi + a.k_y - 1, hmax), x1 = min(fx_hi + a.k_x - 1, wmax);
  b.y0 = y0;
  b.bh = y1 - y0 + 1;
  b.xa = a.vec4 ? (x0 & ~3) : x0;
  b.bw = a.vec4 ? ((x1 + 4 - b.xa) & ~3) : x1 + 1 - x0;
  return b;
}

// The copies of one tile, split over the block: a warp takes rpw box rows
// at a time (as many as fit its lanes), a lane one unit of 4 floats (1
// without vec4) of a row. `fn(smem, gmem)` is called for each unit.
template <int C, typename Fn>
__device__ __forceinline__ void for_units(const RotateArgs& a, const Tile& b, float* box,
                                          Fn fn) {
  const int unit = a.vec4 ? 4 : 1;
  const int nu = b.bw / unit;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int rpw = nu <= kTileW ? kTileW / nu : 1;
  const int lr = nu <= kTileW ? lane / nu : 0;
  const int lu = lane - lr * (nu <= kTileW ? nu : 0);
  if (lr >= rpw) return;
  const int ustep = nu <= kTileW ? nu : kTileW;
  const long long plane = static_cast<long long>(a.height) * a.width;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float* g = a.src + ch * plane + static_cast<long long>(b.y0) * a.width + b.xa;
    float* s = box + ch * b.bh * b.bw;
    for (int yy = warp * rpw + lr; yy < b.bh; yy += kWarps * rpw) {
      for (int u = lu; u < nu; u += ustep) {
        fn(s + yy * b.bw + u * unit, g + static_cast<long long>(yy) * a.width + u * unit);
      }
    }
  }
}

// (c) Start the copies of tile b into one buffer: its row terms [6,
// tile_h], column terms [6, kTileCols] and box [C, bh, bw].
template <int C, bool kCfa>
__device__ __forceinline__ void stage(const RotateArgs& a, const Tile& b, float* rows_s,
                                      float* cols_s, float* box) {
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int ncols = kTileCols<kCfa>;
  const int rows_here = min(a.tile_h, a.nh - b.row0);
  for (int i = tid; i < 6 * a.tile_h; i += kThreads) {
    const int q = i / a.tile_h, r = i - q * a.tile_h;
    if (r < rows_here) cp_async4(rows_s + i, a.rows + q * a.nh + b.row0 + r);
  }
  for (int i = tid; i < 6 * ncols; i += kThreads) {
    const int q = i / ncols, col = b.col0 + i - q * ncols;
    if (col < a.nw) cp_async4(cols_s + i, a.cols + q * a.nw + col);
  }
  if (a.vec4) {
    for_units<C>(a, b, box, [](float* s, const float* g) { cp_async16(s, g); });
  } else {
    for_units<C>(a, b, box, [](float* s, const float* g) { cp_async4(s, g); });
  }
}

// (d), (e): one pixel's walk from the staged box. kTight: only the valid
// window (every sample of it has y <= to_y and x <= to_x, inside the
// source); else the full K_y x K_x walk with the validity select and the
// clamps of the plain version. dy^2 once per window row; dx per sample.
// kCfa: one source plane, each sample counted in its colour of `pattern`
// (f).
template <int C, bool kTight, bool kCfa>
__device__ __forceinline__ void walk_pixel(const RotateArgs& a, const Tile& b, const float* box,
                                           const unsigned char* pattern, const float* rterm,
                                           int rstride, const float* cterm, int row, int col) {
  const int hmax = a.height - 1, wmax = a.width - 1;
  const int fy = sat_idx(__fadd_rn(rterm[0 * rstride], cterm[0]), hmax);
  const int ty = sat_idx(__fadd_rn(rterm[1 * rstride], cterm[1]), hmax);
  const int fx = sat_idx(__fadd_rn(rterm[2 * rstride], cterm[2]), wmax);
  const int tx = sat_idx(__fadd_rn(rterm[3 * rstride], cterm[3]), wmax);
  const float cy = __fadd_rn(rterm[4 * rstride], cterm[4]);
  const float cx = __fadd_rn(rterm[5 * rstride], cterm[5]);
  const int ny = kTight ? min(a.k_y, ty - fy + 1) : a.k_y;
  const int nx = kTight ? min(a.k_x, tx - fx + 1) : a.k_x;

  const int box_plane = b.bh * b.bw;
  // (f) The pattern row and column of the window's first sample, from the
  // box origin's: y - y0 and x - xa are below the box's size.
  const int nt = a.nt;
  int ym = 0, xm0 = 0;
  if (kCfa) {
    ym = b.y0 % nt + (fy - b.y0);
    while (ym >= nt) ym -= nt;
    xm0 = b.xa % nt + (fx - b.xa);
    while (xm0 >= nt) xm0 -= nt;
  }
  constexpr int kSums = kCfa ? kCfaColours : C, kCounts = kCfa ? kCfaColours : 1;
  float sums[kSums], counts[kCounts];
#pragma unroll
  for (int q = 0; q < kSums; ++q) sums[q] = 0.0f;
#pragma unroll
  for (int q = 0; q < kCounts; ++q) counts[q] = 0.0f;
  for (int ky = 0; ky < ny; ++ky) {
    const int y = fy + ky;
    const float dy = __fdiv_rn(__fsub_rn(static_cast<float>(y), cy), a.syy);
    const float dy2 = __fmul_rn(dy, dy);
    const int srow = ((kTight ? y : min(y, hmax)) - b.y0) * b.bw - b.xa;
    const unsigned char* trow = pattern;
    if (kCfa) trow += (kTight ? ym : min(y, hmax) % nt) * nt;
    int xm = xm0;                           // x % nt in the tight walk
    for (int kx = 0; kx < nx; ++kx) {
      const int x = fx + kx;
      const float dx = __fdiv_rn(__fsub_rn(static_cast<float>(x), cx), a.sxx);
      float w = __fsub_rn(__fsub_rn(1.0f, __fmul_rn(dx, dx)), dy2);
      w = w < 0.0f ? 0.0f : w;
      if (!kTight) w = (y <= ty && x <= tx) ? w : 0.0f;
      const int si = srow + (kTight ? x : min(x, wmax));
      int colour = 0;
      if (kCfa) {
        colour = kTight ? trow[xm] : trow[min(x, wmax) % nt];
        xm = xm + 1 == nt ? 0 : xm + 1;
      }
      accumulate<C, kCfa>(sums, counts, box + si, box_plane, colour, w);
    }
    if (kCfa) ym = ym + 1 == nt ? 0 : ym + 1;
  }
  store_pixel<C, kCfa>(a, row, col, sums, counts);
}

// Persistent blocks, each taking tiles blockIdx.x, + gridDim.x, ... in
// order, two buffers: the copies of the next tile are in flight while the
// block walks the current one. Blocks an SM asked of ptxas (PERF.md): on
// the CFA route 3 (80 registers; unbounded it chose 64 and spilled), on
// the per-channel route 4 (64 registers, as before the CFA route shared
// this code; unbounded it now chooses 91-93 and runs 2 blocks an SM).
// kStoresOnly: the stores probe (CFA route (g)).
template <int C, bool kCfa, bool kStoresOnly = false>
__global__ void __launch_bounds__(256, kCfa ? 3 : 4) rotate_kernel_staged(const RotateArgs a) {
  // Shared memory: per buffer the tile's row terms [6, tile_h] and column
  // terms [6, kTileCols]; then per buffer a box [C, bh, bw] of at most box_floats;
  // on the CFA route then the pattern tile [nt, nt].
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x, warp = threadIdx.y;
  float* const terms = smem;
  constexpr int ncols = kTileCols<kCfa>;
  const int terms_floats = 6 * a.tile_h + 6 * ncols;
  float* const boxes = terms + 2 * terms_floats;
  unsigned char* const pattern = reinterpret_cast<unsigned char*>(boxes + 2 * a.box_floats);
  if (kCfa) {
    for (int i = warp * kTileW + lane; i < a.nt * a.nt; i += kThreads) pattern[i] = a.tile[i];
    __syncthreads();
  }
  const int ntiles = a.nrb * a.ncb;

  int t = blockIdx.x;
  Tile cur = tile_at<kCfa, kStoresOnly>(a, t);
  if (!cur.empty) stage<C, kCfa>(a, cur, terms, terms + 6 * a.tile_h, boxes);
  cp_async_commit();
  for (int buf = 0; t < ntiles; t += gridDim.x, buf ^= 1) {
    Tile next = cur;
    const int tn = t + gridDim.x;
    if (tn < ntiles) {
      next = tile_at<kCfa, kStoresOnly>(a, tn);
      float* nterms = terms + (buf ^ 1) * terms_floats;
      if (!next.empty) stage<C, kCfa>(a, next, nterms, nterms + 6 * a.tile_h,
                                      boxes + (buf ^ 1) * a.box_floats);
    }
    cp_async_commit();
    cp_async_wait_one();

    // (c) This thread's copies of the current box are in; the flag makes
    // them everyone's.
    float* const box = boxes + buf * a.box_floats;
    int bad = 0;
    if (!cur.empty) {
      if (static_cast<long long>(C) * cur.bh * cur.bw > a.box_floats) __trap();
      if (a.vec4) {
        for_units<C>(a, cur, box, [&bad](float* s, const float*) {
          const float4 v = *reinterpret_cast<const float4*>(s);
          bad |= !(fabsf(v.x) <= kFltMax && fabsf(v.y) <= kFltMax && fabsf(v.z) <= kFltMax &&
                   fabsf(v.w) <= kFltMax);
        });
      } else {
        for_units<C>(a, cur, box, [&bad](float* s, const float*) {
          bad |= !(fabsf(*s) <= kFltMax);
        });
      }
    }
    const bool finite = !__syncthreads_or(bad);

    const int rows_here = min(a.tile_h, a.nh - cur.row0);
    const float* rterm = terms + buf * terms_floats;
    for (int c0 = 0; c0 < ncols; c0 += kTileW) {            // a group of 32 columns
      const int col = cur.col0 + c0 + lane;
      if (col >= a.nw) break;
      const float* cterm_s = rterm + 6 * a.tile_h + c0 + lane;
      float cterm[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) cterm[q] = cterm_s[q * ncols];
      for (int r = warp; r < rows_here; r += kWarps) {
        if (cur.empty) {
          const float zeros[kCfa ? kCfaColours : C] = {};
          store_pixel<C, kCfa>(a, cur.row0 + r, col, zeros, zeros);
        } else if (finite) {
          walk_pixel<C, true, kCfa>(a, cur, box, pattern, rterm + r, a.tile_h, cterm,
                                    cur.row0 + r, col);
        } else {
          walk_pixel<C, false, kCfa>(a, cur, box, pattern, rterm + r, a.tile_h, cterm,
                                     cur.row0 + r, col);
        }
      }
    }
    __syncthreads();                 // the buffer is read: free to refill
    cur = next;
  }
}

// The staged route's dynamic shared memory (see rotate_kernel_staged).
template <bool kCfa>
int staged_smem(const RotateArgs& a) {
  const int floats = 2 * (6 * a.tile_h + 6 * kTileCols<kCfa>) + 2 * a.box_floats;
  return static_cast<int>(sizeof(float)) * floats + (kCfa ? a.nt * a.nt : 0);
}

template <int C, bool kCfa, bool kStoresOnly = false>
cudaError_t launch(const RotateArgs& a, bool staged, cudaStream_t stream) {
  if (!staged) {
    const dim3 block(32, 8);
    const dim3 grid((a.nw + block.x - 1) / block.x, (a.nh + block.y - 1) / block.y);
    if (kCfa) {
      rotate_kernel_cfa<<<grid, block, 0, stream>>>(a);
    } else {
      rotate_kernel_direct<C><<<grid, block, 0, stream>>>(a);
    }
    return cudaGetLastError();
  }
  const int smem = staged_smem<kCfa>(a);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(rotate_kernel_staged<C, kCfa, kStoresOnly>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                    rotate_kernel_staged<C, kCfa, kStoresOnly>,
                                                    kThreads, smem);
  if (e != cudaSuccess) return e;
  const int ntiles = a.nrb * a.ncb;
  const int blocks = min(ntiles, sms * max(per_sm, 1));
  rotate_kernel_staged<C, kCfa, kStoresOnly><<<blocks, dim3(kTileW, kWarps), smem, stream>>>(a);
  return cudaGetLastError();
}

// The arguments both entries share (kCfa: the CFA route's), and whether
// they are what the kernel takes (0) or a cudaError_t.
template <bool kCfa>
int make_args(RotateArgs& a, const float* src, int height, int width, const float* rows,
              const float* cols, int nh, int nw, float sxx, float syy, int k_x, int k_y,
              int staged, const float* row_bands, const float* col_bands, int tile_h,
              int box_floats, int vec4, float* out) {
  a = RotateArgs{};
  a.src = src;
  a.height = height;
  a.width = width;
  a.rows = rows;
  a.cols = cols;
  a.nh = nh;
  a.nw = nw;
  a.sxx = sxx;
  a.syy = syy;
  a.k_x = k_x;
  a.k_y = k_y;
  a.row_bands = row_bands;
  a.col_bands = col_bands;
  a.tile_h = tile_h;
  a.nrb = tile_h > 0 ? (nh + tile_h - 1) / tile_h : 0;
  a.ncb = (nw + kTileCols<kCfa> - 1) / kTileCols<kCfa>;
  a.box_floats = box_floats;
  a.vec4 = vec4 != 0;
  a.out = out;
  if (nh <= 0 || nw <= 0 || height <= 0 || width <= 0 || k_x <= 0 || k_y <= 0 ||
      (nh + 7) / 8 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (staged && (row_bands == nullptr || col_bands == nullptr || tile_h <= 0 ||
                 tile_h % kWarps != 0 || box_floats <= 0 ||
                 box_floats % 4 != 0 ||
                 (a.vec4 && (width % 4 != 0 || reinterpret_cast<size_t>(src) % 16 != 0)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// C entry point for ctypes: resample src [components, height, width] f32
// into out [components, nh, nw] f32 with the row tables rows [6, nh] and
// column tables cols [6, nw] (scaling.rotated_geometry), skips sxx, syy and
// window bounds k_x, k_y. staged = 0 takes the direct route; staged = 1 the
// staged route with tiles of 32 x tile_h output pixels, the band tables
// row_bands [8, ceil(nh / tile_h)] and col_bands [8, ceil(nw / 32)], box
// buffers of box_floats floats, and 16-byte copies if vec4 (width a
// multiple of 4 and src 16-byte aligned) (kernels/rotate.py::
// rotate_tile_plan). Returns the cudaError_t of the launch (0 = success).
extern "C" int rotate_resample_launch(
    const float* src, int components, int height, int width, const float* rows,
    const float* cols, int nh, int nw, float sxx, float syy, int k_x, int k_y, int staged,
    const float* row_bands, const float* col_bands, int tile_h, int box_floats, int vec4,
    float* out, void* stream) {
  RotateArgs a;
  const int rc = make_args<false>(a, src, height, width, rows, cols, nh, nw, sxx, syy, k_x, k_y,
                                  staged, row_bands, col_bands, tile_h, box_floats, vec4, out);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = staged != 0;
  switch (components) {
    case 1: return static_cast<int>(launch<1, false>(a, st, s));
    case 2: return static_cast<int>(launch<2, false>(a, st, s));
    case 3: return static_cast<int>(launch<3, false>(a, st, s));
    case 4: return static_cast<int>(launch<4, false>(a, st, s));
    case 5: return static_cast<int>(launch<5, false>(a, st, s));
    case 6: return static_cast<int>(launch<6, false>(a, st, s));
    case 7: return static_cast<int>(launch<7, false>(a, st, s));
    case 8: return static_cast<int>(launch<8, false>(a, st, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C entry point for ctypes: the CFA-aware resample of one sensor plane src
// [1, height, width] f32 into out [4, nh, nw] f32, with the tables and
// staged-route arguments of rotate_resample_launch (kernels/rotate.py::
// rotate_tile_plan with cfa=True; col_bands has ceil(nw / 96) bands) and
// the pattern tile tile [nt, nt] u8 (colours 0..3). route 0 is the direct
// form, 1 the staged form, 2 the staged form's stores probe (every output
// written as zeros, nothing staged or walked; for the timing script).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int rotate_cfa_launch(const float* src, int height, int width, const float* rows,
                                 const float* cols, int nh, int nw, float sxx, float syy,
                                 int k_x, int k_y, const unsigned char* tile, int nt, int route,
                                 const float* row_bands, const float* col_bands, int tile_h,
                                 int box_floats, int vec4, float* out, void* stream) {
  RotateArgs a;
  const int rc = make_args<true>(a, src, height, width, rows, cols, nh, nw, sxx, syy, k_x, k_y,
                                 route != 0, row_bands, col_bands, tile_h, box_floats, vec4,
                                 out);
  if (rc != 0) return rc;
  if (nt <= 0 || nt > kMaxPatternTile || tile == nullptr || route < 0 || route > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.tile = tile;
  a.nt = nt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) return static_cast<int>(launch<1, true, true>(a, true, s));
  return static_cast<int>(launch<1, true>(a, route == 1, s));
}
