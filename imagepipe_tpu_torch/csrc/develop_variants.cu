// The develop kernel's ablation ladder, designed for Hopper (sm_90a): each
// rung keeps a longer prefix of the full-size develop's work and writes
// three planes [3, H, W]. csrc/develop.cu splits its own time through its
// stage_limit cuts (finish.cuh::develop_rgb<k>); this ladder is the
// Hopper-native yardstick beside them: what a design made for this card
// reaches on the same work, rung by rung.
//
// Replaces the TPU kernels scripts/exp_kernel_variants.py::make_kernel
// (form A) and scripts/exp_kernel_variants3.py::make_kernel (form B, which
// adds float32 outputs and writes zeros in noop and dma_floor):
//   noop        stores only: 1, 2, 3 x (black > 0) (A), or zeros (B);
//   dma_floor   the tile's load, then the stores: 1, 2, 3 x c, c = the TPU
//               tile's first row's first 128 samples have one > 0 (A); or
//               every centre sample's integer & 0 (B);
//   levels      v = min((raw - black) / range, 1), quantized, in all three
//               planes;
//   demosaic    the closed-form RGGB 3x3 demosaic of the levels (neighbours
//               outside the image invalid, avg = s / c where c > 0, else 0),
//               quantized;
//   color_only  the colour back end on the centre sample (RGB = v, E = 0):
//               WB clipped at 1, 3x4 camera matrix, Lab, Lab^-1 with no tone
//               curve, XYZ->RGB, clip, sRGB gamma, quantize;
//   full        demosaic, then the back end.
// The quantize truncates: clip(v * 256, 0, 255) to u8, or kept as float32.
//
// What bounds each rung on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s
// float32). noop to demosaic: bytes, 2 B/px read from a u16 plane (4 from
// float32) and 3 B/px written for u8 (12 for float32): 0.0358 ms at 24 MP
// from u16 to u8, noop's writes alone 0.0215. color_only and full: the
// float32 operations (scripts/time_develop_kernels.py's OPS_*), 0.056-0.058
// ms at 24 MP to u8; in practice instruction issue, most of it the six
// accurate expf/logf of each pixel.
//
// The design, and what it does about each:
//  * Loads. A block computes one tile of 128 x R output pixels (R from the
//    host plan kernels/variants.py::variant_plan: 8, 16 or 32 rows by rung
//    and output type) from the raw samples of the tile and its halo staged
//    in shared memory: R + 2 rows of 144 u16 (136 float32) samples from
//    (x0 - 16 bytes, y0 - 1), so each thread's samples start on 16 bytes:
//    1.20x the tile's samples at R = 32, 1.27x at 16 (develop.cu's 10 x 130
//    staging: 1.27x). The halo is read from L2 (it is the neighbours'
//    tile), not from device memory; taller tiles, which would cut it, were
//    slower on every streaming rung (scripts/torch_kernel_variants.py
//    --tile-rows). Route "tma" (rows start on 16 bytes): one TMA copy of
//    the box (cp.async.bulk.tensor.2d), issued first thing by one thread,
//    zero-filled outside the image, completing an mbarrier; its tensor map
//    is encoded on the host per launch with the driver's encoder, found
//    through cudaGetDriverEntryPoint (no -lcuda); a wait that never ends
//    traps. Route "vector" (any other width or base): each row's
//    16-byte-aligned chunks by 16-byte loads, its ends by scalar loads,
//    zeros outside. The host picks the route from the shape and pointer
//    before the launch, and the entry point refuses a "tma" launch the
//    plane does not allow: no route falls back.
//  * Stores. A thread writes one 16-byte store per plane: 16 u8 pixels, or
//    4 float32 pixels, along a row; a warp's store covers whole 128-byte
//    lines (u8: 4 rows x 128 B; float32: 512 B of one row). Where the
//    output's rows do not start on 16 bytes, pixel by pixel. u8 values
//    leave the arithmetic as float bits (Quant) and are packed by PRMT:
//    no F2I/I2F, which run at an eighth of the FMA rate. noop fills the
//    output as one flat array (noop_kernel), as Tensor.zero_() does:
//    written as tiles of rows, the same stores ran well behind zero_().
//  * dma_floor form A: the block votes each TPU tile it overlaps once (a
//    warp reads the tile's first 128 first-row samples, __any_sync) into a
//    shared table while the TMA copy is in flight, and each pixel looks its
//    tile up there (develop.cu's geometry had every output row vote again).
//  * Demosaic: each staged sample is converted to its levels once, into a
//    shared tile whose rows are skewed by 16 bytes every 64 (lv_at), so
//    the 16-byte reads of 8 threads 64 bytes apart hit distinct banks. A
//    vector whose pixels have all eight neighbours in the image takes the
//    interior path: no validity tests, and the averages by 4 and 2 are
//    products by 0.25 and 0.5 (bit-equal to the IEEE divisions, subnormals
//    included), with the quantize's scale folded in (x 64, x 128); the
//    border keeps the tests and divides by the count. The sums keep the
//    experiment's order ((vu + vd) + vl) + vr.
//  * Back end (color_only, full): a thread's 16 (u8) or 4 (float32) pixels
//    in one loop that is not unrolled (one copy of the chain), each result
//    shifted into the 16-byte store's registers (no indexed arrays, so no
//    local memory).
//  * A block a tile, no persistent ring: a persistent grid walking the
//    tiles with a two-deep TMA ring (the next tile's copy in flight during
//    this one's work) was no faster on any rung at 24 MP on the H100 and
//    slower on most, the back end and the float32 stores above all: its
//    per-tile barriers wait for the slowest warp, where the resident
//    blocks of a block-a-tile grid overlap each other's copies anyway.
// dma_floor reads each staged centre sample back and ands it with `zero`, a
// launch argument that is 0: form B's value, as before.
//
// Numerics: finish.cuh's primitives where the function is theirs (levels
// through div_rcp, and divisions by constants through div_const, both equal
// to the IEEE division). Border averages divide by the count (IEEE).
// expf / logf, no fast math. For u8 outputs nvcc contracts a + b*c into
// FMA, as in develop.cu, and the plain PyTorch version does not: they agree
// within 1 LSB. For float32 outputs every product and sum of the back end is
// rounded on its own (Arith), so the kernel gives the plain version's
// float32 values bit for bit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "finish.cuh"

namespace {

enum Variant { kNoop, kDmaFloor, kLevels, kDemosaic, kColorOnly, kFull, kVariants };
enum Route { kRouteTma, kRouteVector };

constexpr int kThreads = 256;
constexpr int kTileW = 128;          // output columns of a block
constexpr int kMaxTileRows = 254;    // a TMA box is at most 256 rows
constexpr int kLvCols = 136;         // levels tile: columns x0 - 4 .. x0 + 131
constexpr int kLvLeft = 4;
constexpr int kLvPitch = 168;        // floats per levels row: 136 and the skew
constexpr int kFlagSamples = 128;    // dma_floor form A: samples of a tile's first row

// The raw tile of plane type T: its first column is x0 - kLeft (16 bytes
// before the block's), kWidth samples a row (the TMA box's width).
template <typename T>
struct RawTile {
  static constexpr int kLeft = 16 / static_cast<int>(sizeof(T));
  static constexpr int kWidth = kTileW + 2 * kLeft;
};

struct VariantArgs {
  CUtensorMap map;          // the plane's tensor map (route kRouteTma)
  const void* plane;        // [height, width], row-major
  int height, width;
  const float* scal;        // [8, 16]: black, range; WB; camera matrix; XYZ->RGB
  int tile_h, tile_w;       // dma_floor form A: the TPU tile
  int tile_rows;            // output rows of a tile
  int route;                // Route
  int vec_store;            // the output's rows start on 16 bytes
  int zero;                 // 0 (dma_floor)
  void* out;                // [3, height, width] u8 or f32
};

// The levels tile's float index of (row, col): 16 bytes of skew after each
// 64, so 16-byte reads 64 bytes apart fall in distinct banks.
__device__ __forceinline__ int lv_at(int row, int col) {
  return row * kLvPitch + col + ((col >> 4) << 2);
}

// A staged sample as a float. u16: 2^23 + v has v in its low mantissa bits,
// and subtracting 2^23 is exact, so two full-rate ALU operations replace the
// quarter-rate I2F.
__device__ __forceinline__ float sample(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4b000000u | v), 0x1p23f);
}
__device__ __forceinline__ float sample(uint16_t v) { return sample(static_cast<uint32_t>(v)); }
__device__ __forceinline__ float sample(float v) { return v; }

// -- TMA and the mbarrier ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copy the box at (x, y) of `map` into `dst`; `bytes` (the box's) complete
// the barrier's phase.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
        "r"(smem_addr(bar))
      : "memory");
}

// Wait for the barrier's first phase; a copy that never lands traps (~2 s)
// rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(0u) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// -- staging ------------------------------------------------------------------

// Route "vector": the raw tile of rows y0 - 1 .. y0 + rows - 2 from columns
// x0 - kLeft: per row, the 16-byte-aligned chunks inside the image by
// 16-byte loads, the ends by scalar loads, zeros outside the image. A row
// is kSegs items: the head, the whole chunks, the tail.
template <typename T>
__device__ void fill_tile(const VariantArgs& a, T* raw, int x0, int y0, int rows, int tid) {
  using R = RawTile<T>;
  constexpr int kV = R::kLeft;                     // samples per 16 bytes
  constexpr int kSegs = R::kWidth / kV + 2;
  const T* plane = static_cast<const T*>(a.plane);
  const int bx = x0 - kV;
  const int lo = max(bx, 0), hi = min(bx + R::kWidth, a.width);
  const long long base = static_cast<long long>(reinterpret_cast<uintptr_t>(plane) / sizeof(T));
  for (int item = tid; item < rows * kSegs; item += kThreads) {
    const int r = item / kSegs, k = item - r * kSegs;
    const int yy = y0 - 1 + r;
    T* dst = raw + r * R::kWidth;
    if (yy < 0 || yy >= a.height) {
      if (k < R::kWidth / kV) {
#pragma unroll
        for (int j = 0; j < kV; ++j) dst[k * kV + j] = T(0);
      }
      continue;
    }
    const long long row = static_cast<long long>(yy) * a.width;
    const T* src = plane + row;
    const int phase = static_cast<int>((base + row + lo) & (kV - 1));
    const int ca = min(lo + ((kV - phase) & (kV - 1)), hi);
    const int chunks = (hi - ca) / kV;
    const int cb = ca + chunks * kV;
    if (k == 0) {
      for (int c = bx; c < ca; ++c) dst[c - bx] = c >= lo ? src[c] : T(0);
    } else if (k == kSegs - 1) {
      for (int c = cb; c < bx + R::kWidth; ++c) dst[c - bx] = c < hi ? src[c] : T(0);
    } else if (k <= chunks) {
      const int c = ca + (k - 1) * kV;
      const uint4 w = *reinterpret_cast<const uint4*>(src + c);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      T* d = dst + (c - bx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (sizeof(T) == 2) {
          d[2 * j] = static_cast<T>(ws[j] & 0xffffu);
          d[2 * j + 1] = static_cast<T>(ws[j] >> 16);
        } else {
          d[j] = __uint_as_float(ws[j]);
        }
      }
    }
  }
}

// `n` staged samples from `p` as floats, by 16-byte (or 8-byte) loads.
template <int N>
__device__ __forceinline__ void load_vals(const uint16_t* p, float (&v)[N]) {
  static_assert(N % 4 == 0, "whole 8-byte groups");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[k];
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[8 * k + 2 * j] = sample(ws[j] & 0xffffu);
        v[8 * k + 2 * j + 1] = sample(ws[j] >> 16);
      }
    }
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = sample(w.x & 0xffffu);
    v[1] = sample(w.x >> 16);
    v[2] = sample(w.y & 0xffffu);
    v[3] = sample(w.y >> 16);
  }
}

template <int N>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[N]) {
  static_assert(N % 4 == 0, "whole 16-byte groups");
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 w = reinterpret_cast<const float4*>(p)[k];
    v[4 * k] = w.x;
    v[4 * k + 1] = w.y;
    v[4 * k + 2] = w.z;
    v[4 * k + 3] = w.w;
  }
}

// `n` staged samples from `p` as int32 (u16 as they are, float32
// truncated), by 16-byte (or 8-byte) loads.
template <int N>
__device__ __forceinline__ void load_ints(const uint16_t* p, int (&v)[N]) {
  static_assert(N % 4 == 0, "whole 8-byte groups");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[k];
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[8 * k + 2 * j] = static_cast<int>(ws[j] & 0xffffu);
        v[8 * k + 2 * j + 1] = static_cast<int>(ws[j] >> 16);
      }
    }
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = static_cast<int>(w.x & 0xffffu);
    v[1] = static_cast<int>(w.x >> 16);
    v[2] = static_cast<int>(w.y & 0xffffu);
    v[3] = static_cast<int>(w.y >> 16);
  }
}

template <int N>
__device__ __forceinline__ void load_ints(const float* p, int (&v)[N]) {
  float f[N];
  load_vals<N>(p, f);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __float2int_rz(f[i]);
}

// The levels tile from the raw tile, eight samples an item: lv column j is
// raw column j + kLeft - 4.
template <typename T>
__device__ void stage_levels(const VariantArgs& a, const T* raw, float* lv, int rows, int tid) {
  using R = RawTile<T>;
  constexpr int kItems = kLvCols / 8;
  const finish::Levels L = finish::make_levels(a.scal[0], a.scal[1]);
  for (int item = tid; item < rows * kItems; item += kThreads) {
    const int r = item / kItems, j = (item - r * kItems) * 8;
    const T* src = raw + r * R::kWidth + j + (R::kLeft - kLvLeft);
    float* dst = lv + lv_at(r, j);          // 8 floats: j and j + 4 share their skew
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float v[4];
      load_vals<4>(src + 4 * k, v);
      reinterpret_cast<float4*>(dst)[k] =
          make_float4(finish::levels(L, v[0]), finish::levels(L, v[1]), finish::levels(L, v[2]),
                      finish::levels(L, v[3]));
    }
  }
}

// dma_floor form A: for each TPU tile the block's rows [y0, y0 + rows) and
// columns overlap, whether its first row's first 128 samples (past the
// width, the padding's 0) hold one > 0 as an int32: a warp a tile, into
// `flag` [tile rows, nc]. Returns nc; tr0 and tc0 are the first tile's.
template <typename T>
__device__ int vote_flags(const VariantArgs& a, uint8_t* flag, int x0, int y0, int rows,
                          int tid, int& tr0, int& tc0) {
  tr0 = y0 / a.tile_h;
  tc0 = x0 / a.tile_w;
  const int nr = (y0 + rows - 1) / a.tile_h - tr0 + 1;
  const int nc = (min(x0 + kTileW, a.width) - 1) / a.tile_w - tc0 + 1;
  const T* plane = static_cast<const T*>(a.plane);
  const int warp = tid >> 5, lane = tid & 31;
  for (int p = warp; p < nr * nc; p += kThreads / 32) {
    const int tr = tr0 + p / nc, tc = tc0 + p % nc;
    const T* row = plane + static_cast<long long>(tr) * a.tile_h * a.width;
    const int col0 = tc * a.tile_w;
    bool pos = false;
#pragma unroll
    for (int k = 0; k < kFlagSamples / 32; ++k) {
      const int xx = col0 + lane * (kFlagSamples / 32) + k;
      if (xx < a.width) pos |= __float2int_rz(sample(row[xx])) > 0;
    }
    const bool any = __any_sync(0xffffffffu, pos);
    if (lane == 0) flag[p] = any ? 1 : 0;
  }
  return nc;
}

// -- the rungs' arithmetic -----------------------------------------------------

// Products and sums of the colour back end. kExact (float32 outputs):
// each one rounded on its own (__f*_rn, which nvcc never contracts), as the
// plain version's separate tensor ops round them, so the two agree bit for
// bit on the card. Else (u8 outputs) plain operators, which nvcc contracts
// into FMA as in develop.cu.
template <bool kExact>
struct Arith {
  static __device__ __forceinline__ float mul(float a, float b) {
    return kExact ? __fmul_rn(a, b) : a * b;
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return kExact ? __fadd_rn(a, b) : a + b;
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return kExact ? __fsub_rn(a, b) : a - b;
  }
};

// finish.cuh's lab_f and lab_inv, in Arith's products and sums.
template <bool kExact>
__device__ __forceinline__ float lab_f(float t) {
  using M = Arith<kExact>;
  if (t > finish::kLabE) return expf(M::mul(logf(fmaxf(t, 1e-30f)), finish::kThird));
  return finish::div_const<finish::kDiv116>(M::add(M::mul(finish::kLabK, t), 16.0f));
}

template <bool kExact>
__device__ __forceinline__ float lab_inv(float f) {
  using M = Arith<kExact>;
  const float f3 = M::mul(M::mul(f, f), f);
  if (f3 > finish::kLabE) return f3;
  return finish::div_const<finish::kDivLabK>(M::sub(M::mul(116.0f, f), 16.0f));
}

// The colour back end on one pixel's RGBE, in the order of the
// experiment's kernel (exp_kernel_variants.py:151-190), with the
// calibration `scal` [8, 16] in shared memory.
template <bool kExact>
__device__ __forceinline__ void variant_rgb(const float rgbe[4], const float* scal,
                                            float out[3]) {
  using namespace finish;      // lab_f and lab_inv below are this file's
  using M = Arith<kExact>;
  float wb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wb[c] = fminf(M::mul(rgbe[c], scal[16 + c]), 1.0f);
  float xyz[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = scal + 16 * (2 + r);
    float acc = M::mul(wb[0], m[0]);
    acc = M::add(acc, M::mul(wb[1], m[1]));
    acc = M::add(acc, M::mul(wb[2], m[2]));
    acc = M::add(acc, M::mul(wb[3], m[3]));
    xyz[r] = acc;
  }
  const float fx = lab_f<kExact>(div_const<kDivXW>(xyz[0]));
  const float fy = lab_f<kExact>(xyz[1] / kYW);
  const float fz = lab_f<kExact>(div_const<kDivZW>(xyz[2]));
  const float L = div_const<kDiv100>(M::sub(M::mul(116.0f, fy), 16.0f));
  const float A = div_const<kDiv255>(M::add(M::mul(500.0f, M::sub(fx, fy)), 127.0f));
  const float B = div_const<kDiv255>(M::add(M::mul(200.0f, M::sub(fy, fz)), 127.0f));

  const float cl = M::mul(L, 100.0f);
  const float ca = M::sub(M::mul(A, 255.0f), 127.0f);
  const float cb = M::sub(M::mul(B, 255.0f), 127.0f);
  const float fy2 = div_const<kDiv116>(M::add(cl, 16.0f));
  const float fx2 = M::add(div_const<kDiv500>(ca), fy2);
  const float fz2 = M::sub(fy2, div_const<kDiv200>(cb));
  const float x = M::mul(lab_inv<kExact>(fx2), kXW);
  const float yr = cl > kLabKE ? M::mul(M::mul(fy2, fy2), fy2) : div_const<kDivLabK>(cl);
  const float y = M::mul(yr, kYW);
  const float z = M::mul(lab_inv<kExact>(fz2), kZW);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = scal + 16 * (5 + r);
    float ch = M::add(M::add(M::mul(x, m[0]), M::mul(y, m[1])), M::mul(z, m[2]));
    ch = fminf(fmaxf(ch, 0.0f), 1.0f);
    if (ch < 0.0031308f) {
      ch = M::mul(ch, 12.92f);
    } else {
      ch = M::sub(M::mul(1.055f, expf(M::mul(logf(fmaxf(ch, 1e-30f)), kInvGamma))), 0.055f);
    }
    out[r] = ch;
  }
}

__device__ __forceinline__ float avg(float s, int c) {
  return c > 0 ? s / static_cast<float>(c) : 0.0f;
}

// Blocks an SM must hold, by rung: the demosaic 5 (48 registers a thread:
// faster than 67 at 3 blocks), the back end 4 (64: it spills at 48), the
// others 3.
template <int V>
constexpr int min_blocks() {
  return V == kDemosaic ? 5 : V == kColorOnly || V == kFull ? 4 : 3;
}

// The closed-form RGGB demosaic of one pixel from its 3x3 levels
// neighbourhood (u: the row above, m: its own, d: below; 0 left, 1 centre,
// 2 right): its own colour takes the centre, the other two average the
// neighbours in the experiment's order (plus, row, column or cross), E = 0.
// kInterior: all eight neighbours lie in the image, every count is 4 or 2
// and the average is the product by 0.25 or 0.5, which equals the IEEE
// quotient bit for bit; else the validity flags select and the count
// divides. kScale 256 returns each channel times 256 (the quantize's scale:
// exact, and folded into the interior's 0.25 and 0.5), else 1.
template <bool kInterior, int kScale>
__device__ __forceinline__ void demosaic_px(const float (&u)[3], const float (&m)[3],
                                            const float (&d)[3], bool up, bool down, bool left,
                                            bool right, bool even_row, bool even_col,
                                            float rgbe[4]) {
  constexpr float kS = static_cast<float>(kScale);
  const float c = kScale == 1 ? m[1] : m[1] * kS;
  rgbe[3] = 0.0f;
  if (even_row == even_col) {                    // R (even, even) or B (odd, odd)
    float e, x;
    if constexpr (kInterior) {
      e = (((u[1] + d[1]) + m[0]) + m[2]) * (0.25f * kS);
      x = (((u[0] + u[2]) + d[0]) + d[2]) * (0.25f * kS);
    } else {
      const float vu = up ? u[1] : 0.0f, vd = down ? d[1] : 0.0f;
      const float vl = left ? m[0] : 0.0f, vr = right ? m[2] : 0.0f;
      e = avg(((vu + vd) + vl) + vr, int(up) + int(down) + int(left) + int(right));
      x = avg((((up && left ? u[0] : 0.0f) + (up && right ? u[2] : 0.0f))
               + (down && left ? d[0] : 0.0f))
              + (down && right ? d[2] : 0.0f),
              int(up && left) + int(up && right) + int(down && left) + int(down && right));
      if constexpr (kScale != 1) {
        e *= kS;
        x *= kS;
      }
    }
    rgbe[0] = even_row ? c : x;
    rgbe[1] = e;
    rgbe[2] = even_row ? x : c;
  } else {                                       // G: R along its row on an R row
    float h, v;
    if constexpr (kInterior) {
      h = (m[0] + m[2]) * (0.5f * kS);
      v = (u[1] + d[1]) * (0.5f * kS);
    } else {
      h = avg((left ? m[0] : 0.0f) + (right ? m[2] : 0.0f), int(left) + int(right));
      v = avg((up ? u[1] : 0.0f) + (down ? d[1] : 0.0f), int(up) + int(down));
      if constexpr (kScale != 1) {
        h *= kS;
        v *= kS;
      }
    }
    rgbe[0] = even_row ? h : v;
    rgbe[1] = c;
    rgbe[2] = even_row ? v : h;
  }
}

// The truncating quantize, as the value a plane stores, from v or from s =
// v * 256 (scaled). u8: floor(clip(s, 0, 255)) in the low byte of the bits
// of clip(s, 0, 255) + 2^23 rounded down (one FADD where F2I runs at an
// eighth of the rate; the store takes that byte with PRMT), the truncation
// of finish::quantize for every float. float32: clip(s, 0, 255).
template <typename O>
struct Quant;
template <>
struct Quant<uint8_t> {
  static __device__ __forceinline__ uint32_t scaled(float s) {
    return __float_as_uint(__fadd_rd(fminf(fmaxf(s, 0.0f), 255.0f), 0x1p23f));
  }
  static __device__ __forceinline__ uint32_t of(float v) { return scaled(v * 256.0f); }
  static __device__ __forceinline__ uint32_t of_int(int k) { return static_cast<uint32_t>(k); }
};
template <>
struct Quant<float> {
  static __device__ __forceinline__ float scaled(float s) { return fminf(fmaxf(s, 0.0f), 255.0f); }
  static __device__ __forceinline__ float of(float v) { return scaled(v * 256.0f); }
  static __device__ __forceinline__ float of_int(int k) { return static_cast<float>(k); }
};

// One plane's 16 bytes of a thread's vector: 16 u8 or 4 float32 pixels,
// each given as its Quant value (u8: the low byte counts). set(i) takes a
// pixel by a constant index; push(i) appends pixel i in order, shifting the
// registers, for a loop that is not unrolled.
template <typename O>
struct Out16;

template <>
struct Out16<uint8_t> {
  static constexpr int kPix = 16;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  __device__ __forceinline__ void fill(uint32_t v) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = v * 0x01010101u;
  }
  __device__ __forceinline__ void set(int i, uint32_t v) {     // byte i & 3 <- v's low byte
    const int k = 4 * (i & 3);
    w[i >> 2] = __byte_perm(w[i >> 2], v, (0x3210u & ~(0xfu << k)) | (4u << k));
  }
  __device__ __forceinline__ void push(int i, uint32_t v) {
    w[3] = __byte_perm(w[3], v, 0x4321u);
    if ((i & 3) == 3 && i != kPix - 1) {
      w[0] = w[1];
      w[1] = w[2];
      w[2] = w[3];
    }
  }
  __device__ __forceinline__ uint4 bits() const { return make_uint4(w[0], w[1], w[2], w[3]); }
  __device__ __forceinline__ uint8_t at(int i) const {
    return static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
  }
};

template <>
struct Out16<float> {
  static constexpr int kPix = 4;
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  __device__ __forceinline__ void fill(float v) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = v;
  }
  __device__ __forceinline__ void set(int i, float v) { w[i] = v; }
  __device__ __forceinline__ void push(int, float v) {
    w[0] = w[1];
    w[1] = w[2];
    w[2] = w[3];
    w[3] = v;
  }
  __device__ __forceinline__ uint4 bits() const {
    return make_uint4(__float_as_uint(w[0]), __float_as_uint(w[1]), __float_as_uint(w[2]),
                      __float_as_uint(w[3]));
  }
  __device__ __forceinline__ float at(int i) const { return w[i]; }
};

// Row `t` of the levels tile at columns c + 3 .. c + 8 (c a multiple of
// 4): 4 pixels by one 16-byte read, their neighbours alone.
__device__ __forceinline__ void load_lv_row(const float* lv, int t, int c, float (&v)[6]) {
  v[0] = lv[lv_at(t, c + 3)];
  const float4 w = *reinterpret_cast<const float4*>(lv + lv_at(t, c + 4));
  v[1] = w.x;
  v[2] = w.y;
  v[3] = w.z;
  v[4] = w.w;
  v[5] = lv[lv_at(t, c + 8)];
}

// The store of one plane's vector at `dst` (pixel x of its row): 16 bytes
// where the row allows, else pixel by pixel inside the width.
template <typename O>
__device__ __forceinline__ void store(O* dst, const Out16<O>& q, bool whole, int left) {
  if (whole) {
    *reinterpret_cast<uint4*>(dst) = q.bits();
  } else {
#pragma unroll
    for (int i = 0; i < Out16<O>::kPix; ++i) {
      if (i < left) dst[i] = q.at(i);
    }
  }
}

// noop: the output [3, H, W] filled as one flat array, a 16-byte vector a
// thread, so a warp writes 512 contiguous bytes (the pattern of
// Tensor.zero_()); it stages nothing. A vector that holds the end of one
// plane and the start of the next stores pixel by pixel.
template <bool kFormA, typename O>
__global__ void __launch_bounds__(kThreads) noop_kernel(const VariantArgs a) {
  using Q = Quant<O>;
  constexpr int kVec = Out16<O>::kPix;
  const long long plane_px = static_cast<long long>(a.height) * a.width;
  const long long i0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i0 >= 3 * plane_px) return;
  const bool on = kFormA && a.scal[0] > 0.0f;
  const int p0 = static_cast<int>(i0 / plane_px);
  O* out = static_cast<O*>(a.out) + i0;
  if (a.vec_store && i0 + kVec <= (p0 + 1) * plane_px) {
    Out16<O> q;
    q.fill(Q::of_int(on ? p0 + 1 : 0));
    *reinterpret_cast<uint4*>(out) = q.bits();
  } else {
    for (int i = 0; i < kVec && i0 + i < 3 * plane_px; ++i) {
      out[i] = static_cast<O>(on ? (i0 + i) / plane_px + 1 : 0);
    }
  }
}

// A block computes one output tile: columns x0 .. x0 + 127 of rows y0 ..
// y0 + tile_rows - 1 (blockIdx.x, blockIdx.y), from its raw tile (route
// "tma": one TMA copy; "vector": fill_tile) and, for the demosaic, the
// levels tile.
template <int V, bool kFormA, typename T, typename O>
__global__ void __launch_bounds__(kThreads, min_blocks<V>())
    variant_kernel(const __grid_constant__ VariantArgs a) {
  using R = RawTile<T>;
  using Q = Quant<O>;
  constexpr int kVec = Out16<O>::kPix;
  constexpr int kVecsRow = kTileW / kVec;
  constexpr bool kLevelsTile = V == kDemosaic || V == kFull;
  constexpr bool kBackEnd = V == kColorOnly || V == kFull;
  static_assert(V != kNoop, "noop is noop_kernel");
  static_assert(V != kDemosaic || kVec == 16, "demosaic writes u8");
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ float s_scal[kBackEnd ? 128 : 1];
  extern __shared__ unsigned char s_dyn[];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * a.tile_rows;
  const int rows = min(a.tile_rows, a.height - y0);
  const int trows = a.tile_rows + 2;
  const int raw_bytes = trows * R::kWidth * static_cast<int>(sizeof(T));
  unsigned char* const base = s_dyn + ((128u - (smem_addr(s_dyn) & 127u)) & 127u);
  T* const raw = reinterpret_cast<T*>(base);
  float* const lv = reinterpret_cast<float*>(base + raw_bytes);
  uint8_t* const flag = base + raw_bytes
                        + (kLevelsTile ? trows * kLvPitch * static_cast<int>(sizeof(float)) : 0);
  const bool tma = a.route == kRouteTma;

  if (tma && tid == 0) {          // the copy first: the barrier is this thread's until the sync
    mbar_init(&s_bar);
    tma_load(raw, &a.map, &s_bar, x0 - R::kLeft, y0 - 1, static_cast<uint32_t>(raw_bytes));
  }
  if constexpr (kBackEnd) {
    for (int i = tid; i < 128; i += kThreads) s_scal[i] = a.scal[i];
  }
  if (!tma) fill_tile(a, raw, x0, y0, trows, tid);
  int tr0 = 0, tc0 = 0, nc = 1;
  if constexpr (V == kDmaFloor && kFormA) {
    nc = vote_flags<T>(a, flag, x0, y0, rows, tid, tr0, tc0);
  }
  __syncthreads();                // the barrier's init, fill_tile, the flags, s_scal
  if (tma) mbar_wait(&s_bar);
  if constexpr (kLevelsTile) {
    stage_levels(a, raw, lv, trows, tid);
    __syncthreads();
  }

  const finish::Levels L = finish::make_levels(a.scal[0], a.scal[1]);
  const long long plane_px = static_cast<long long>(a.height) * a.width;
  O* out = static_cast<O*>(a.out);
  for (int v = tid; v < kVecsRow * rows; v += kThreads) {
    const int r = v / kVecsRow;
    const int c = (v % kVecsRow) * kVec;
    const int y = y0 + r, x = x0 + c;
    if (x >= a.width) continue;
    const bool interior = y >= 1 && y + 1 < a.height && x >= 1 && x + kVec < a.width;
    const bool even_row = (y & 1) == 0;
    const bool has_up = y >= 1, has_down = y + 1 < a.height;
    Out16<O> q[3];

    if constexpr (V == kDmaFloor) {
      int z[kVec];
      load_ints<kVec>(raw + (r + 1) * R::kWidth + R::kLeft + c, z);
      int trow = 0, tc = 0, edge = 0;
      if constexpr (kFormA) {
        trow = (y / a.tile_h - tr0) * nc;
        tc = x / a.tile_w;
        edge = (tc + 1) * a.tile_w;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        // The staged centre sample & zero (0): form B's value.
        const int zi = z[i] & a.zero;
        bool on = false;
        if constexpr (kFormA) {
          if (x + i == edge) {
            ++tc;
            edge += a.tile_w;
          }
          on = flag[trow + min(tc - tc0, nc - 1)] != 0;
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) q[p].set(i, Q::of_int(on ? p + 1 + zi : zi));
      }
    } else if constexpr (V == kLevels) {
      float s[kVec];
      load_vals<kVec>(raw + (r + 1) * R::kWidth + R::kLeft + c, s);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const auto lvl = Q::of(finish::levels(L, s[i]));
#pragma unroll
        for (int p = 0; p < 3; ++p) q[p].set(i, lvl);
      }
    } else if constexpr (V == kDemosaic) {
#pragma unroll
      for (int h = 0; h < kVec; h += 4) {           // four quarters of 4 pixels
        float up[6], mid[6], dn[6];
        load_lv_row(lv, r, c + h, up);
        load_lv_row(lv, r + 1, c + h, mid);
        load_lv_row(lv, r + 2, c + h, dn);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = h + e;
          const float u[3] = {up[e], up[e + 1], up[e + 2]};
          const float m[3] = {mid[e], mid[e + 1], mid[e + 2]};
          const float d[3] = {dn[e], dn[e + 1], dn[e + 2]};
          float rgbe[4];
          if (interior) {
            demosaic_px<true, 256>(u, m, d, true, true, true, true, even_row, (i & 1) == 0,
                                   rgbe);
          } else {
            demosaic_px<false, 256>(u, m, d, has_up, has_down, x + i >= 1,
                                    x + i + 1 < a.width, even_row, (i & 1) == 0, rgbe);
          }
#pragma unroll
          for (int p = 0; p < 3; ++p) q[p].set(i, Q::scaled(rgbe[p]));
        }
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < kVec; ++i) {
        float rgbe[4];
        if constexpr (V == kColorOnly) {
          const float lvl =
              finish::levels(L, sample(raw[(r + 1) * R::kWidth + R::kLeft + c + i]));
          rgbe[0] = rgbe[1] = rgbe[2] = lvl;
          rgbe[3] = lvl * 0.0f;
        } else {
          const int j = c + kLvLeft + i;             // the pixel's levels column
          const float u[3] = {lv[lv_at(r, j - 1)], lv[lv_at(r, j)], lv[lv_at(r, j + 1)]};
          const float m[3] = {lv[lv_at(r + 1, j - 1)], lv[lv_at(r + 1, j)],
                              lv[lv_at(r + 1, j + 1)]};
          const float d[3] = {lv[lv_at(r + 2, j - 1)], lv[lv_at(r + 2, j)],
                              lv[lv_at(r + 2, j + 1)]};
          const bool even_col = ((x + i) & 1) == 0;
          if (interior) {
            demosaic_px<true, 1>(u, m, d, true, true, true, true, even_row, even_col, rgbe);
          } else {
            demosaic_px<false, 1>(u, m, d, has_up, has_down, x + i >= 1, x + i + 1 < a.width,
                                  even_row, even_col, rgbe);
          }
        }
        float rgb[3];
        variant_rgb<sizeof(O) == 4>(rgbe, s_scal, rgb);
#pragma unroll
        for (int p = 0; p < 3; ++p) q[p].push(i, Q::of(rgb[p]));
      }
    }

    const bool whole = a.vec_store && x + kVec <= a.width;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      store(out + p * plane_px + static_cast<long long>(y) * a.width + x, q[p], whole,
            a.width - x);
    }
  }
}

// -- host side ------------------------------------------------------------------

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The plane's tensor map: [height, width] of T, a box of kWidth x
// (tile_rows + 2) samples, zeros outside.
template <typename T>
cudaError_t encode_plane(VariantArgs& a) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.width), static_cast<cuuint64_t>(a.height)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.width) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(RawTile<T>::kWidth),
                             static_cast<cuuint32_t>(a.tile_rows + 2)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(&a.map,
                         sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         2, const_cast<void*>(a.plane), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Bytes of dma_floor form A's flag table: the most TPU tiles a block's
// rows and 128 columns can overlap.
size_t flag_bytes(const VariantArgs& a) {
  const int nr = (a.tile_rows - 1) / a.tile_h + 2, nc = (kTileW - 1) / a.tile_w + 2;
  return static_cast<size_t>(nr < a.tile_rows ? nr : a.tile_rows) * (nc < kTileW ? nc : kTileW);
}

template <int V, bool kFormA, typename T>
size_t dynamic_smem(const VariantArgs& a) {
  size_t bytes = 128 + static_cast<size_t>(a.tile_rows + 2) * RawTile<T>::kWidth * sizeof(T);
  if constexpr (V == kDemosaic || V == kFull) {
    bytes += static_cast<size_t>(a.tile_rows + 2) * kLvPitch * sizeof(float);
  }
  if constexpr (V == kDmaFloor && kFormA) bytes += flag_bytes(a);
  return bytes;
}

template <bool kFormA, typename O>
cudaError_t launch_noop(VariantArgs& a, cudaStream_t stream) {
  const long long vecs = (3LL * a.height * a.width + Out16<O>::kPix - 1) / Out16<O>::kPix;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  a.vec_store = reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  noop_kernel<kFormA, O><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// A block a tile: (tiles along x, tiles along y).
template <int V, bool kFormA, typename T, typename O>
cudaError_t launch_as(VariantArgs& a, cudaStream_t stream) {
  if (a.route == kRouteTma) {
    const cudaError_t e = encode_plane<T>(a);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = dynamic_smem<V, kFormA, T>(a);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(variant_kernel<V, kFormA, T, O>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.width + kTileW - 1) / kTileW, (a.height + a.tile_rows - 1) / a.tile_rows);
  variant_kernel<V, kFormA, T, O><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The four type pairs of a form-B rung.
template <int V>
cudaError_t launch_types(VariantArgs& a, bool in_f32, bool out_f32, cudaStream_t s) {
  if (in_f32) {
    return out_f32 ? launch_as<V, false, float, float>(a, s)
                   : launch_as<V, false, float, uint8_t>(a, s);
  }
  return out_f32 ? launch_as<V, false, uint16_t, float>(a, s)
                 : launch_as<V, false, uint16_t, uint8_t>(a, s);
}

}  // namespace

// C entry point for ctypes: run `variant` (0 noop, 1 dma_floor, 2 levels,
// 3 demosaic, 4 color_only, 5 full) of form A (form_a = 1,
// exp_kernel_variants.py) or B (0, exp_kernel_variants3.py) on the plane
// [height, width] (in_f32: 0 = u16, 1 = f32) with the calibration scal
// [8, 16] (device memory) into out [3, height, width] (out_f32: 0 = u8,
// 1 = f32). tile_h, tile_w: the TPU tile of dma_floor form A (ignored
// otherwise). Form A, and demosaic in either form, write u8 only. The launch
// plan (kernels/variants.py::variant_plan): tile_rows output rows a block
// (1..254), route 0 = TMA (the plane's rows and base on 16 bytes, else
// refused) or 1 = vector loads (noop reads no plane and ignores both).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int develop_variant_launch(const void* plane, int in_f32, int height, int width,
                                      const float* scal, int variant, int form_a, int tile_h,
                                      int tile_w, int out_f32, void* out, int tile_rows,
                                      int route, void* stream) {
  VariantArgs a = {};
  a.plane = plane;
  a.height = height;
  a.width = width;
  a.scal = scal;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.tile_rows = tile_rows;
  a.route = route;
  a.zero = 0;
  a.out = out;
  const int in_bytes = in_f32 ? 4 : 2, out_bytes = out_f32 ? 4 : 1;
  a.vec_store = (static_cast<long long>(width) * out_bytes) % 16 == 0
                && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool u8_only = form_a || variant == kDemosaic;
  const bool tma_ok = (static_cast<long long>(width) * in_bytes) % 16 == 0
                      && reinterpret_cast<uintptr_t>(plane) % 16 == 0;
  if (height <= 0 || width <= 0 || variant < 0 || variant >= kVariants || (u8_only && out_f32)
      || (variant == kDmaFloor && form_a && (tile_h <= 0 || tile_w <= 0))
      || tile_rows < 1 || tile_rows > kMaxTileRows
      || (height + tile_rows - 1) / tile_rows > 65535
      || (route != kRouteTma && route != kRouteVector)
      || (route == kRouteTma && variant != kNoop && !tma_ok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (variant) {
    case kNoop:        // reads no plane: one instantiation per output type
      if (form_a) return static_cast<int>(launch_noop<true, uint8_t>(a, s));
      return static_cast<int>(out_f32 ? launch_noop<false, float>(a, s)
                                      : launch_noop<false, uint8_t>(a, s));
    case kDmaFloor:
      if (form_a) {
        return static_cast<int>(in_f32 ? launch_as<kDmaFloor, true, float, uint8_t>(a, s)
                                       : launch_as<kDmaFloor, true, uint16_t, uint8_t>(a, s));
      }
      return static_cast<int>(launch_types<kDmaFloor>(a, in_f32, out_f32, s));
    case kLevels:
      return static_cast<int>(launch_types<kLevels>(a, in_f32, out_f32, s));
    case kDemosaic:
      return static_cast<int>(in_f32 ? launch_as<kDemosaic, false, float, uint8_t>(a, s)
                                     : launch_as<kDemosaic, false, uint16_t, uint8_t>(a, s));
    case kColorOnly:
      return static_cast<int>(launch_types<kColorOnly>(a, in_f32, out_f32, s));
    default:
      return static_cast<int>(launch_types<kFull>(a, in_f32, out_f32, s));
  }
}
