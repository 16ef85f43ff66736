// The develop kernel's ablation ladder for Hopper (sm_90a): each variant
// keeps a longer prefix of the full-size develop's work and writes three
// planes [3, H, W], so that timing the rungs one after another splits the
// develop kernel's time into its parts.
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
// The block geometry is csrc/develop.cu's, so the rungs decompose that
// kernel and not another: a block outputs a 128 x 8 tile, four pixels along
// a row per thread; it stages the tile plus a 1-pixel halo (10 x 130
// samples) in shared memory, converted to levels as it loads them
// (develop.cu's staging loop; dma_floor stages the raw values), each thread
// issuing its six loads before it converts any; each thread stores its four
// pixels of a plane with one 32-bit store (u8) or one 128-bit store (f32)
// where the row allows it. Where it departs from develop.cu:
//  * the demosaic is the TPU experiment's closed form for RGGB at even
//    origin (the colour from the row and column parity, each neighbour's
//    validity tested), not develop.cu's per-CFA-phase tables and interior
//    split;
//  * the back end (variant_rgb below) has no tone curve and no linear
//    output, and the quantize truncates where develop.cu's rounds;
//  * the calibration is one [8, 16] table (no spline) staged in shared
//    memory; there is no crop, batch, shard or EXIF flip;
//  * f32 outputs, which develop.cu does not have, unroll the four pixels
//    to keep them in registers for the 128-bit store, and round each
//    product and sum of the back end on its own (no FMA); the u8 path keeps
//    develop.cu's `unroll 1` loop and its contraction.
//
// What bounds it: the same as develop.cu (instruction issue in the back
// end). At 24 MP the bytes are 2 B/px read and 3 B/px (12 B/px f32)
// written: 0.036 ms (0.093 f32) at 3.35 TB/s; the rungs' least float32
// work is scripts/time_develop_kernels.py's OPS_* counts.
//
// dma_floor form A takes its flag from the TPU tile that holds the pixel
// ((tile_h, tile_w), a launch argument): each warp, one output row, walks
// the TPU tiles its 128 columns overlap, reads the 128 samples of the
// tile's first row (4 a lane, samples past the width are the zero padding)
// and votes (__any_sync). Both forms read each staged centre sample back and
// and it with `zero`, a launch argument that is 0: form B's value (the
// experiment ands it with 0), and in form A what keeps the staging, which
// nvcc would otherwise drop as unread (no shared-memory store was left).
//
// Numerics: finish.cuh's primitives where the function is theirs (levels
// through div_rcp, and divisions by constants through div_const, both equal
// to the IEEE division). Averages divide by the count (IEEE). expf / logf,
// no fast math. For u8 outputs nvcc contracts a + b*c into FMA, as in
// develop.cu, and the plain PyTorch version does not: they agree within
// 1 LSB. For float32 outputs every product and sum of the back end is
// rounded on its own (Arith), so the kernel gives the plain version's
// float32 values bit for bit (the contract is 1e-3 on the 0-255 scale): an
// ulp at the Lab^-1 cancellation becomes ~1e-3 after the gamma's slope of
// 12.92 x 256 at dark, saturated pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "finish.cuh"

namespace {

using finish::to_float;

enum Variant { kNoop, kDmaFloor, kLevels, kDemosaic, kColorOnly, kFull, kVariants };

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kPix = 4;                        // output pixels per thread, along a row
constexpr int kTileW = kThreadsX * kPix;        // 128
constexpr int kTileH = kThreadsY;              // 8
constexpr int kHaloW = kTileW + 2;             // 130
constexpr int kHaloH = kTileH + 2;             // 10
constexpr int kStagePerThread = (kHaloH * kHaloW + kThreads - 1) / kThreads;   // 6
constexpr int kFlagSamples = 128;              // dma_floor form A: samples of a tile's first row

struct VariantArgs {
  const void* plane;        // [height, width], row-major
  int height, width;
  const float* scal;        // [8, 16]: black, range; WB; camera matrix; XYZ->RGB
  int tile_h, tile_w;       // dma_floor form A: the TPU tile
  int zero;                 // 0 (dma_floor form B)
  void* out;                // [3, height, width] u8 or f32
};

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

// The closed-form RGGB demosaic at (y, x) of the levels tile, `lv` at the
// centre: the centre's own colour takes its sample, the other two average
// the valid neighbours in the experiment's order (plus, row, column or
// cross), E = 0.
__device__ __forceinline__ void demosaic_rggb(const float* lv, int y, int x, int height,
                                              int width, float rgbe[4]) {
  const bool up = y >= 1, down = y + 1 < height, left = x >= 1, right = x + 1 < width;
  const float vu = up ? lv[-kHaloW] : 0.0f, vd = down ? lv[kHaloW] : 0.0f;
  const float vl = left ? lv[-1] : 0.0f, vr = right ? lv[1] : 0.0f;
  const float c = lv[0];
  const bool even_row = (y & 1) == 0, even_col = (x & 1) == 0;
  rgbe[3] = 0.0f;
  if (even_row == even_col) {                    // R (even, even) or B (odd, odd)
    const float e = avg(((vu + vd) + vl) + vr, int(up) + int(down) + int(left) + int(right));
    const float d = avg((((up && left ? lv[-kHaloW - 1] : 0.0f)
                          + (up && right ? lv[-kHaloW + 1] : 0.0f))
                         + (down && left ? lv[kHaloW - 1] : 0.0f))
                        + (down && right ? lv[kHaloW + 1] : 0.0f),
                        int(up && left) + int(up && right) + int(down && left)
                        + int(down && right));
    rgbe[0] = even_row ? c : d;
    rgbe[1] = e;
    rgbe[2] = even_row ? d : c;
  } else {                                       // G: R along its row on an R row
    const float h = avg(vl + vr, int(left) + int(right));
    const float v = avg(vu + vd, int(up) + int(down));
    rgbe[0] = even_row ? h : v;
    rgbe[1] = c;
    rgbe[2] = even_row ? v : h;
  }
}

template <typename O>
__device__ __forceinline__ O quantize(float v);
template <>
__device__ __forceinline__ uint8_t quantize<uint8_t>(float v) {
  return static_cast<uint8_t>(finish::quantize(static_cast<uint8_t*>(nullptr), v));
}
template <>
__device__ __forceinline__ float quantize<float>(float v) {
  return fminf(fmaxf(v * 256.0f, 0.0f), 255.0f);
}

// dma_floor form A: bit i set where the TPU tile holding this thread's
// pixel i has a sample > 0 (as an int32) among its first row's first 128.
// Every lane of the warp (one output row) takes part.
template <typename T>
__device__ __forceinline__ unsigned tile_flags(const VariantArgs& a, const T* __restrict__ plane,
                                               int y, int x0, int xs) {
  const int row0 = (min(y, a.height - 1) / a.tile_h) * a.tile_h;
  const int last = min(x0 + kTileW, a.width) - 1;
  unsigned flags = 0;
  for (int t = x0 / a.tile_w; t <= last / a.tile_w; ++t) {
    const int col0 = t * a.tile_w;
    bool pos = false;
#pragma unroll
    for (int k = 0; k < kFlagSamples / kThreadsX; ++k) {
      const int xx = col0 + threadIdx.x * (kFlagSamples / kThreadsX) + k;
      if (xx < a.width) {
        pos |= __float2int_rz(to_float(plane[static_cast<long long>(row0) * a.width + xx])) > 0;
      }
    }
    const bool any = __any_sync(0xffffffffu, pos);
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      if (any && (xs + i) / a.tile_w == t) flags |= 1u << i;
    }
  }
  return flags;
}

template <int V, bool kFormA, typename T, typename O>
__global__ void __launch_bounds__(kThreads) variant_kernel(const VariantArgs a) {
  __shared__ __align__(16) float s_lv[kHaloH * kHaloW];
  __shared__ float s_scal[128];

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int y = y0 + threadIdx.y;
  const int xs = x0 + threadIdx.x * kPix;
  const T* __restrict__ plane = static_cast<const T*>(a.plane);

  unsigned flags = 0;
  if constexpr (V == kDmaFloor && kFormA) flags = tile_flags(a, plane, y, x0, xs);

  if constexpr (V != kNoop) {
    for (int i = tid; i < 128; i += kThreads) s_scal[i] = a.scal[i];
    // Stage the tile and its halo, as levels (dma_floor: raw); samples
    // outside the image are 0 and never summed.
    const finish::Levels lv = finish::make_levels(a.scal[0], a.scal[1]);
    T raw[kStagePerThread];
    bool in[kStagePerThread];
#pragma unroll
    for (int j = 0; j < kStagePerThread; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / kHaloW, c = e - r * kHaloW;
      const int yy = y0 - 1 + r, xx = x0 - 1 + c;
      in[j] = e < kHaloH * kHaloW && yy >= 0 && yy < a.height && xx >= 0 && xx < a.width;
      raw[j] = in[j] ? plane[static_cast<long long>(yy) * a.width + xx] : T(0);
    }
#pragma unroll
    for (int j = 0; j < kStagePerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < kHaloH * kHaloW) {
        s_lv[e] = !in[j] ? 0.0f
                : V == kDmaFloor ? to_float(raw[j]) : finish::levels(lv, to_float(raw[j]));
      }
    }
    __syncthreads();
  }

  if (y >= a.height || xs >= a.width) return;
  const float* centre = s_lv + (threadIdx.y + 1) * kHaloW + threadIdx.x * kPix + 1;

  // The three planes' values of pixel i.
  auto pixel = [&](int i, float o[3]) {
    const int x = xs + i;
    if constexpr (V == kNoop) {
      const float on = kFormA && a.scal[0] > 0.0f ? 1.0f : 0.0f;   // form A: black > 0
#pragma unroll
      for (int r = 0; r < 3; ++r) o[r] = static_cast<float>(r + 1) * on;
    } else if constexpr (V == kDmaFloor) {
      // The staged centre sample & zero (0): form B's value, and what keeps
      // form A's staging, which the compiler would drop as unread.
      const int z = __float2int_rz(centre[i]) & a.zero;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        o[r] = static_cast<float>(kFormA && ((flags >> i) & 1u) ? r + 1 + z : z);
      }
    } else if constexpr (V == kLevels) {
      const float q = quantize<O>(centre[i]);
#pragma unroll
      for (int r = 0; r < 3; ++r) o[r] = q;
    } else {
      float rgbe[4];
      if constexpr (V == kColorOnly) {
        rgbe[0] = rgbe[1] = rgbe[2] = centre[i];
        rgbe[3] = centre[i] * 0.0f;
      } else {
        demosaic_rggb(centre + i, y, x, a.height, a.width, rgbe);
      }
      if constexpr (V == kDemosaic) {
#pragma unroll
        for (int r = 0; r < 3; ++r) o[r] = quantize<O>(rgbe[r]);
      } else {
        float rgb[3];
        variant_rgb<sizeof(O) == 4>(rgbe, s_scal, rgb);
#pragma unroll
        for (int r = 0; r < 3; ++r) o[r] = quantize<O>(rgb[r]);
      }
    }
  };

  const long long plane_px = static_cast<long long>(a.height) * a.width;
  O* out = static_cast<O*>(a.out) + static_cast<long long>(y) * a.width + xs;
  const bool whole = (a.width & (kPix - 1)) == 0 && xs + kPix <= a.width;
  if constexpr (sizeof(O) == 1) {
    // develop.cu's loop: four pixels packed into one 32-bit word a plane.
    uint32_t q[3] = {0, 0, 0};
#pragma unroll 1
    for (int i = 0; i < kPix; ++i) {
      if (xs + i >= a.width) break;
      float o[3];
      pixel(i, o);
#pragma unroll
      for (int r = 0; r < 3; ++r) q[r] |= static_cast<uint32_t>(o[r]) << (8 * i);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      O* p = out + r * plane_px;
      if (whole) {
        *reinterpret_cast<uint32_t*>(p) = q[r];
      } else {
        for (int i = 0; i < kPix && xs + i < a.width; ++i) p[i] = static_cast<O>(q[r] >> (8 * i));
      }
    }
  } else {
    float q[3][kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      float o[3] = {0.0f, 0.0f, 0.0f};
      if (xs + i < a.width) pixel(i, o);
#pragma unroll
      for (int r = 0; r < 3; ++r) q[r][i] = o[r];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      O* p = out + r * plane_px;
      if (whole) {
        *reinterpret_cast<float4*>(p) = make_float4(q[r][0], q[r][1], q[r][2], q[r][3]);
      } else {
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          if (xs + i < a.width) p[i] = q[r][i];
        }
      }
    }
  }
}

template <int V, bool kFormA, typename T, typename O>
cudaError_t launch_as(const VariantArgs& a, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((a.width + kTileW - 1) / kTileW, (a.height + kTileH - 1) / kTileH);
  variant_kernel<V, kFormA, T, O><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

// Form A and demosaic write u8 only (the entry point refuses f32 for them).
template <int V, bool kFormA>
cudaError_t launch_types(const VariantArgs& a, int in_f32, int out_f32, cudaStream_t stream) {
  if constexpr (kFormA || V == kDemosaic) {
    return in_f32 ? launch_as<V, kFormA, float, uint8_t>(a, stream)
                  : launch_as<V, kFormA, uint16_t, uint8_t>(a, stream);
  } else if (in_f32) {
    return out_f32 ? launch_as<V, kFormA, float, float>(a, stream)
                   : launch_as<V, kFormA, float, uint8_t>(a, stream);
  } else {
    return out_f32 ? launch_as<V, kFormA, uint16_t, float>(a, stream)
                   : launch_as<V, kFormA, uint16_t, uint8_t>(a, stream);
  }
}

}  // namespace

// C entry point for ctypes: run `variant` (0 noop, 1 dma_floor, 2 levels,
// 3 demosaic, 4 color_only, 5 full) of form A (form_a = 1,
// exp_kernel_variants.py) or B (0, exp_kernel_variants3.py) on the plane
// [height, width] (in_f32: 0 = u16, 1 = f32) with the calibration scal
// [8, 16] (device memory) into out [3, height, width] (out_f32: 0 = u8,
// 1 = f32). tile_h, tile_w: the TPU tile of dma_floor form A (ignored
// otherwise). Form A, and demosaic in either form, write u8 only. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int develop_variant_launch(const void* plane, int in_f32, int height, int width,
                                      const float* scal, int variant, int form_a, int tile_h,
                                      int tile_w, int out_f32, void* out, void* stream) {
  VariantArgs a;
  a.plane = plane;
  a.height = height;
  a.width = width;
  a.scal = scal;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.zero = 0;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool u8_only = form_a || variant == kDemosaic;
  if (height <= 0 || width <= 0 || (height + kTileH - 1) / kTileH > 65535 || variant < 0
      || variant >= kVariants || (u8_only && out_f32)
      || (variant == kDmaFloor && form_a && (tile_h <= 0 || tile_w <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (variant) {
    case kNoop:
      return static_cast<int>(form_a ? launch_types<kNoop, true>(a, in_f32, out_f32, s)
                                     : launch_types<kNoop, false>(a, in_f32, out_f32, s));
    case kDmaFloor:
      return static_cast<int>(form_a ? launch_types<kDmaFloor, true>(a, in_f32, out_f32, s)
                                     : launch_types<kDmaFloor, false>(a, in_f32, out_f32, s));
    case kLevels:
      return static_cast<int>(launch_types<kLevels, false>(a, in_f32, out_f32, s));
    case kDemosaic:
      return static_cast<int>(launch_types<kDemosaic, false>(a, in_f32, out_f32, s));
    case kColorOnly:
      return static_cast<int>(launch_types<kColorOnly, false>(a, in_f32, out_f32, s));
    default:
      return static_cast<int>(launch_types<kFull, false>(a, in_f32, out_f32, s));
  }
}
