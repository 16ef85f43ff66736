// The fused dirty suffix of the staged pipeline: one launch for a run of
// the chainable stages to_lab -> basecurve -> from_lab -> gamma ->
// transform (any run of them, in that order) and the final quantize.
//
// Counterpart of imagepipe_tpu/pipeline.py::_dispatch_fused, which jits the
// stages that ImageOp.device_chain describes into one XLA program (no
// Pallas kernel). Each thread carries one pixel through the segment's
// stages in registers: it reads the segment's input planes once, writes
// each stage output the caller keeps (the stage cache holds them) and the
// quantized output, the transform's flips applied as a remap of the store
// index. A transposing orientation is left to the caller, which returns
// the transform's and the quantize's [3, H, W] outputs as transposed
// views, as kernels.develop.apply_flips does in the per-stage loop.
//
// Numerics: bit-equal to the per-stage loop, which runs each stage as
// eager torch ops (color.py, spline.py) in the numerics the ops resolve,
// 'direct' or 'lut' (a launch argument; the kernel is a template over it,
// so the 'direct' form's code is the same with or without the other).
// Eager torch
// rounds every product and every sum on its own, so each one here is an
// explicit __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts
// into an FMA, in the plain version's order. Divisions by constants go
// through finish::div_const, which chip_smoke.py phase 1 proves equal to
// IEEE division for every float input (csrc/division_check.cu); color._div
// is IEEE division. cbrt and pow are expf(logf(x) * k) as in color.py,
// without fast-math. torch.clamp keeps NaN where fminf / fmaxf would not
// (clamp_* below), torch.where(v > c, ...) is false on NaN, and the float
// to u8 cast goes through int64 as torch's does. Python constants are
// rounded to float as torch rounds a Python scalar (static_cast<float> of
// the double). Build without --use_fast_math.
//
// 'lut' replaces to_lab's three cube roots and gamma's power by
// color.TransformLUT: inside [0, 1] a linear interpolation of an 8193-entry
// float32 table (the caller's device copy, TransformLUT._table), outside
// it the reference form: the cube root as pow in float64 rounded once to
// float (color._xyz_lab_f_ref; torch's pow on a float64 tensor calls the
// same double pow), the power as powf (color._srgb_apply_ref).
//
// What bounds it: bytes. At 24 MP a segment from to_lab reads 4 f32 planes
// and writes up to four 3-plane f32 stage outputs and the 3-plane u8
// output, some 1.8 GB against some 120 float32 operations per pixel. The
// design reads each input once and writes each output once, a warp on 32
// consecutive pixels of the frame (a row-major flat index, so a row that
// starts inside a 32-byte sector does not split every warp's accesses;
// chip_smoke.py phase 3c times it).

#include <cuda_runtime.h>
#include <stdint.h>

#include "finish.cuh"

namespace {

using finish::div_const;

// The stages, as bits of Segment::stages.
enum Stage { kToLab = 1, kCurve = 2, kFromLab = 4, kGamma = 8, kTransform = 16 };
constexpr int kStages = 5;

// The packed parameters (kernels/suffix.py::pack_params): WB multipliers
// [4], camera matrix [3, 4], XYZ->RGB matrix [3, 3], then the spline's
// xs, ys, c1, c2, c3, each n_knots long.
constexpr int kMul = 0, kCam = 4, kRgb = 16, kSpline = 25;

constexpr float kTiny = static_cast<float>(1e-30);
constexpr float kGammaLo = static_cast<float>(0.0031308);
constexpr float kGammaSlope = static_cast<float>(12.92);
constexpr float kGammaMul = static_cast<float>(1.055);
constexpr float kGammaSub = static_cast<float>(0.055);
// color._srgb_apply_ref's exponent, float(f32(1) / f32(2.4)): a float
// quotient, not finish::kInvGamma's rounded double one.
constexpr float kInvGammaRef = 1.0f / 2.4f;
constexpr int kLutMax = 8191;               // color._LUT_MAX

struct Segment {
  const float* in;          // [in_planes, height, width], row and plane strides below
  long long in_plane, in_row;
  int height, width;
  int stages;               // the Stage bits of the segment
  const float* params;      // packed, see kMul...
  int n_knots;
  int flip_x, flip_y;
  float* out[kStages];      // each stage's [3, H', W'] output, or null when not kept
  void* quant;              // [3, H', W'] u8 or u16, or null
  int quant_bits;
  const float* lab_table;   // 'lut': XYZ_LAB_TRANSFORM's and SRGB_GAMMA_TRANSFORM's
  const float* gamma_table; // [kLutMax + 2] tables; null in 'direct'
};

// torch.clamp on CUDA: NaN passes through, else fmaxf / fminf.
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// color._xyz_lab_f: cube root as exp(log(max(v, 1e-30)) / 3) above LAB_E,
// else (v * K + 16) / 116.
__device__ __forceinline__ float lab_f(float v) {
  if (v > finish::kLabE) return expf(__fmul_rn(logf(clamp_min(v, kTiny)), finish::kThird));
  return div_const<finish::kDiv116>(__fadd_rn(__fmul_rn(v, finish::kLabK), 16.0f));
}

// color.TransformLUT.__call__ in 'lut' at `val`, the table being the
// transform's: pos = val * 8191, base = trunc(pos), key = base clamped to
// [0, 8191] with NaN as 0, then table[key] + a * (table[key + 1] -
// table[key]) with a = pos - base. Only for val in [0, 1], where the
// plain version selects it.
__device__ __forceinline__ float lut_lerp(float val, const float* table) {
  const float pos = __fmul_rn(val, static_cast<float>(kLutMax));
  const float base = truncf(pos);
  const float k = clamp(base, 0.0f, static_cast<float>(kLutMax));
  const int key = isnan(k) ? 0 : static_cast<int>(k);
  const float a = __fsub_rn(pos, base);
  const float v1 = __ldg(table + key), v2 = __ldg(table + key + 1);
  return __fadd_rn(v1, __fmul_rn(a, __fsub_rn(v2, v1)));
}

__device__ __forceinline__ bool lut_in_range(float val) { return val >= 0.0f && val <= 1.0f; }

// color._xyz_lab_f_ref: above LAB_E the cube root in float64 rounded once,
// else the linear branch, as lab_f's.
__device__ __forceinline__ float lab_f_ref(float v) {
  if (v > finish::kLabE) return static_cast<float>(pow(static_cast<double>(v), 1.0 / 3.0));
  return div_const<finish::kDiv116>(__fadd_rn(__fmul_rn(v, finish::kLabK), 16.0f));
}

// XYZ_LAB_TRANSFORM in the kernel's numerics.
template <bool kLut>
__device__ __forceinline__ float lab_f_as(float v, const float* table) {
  if constexpr (kLut) return lut_in_range(v) ? lut_lerp(v, table) : lab_f_ref(v);
  return lab_f(v);
}

// lab_to_xyz's x and z: f^3 above LAB_E, else (f * 116 - 16) / K.
__device__ __forceinline__ float lab_inv(float f) {
  const float f3 = __fmul_rn(__fmul_rn(f, f), f);
  if (f3 > finish::kLabE) return f3;
  return div_const<finish::kDivLabK>(__fsub_rn(__fmul_rn(f, 116.0f), 16.0f));
}

// a * m0 + b * m1 + c * m2 (+ d * m3), each product and sum rounded, left
// to right.
__device__ __forceinline__ float row3(float a, float b, float c, const float* m) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, __ldg(m)), __fmul_rn(b, __ldg(m + 1))),
                   __fmul_rn(c, __ldg(m + 2)));
}

// color.camera_to_lab_planar: (r, g, b, e) -> (L, a, b).
template <bool kLut>
__device__ __forceinline__ void to_lab(float v[4], const float* p, const float* table) {
  float wb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wb[c] = clamp_max(__fmul_rn(v[c], __ldg(p + kMul + c)), 1.0f);
  float xyz[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = p + kCam + 4 * r;
    xyz[r] = __fadd_rn(row3(wb[0], wb[1], wb[2], m), __fmul_rn(wb[3], __ldg(m + 3)));
  }
  const float fx = lab_f_as<kLut>(div_const<finish::kDivXW>(xyz[0]), table);
  const float fy = lab_f_as<kLut>(xyz[1], table);      // / YW = 1: exact
  const float fz = lab_f_as<kLut>(div_const<finish::kDivZW>(xyz[2]), table);
  v[0] = div_const<finish::kDiv100>(__fsub_rn(__fmul_rn(fy, 116.0f), 16.0f));
  v[1] = div_const<finish::kDiv255>(__fadd_rn(__fmul_rn(__fsub_rn(fx, fy), 500.0f), 127.0f));
  v[2] = div_const<finish::kDiv255>(__fadd_rn(__fmul_rn(__fsub_rn(fy, fz), 200.0f), 127.0f));
}

// spline.eval_spline_arrays on L: the interval is the count of knots
// xs[1:] at or below v, clamped to the last interval; the cubic in torch's
// left-to-right order; then the end-knot overrides, last knot first.
__device__ __forceinline__ float curve(float v, const float* p, int n) {
  const float* xs = p + kSpline;
  const float* ys = xs + n;
  int idx = 0;
  for (int j = 1; j < n; ++j) idx += v >= __ldg(xs + j) ? 1 : 0;
  idx = min(max(idx, 0), n - 2);
  const float d = __fsub_rn(v, __ldg(xs + idx));
  const float c1 = __ldg(xs + 2 * n + idx), c2 = __ldg(xs + 3 * n + idx),
              c3 = __ldg(xs + 4 * n + idx);
  float y = __fadd_rn(__ldg(ys + idx), __fmul_rn(c1, d));
  y = __fadd_rn(y, __fmul_rn(__fmul_rn(c2, d), d));
  y = __fadd_rn(y, __fmul_rn(__fmul_rn(__fmul_rn(c3, d), d), d));
  if (v >= __ldg(xs + n - 1)) y = __ldg(ys + n - 1);
  if (v <= __ldg(xs)) y = __ldg(ys);
  return y;
}

// color.lab_to_rgb_planar: (L, a, b) -> Lab^-1 -> XYZ->RGB matrix.
__device__ __forceinline__ void from_lab(float v[4], const float* p) {
  const float cl = __fmul_rn(v[0], 100.0f);
  const float ca = __fsub_rn(__fmul_rn(v[1], 255.0f), 127.0f);
  const float cb = __fsub_rn(__fmul_rn(v[2], 255.0f), 127.0f);
  const float fy = div_const<finish::kDiv116>(__fadd_rn(cl, 16.0f));
  const float fx = __fadd_rn(div_const<finish::kDiv500>(ca), fy);
  const float fz = __fsub_rn(fy, div_const<finish::kDiv200>(cb));
  const float x = __fmul_rn(lab_inv(fx), finish::kXW);
  const float y = cl > finish::kLabKE ? __fmul_rn(__fmul_rn(fy, fy), fy)   // * YW = 1: exact
                                      : div_const<finish::kDivLabK>(cl);
  const float z = __fmul_rn(lab_inv(fz), finish::kZW);
#pragma unroll
  for (int r = 0; r < 3; ++r) v[r] = row3(x, y, z, p + kRgb + 3 * r);
}

// OpGamma: clamp to [0, 1], then color._srgb_apply ('direct'), or
// SRGB_GAMMA_TRANSFORM's lookup with color._srgb_apply_ref outside [0, 1]
// (NaN only, after the clamp) ('lut').
template <bool kLut>
__device__ __forceinline__ float srgb_gamma(float v, const float* table) {
  v = clamp(v, 0.0f, 1.0f);
  if constexpr (kLut) {
    if (lut_in_range(v)) return lut_lerp(v, table);
    if (v < kGammaLo) return __fmul_rn(v, kGammaSlope);
    return __fsub_rn(__fmul_rn(powf(clamp_min(v, 0.0f), kInvGammaRef), kGammaMul), kGammaSub);
  }
  if (v < kGammaLo) return __fmul_rn(v, kGammaSlope);
  const float e = expf(__fmul_rn(logf(clamp_min(v, kTiny)), finish::kInvGamma));
  return __fsub_rn(__fmul_rn(e, kGammaMul), kGammaSub);
}

// color.output8bit and output16bit, with torch's casts.
__device__ __forceinline__ uint8_t quantize8(float v) {
  const float s = clamp(__fmul_rn(v, 256.0f), 0.0f, 255.0f);
  return static_cast<uint8_t>(static_cast<int64_t>(s));
}

__device__ __forceinline__ uint16_t quantize16(float v) {
  const float s = __fmul_rn(v, 65535.0f);
  const float r = truncf(__fadd_rn(s, s >= 0.0f ? 0.5f : -0.5f));
  return static_cast<uint16_t>(clamp(r, 0.0f, 65535.0f));
}

__device__ __forceinline__ void store(float* out, const float v[4], long long q, long long hw) {
  if (out == nullptr) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * hw + q] = v[c];
}

// One thread per pixel, the frame's pixels in row-major order (fewer than
// 2^31 of them); kLut: 'lut' numerics.
template <bool kLut>
__global__ void __launch_bounds__(256) suffix_kernel(const Segment s) {
  const unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  const long long hw = static_cast<long long>(s.height) * s.width;
  if (p >= hw) return;
  const int y = p / static_cast<unsigned>(s.width);
  const int x = p - y * static_cast<unsigned>(s.width);
  long long q = p;

  float v[4];
  const float* src = s.in + y * s.in_row + x;
  const int planes = (s.stages & kToLab) ? 4 : 3;
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = c < planes ? src[c * s.in_plane] : 0.0f;

  if (s.stages & kToLab) {
    to_lab<kLut>(v, s.params, s.lab_table);
    store(s.out[0], v, q, hw);
  }
  if (s.stages & kCurve) {
    v[0] = curve(v[0], s.params, s.n_knots);
    store(s.out[1], v, q, hw);
  }
  if (s.stages & kFromLab) {
    from_lab(v, s.params);
    store(s.out[2], v, q, hw);
  }
  if (s.stages & kGamma) {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = srgb_gamma<kLut>(v[c], s.gamma_table);
    store(s.out[3], v, q, hw);
  }
  if (s.stages & kTransform) {
    // kernels.develop.apply_flips: flip x, flip y (the caller transposes).
    const long long yy = s.flip_y ? s.height - 1 - y : y;
    const long long xx = s.flip_x ? s.width - 1 - x : x;
    q = yy * s.width + xx;
    store(s.out[4], v, q, hw);
  }
  if (s.quant != nullptr) {
    if (s.quant_bits == 8) {
      uint8_t* out = static_cast<uint8_t*>(s.quant);
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c * hw + q] = quantize8(v[c]);
    } else {
      uint16_t* out = static_cast<uint16_t*>(s.quant);
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c * hw + q] = quantize16(v[c]);
    }
  }
}

}  // namespace

// Launch one fused segment on `stream`. `in` is [planes, height, width]
// float32 with plane stride in_plane and row stride in_row (elements;
// planes 4 when the segment starts at to_lab, else 3); `out_*` a stage's
// contiguous [3, height, width] output or null; `quant` null or
// [3, height, width] of quant_bits (8 or 16). lut: 0 = 'direct' numerics,
// 1 = 'lut' with the device tables lab_table and gamma_table ([8193]
// float32 each; the ones the segment's stages read must not be null).
// Returns the launch's cudaError_t.
extern "C" int suffix_launch(const float* in, long long in_plane, long long in_row,
                             int height, int width, int stages, const float* params,
                             int n_knots, int flip_x, int flip_y, float* out_to_lab,
                             float* out_curve, float* out_from_lab, float* out_gamma,
                             float* out_transform, void* quant, int quant_bits, int lut,
                             const float* lab_table, const float* gamma_table,
                             cudaStream_t stream) {
  Segment s{in, in_plane, in_row, height, width, stages, params, n_knots, flip_x, flip_y,
            {out_to_lab, out_curve, out_from_lab, out_gamma, out_transform}, quant,
            quant_bits, lab_table, gamma_table};
  const long long hw = static_cast<long long>(height) * width;
  if (hw <= 0) return static_cast<int>(cudaSuccess);
  if (lut && (((stages & kToLab) && lab_table == nullptr)
              || ((stages & kGamma) && gamma_table == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((hw + 255) / 256);
  if (lut) {
    suffix_kernel<true><<<blocks, 256, 0, stream>>>(s);
  } else {
    suffix_kernel<false><<<blocks, 256, 0, stream>>>(s);
  }
  return static_cast<int>(cudaGetLastError());
}
