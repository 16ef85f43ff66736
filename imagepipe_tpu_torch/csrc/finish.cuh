// The develop back end shared by the develop kernels: RGBE -> WB + camera
// matrix -> Lab -> tone spline -> Lab^-1 -> XYZ->RGB -> sRGB gamma ->
// quantize.
//
// Counterpart of imagepipe_tpu/kernels/develop_pallas.py::_finish_tile
// (and _emit), which both Pallas develop kernels call, so the colour chain
// keeps one device form. It follows _finish_tile operation for operation.
// cbrt and pow are expf(logf(x) * k) with the same guards, never cbrtf,
// powf or the fast intrinsics: mismatched transcendental forms exceed 10
// LSB at 16-bit after the Lab^-1 cancellation. Quotients are IEEE. Build
// without --use_fast_math. nvcc contracts a + b*c into FMA, as XLA does;
// the 16-bit quantize scale uses __fmul_rn so that rounding to the output
// grid sees the same product as the plain version.
//
// What bounds it. Per output pixel it issues some 400 instructions, most
// of them the six accurate expf/logf (~36 each). The design keeps their
// forms and takes out the rest of the cost:
//  * each IEEE division by a constant is div_const (div_rcp), a multiply by
//    the correctly rounded reciprocal and one FMA correction (Markstein), which
//    gives the same quotient as __fdiv_rn (proven on the card for every
//    float input, chip_smoke.py phase 1); the compiler's own division
//    refines the reciprocal at run time and checks its range per call;
//  * the branches of lab_f, lab_inv, Y and gamma are branches, not
//    selects: a pixel computes only the side it takes;
//  * it reads no device memory: each block stages its image's calibration
//    (scal [8,16], spline [5,S]) in shared memory once (load_calib), and
//    the spline's interval search reads the knots there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace finish {

constexpr float kLabE = 216.0f / 24389.0f;
constexpr float kLabK = 24389.0f / 27.0f;
constexpr float kLabKE = kLabK * kLabE;
constexpr float kXW = 0.95047f;
constexpr float kYW = 1.0f;
constexpr float kZW = 1.08883f;
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kInvGamma = (float)(1.0 / 2.4);

// The back end's constant divisors, by index: every division by a constant
// below (but the exact one by kYW = 1) is div_const<K>, and
// csrc/division_check.cu proves each K.
enum Divisor { kDivXW, kDivZW, kDiv100, kDiv116, kDiv200, kDiv255, kDiv500, kDivLabK, kDivisors };

__host__ __device__ constexpr float divisor(int k) {
  return k == kDivXW ? kXW : k == kDivZW ? kZW : k == kDiv100 ? 100.0f : k == kDiv116 ? 116.0f
       : k == kDiv200 ? 200.0f : k == kDiv255 ? 255.0f : k == kDiv500 ? 500.0f : kLabK;
}

// x / d given y = RN(1/d), as a multiply and one FMA correction (Markstein):
// q = RN(x y); the remainder e = x - q d is exact (one FMA); RN(q + e y) is
// the correctly rounded quotient, the IEEE x / d, whenever x, d and x / d
// lie well inside the normal range. So |x| in [lo, hi] ([2^-60, 2^60], |d|
// in the same range) takes this path and anything else (0, subnormal, huge,
// inf, NaN) the division. Some 5 instructions where the division takes ~10
// and a range check. chip_smoke.py phase 1 holds it bit-equal to __fdiv_rn
// on the card (kernels/develop.py::division_mismatches): over every float x
// for each constant divisor, and over all 65,536 u16 raws for the levels of
// each calibration it develops and of a sweep of others.
__device__ __forceinline__ float div_rcp(float x, float d, float y, float lo = 0x1p-60f,
                                         float hi = 0x1p60f) {
  const float q = __fmul_rn(x, y);
  const float e = __fmaf_rn(-q, d, x);
  float r = __fmaf_rn(e, y, q);
  const float ax = fabsf(x);
  if (!(ax >= lo && ax <= hi)) r = __fdiv_rn(x, d);
  return r;
}

// x / divisor(K), through div_rcp with the reciprocal rounded at compile
// time (IEEE single precision, correctly rounded).
template <int K>
__device__ __forceinline__ float div_const(float x) {
  constexpr float d = divisor(K);
  constexpr float y = 1.0f / d;
  return div_rcp(x, d, y);
}

__device__ __forceinline__ float to_float(uint16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// One image's levels (gofloat.rs:122-130): min((raw - black) / range, 1),
// the division through div_rcp; a range outside [2^-60, 2^60] always
// divides (lo = inf sends every x to the division).
struct Levels {
  float black, range, rcp, lo;
};

__device__ __forceinline__ Levels make_levels(float black, float range) {
  const float ar = fabsf(range);
  const bool normal = ar >= 0x1p-60f && ar <= 0x1p60f;
  return {black, range, __frcp_rn(range), normal ? 0x1p-60f : __int_as_float(0x7f800000)};
}

__device__ __forceinline__ float levels(const Levels& l, float raw) {
  return fminf(div_rcp(raw - l.black, l.range, l.rcp, l.lo), 1.0f);
}

__device__ __forceinline__ float lab_f(float t) {
  if (t > kLabE) return expf(logf(fmaxf(t, 1e-30f)) * kThird);
  return div_const<kDiv116>(kLabK * t + 16.0f);
}

__device__ __forceinline__ float lab_inv(float f) {
  const float f3 = f * f * f;
  if (f3 > kLabE) return f3;
  return div_const<kDivLabK>(116.0f * f - 16.0f);
}

__device__ __forceinline__ uint32_t quantize(uint8_t*, float v) {
  const float s = fminf(fmaxf(v * 256.0f, 0.0f), 255.0f);
  return static_cast<uint32_t>(static_cast<int>(s));
}

__device__ __forceinline__ uint32_t quantize(uint16_t*, float v) {
  const float s = __fmul_rn(v, 65535.0f);
  const float r = truncf(s + (s >= 0.0f ? 0.5f : -0.5f));
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(r, 0.0f), 65535.0f)));
}

// Calibration as the kernels receive it: image 0's tables in device memory,
// image b's at b * 128 and b * 5 * spline_stride floats.
struct Calib {
  const float* scal;        // [B, 8, 16]: levels, WB, camera matrix, XYZ->RGB
  const float* spline;      // [B, 5, spline_stride]: xs, ys, c1, c2, c3
  int spline_stride;
  int n_knots;              // 0 = no tone curve
  int linear;               // skip gamma (16-bit linear output)
};

// Floats of a block's shared copy of one image's calibration: scal [128],
// then spline [5, spline_stride]. spline_stride is a multiple of 8, so the
// copy keeps 16-byte alignment after it.
__host__ __device__ constexpr int calib_floats(int spline_stride) {
  return 128 + 5 * spline_stride;
}

// Copy image b's calibration into the block's shared `dst`, threads
// tid < nthreads in turn. The caller synchronizes before reading it.
__device__ __forceinline__ void load_calib(float* dst, const Calib& k, int b, int tid,
                                           int nthreads) {
  const float* scal = k.scal + b * 128;
  const float* spline = k.spline + static_cast<long long>(b) * 5 * k.spline_stride;
  for (int i = tid; i < 128; i += nthreads) dst[i] = scal[i];
  for (int i = tid; i < 5 * k.spline_stride; i += nthreads) dst[128 + i] = spline[i];
}

// Develop one pixel's RGBE to its three output channels before quantizing,
// with the calibration `cal` staged by load_calib. kStageLimit < 4 cuts the
// chain as _finish_tile(stage_limit) does, a profiling knob: 1 returns the
// RGBE's first three channels, 2 (L, A, B) after Lab, 3 (L, A, B) after
// the spline; each is quantized as it stands, with no gamma (_emit with
// linear=True), whatever Calib::linear says. 4, the production chain,
// compiles to the same code as before the knob existed.
template <int kStageLimit = 4>
__device__ __forceinline__ void develop_rgb(const float rgbe[4], const float* cal,
                                            const Calib& k, float out[3]) {
  static_assert(kStageLimit >= 1 && kStageLimit <= 4, "stage limit 1..4");
  if constexpr (kStageLimit == 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = rgbe[c];
    return;
  }
  const float* scal = cal;

  // WB multipliers (clipped to 1) and the 3x4 camera matrix -> XYZ.
  float wb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wb[c] = fminf(rgbe[c] * scal[16 + c], 1.0f);
  float xyz[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = scal + 16 * (2 + r);
    float acc = wb[0] * m[0];
    acc = acc + wb[1] * m[1];
    acc = acc + wb[2] * m[2];
    acc = acc + wb[3] * m[3];
    xyz[r] = acc;
  }

  // XYZ -> Lab, re-ranged to [0, 1].
  const float fx = lab_f(div_const<kDivXW>(xyz[0]));
  const float fy = lab_f(xyz[1] / kYW);
  const float fz = lab_f(div_const<kDivZW>(xyz[2]));
  float L = div_const<kDiv100>(116.0f * fy - 16.0f);
  const float A = div_const<kDiv255>(500.0f * (fx - fy) + 127.0f);
  const float B = div_const<kDiv255>(200.0f * (fy - fz) + 127.0f);
  if constexpr (kStageLimit == 2) {
    out[0] = L; out[1] = A; out[2] = B;
    return;
  }

  // Tone spline on L: interval by compare count, end clamps.
  const int nk = k.n_knots;
  if (nk > 0) {
    const int stride = k.spline_stride;
    const float* xs = cal + 128;
    const float* ys = xs + stride;
    const float* c1 = xs + 2 * stride;
    const float* c2 = xs + 3 * stride;
    const float* c3 = xs + 4 * stride;
    int idx = 0;
    for (int i = 1; i < nk; ++i) idx += (L >= xs[i]) ? 1 : 0;
    idx = min(max(idx, 0), nk - 2);
    const float d = L - xs[idx];
    float Lc = ys[idx] + c1[idx] * d + c2[idx] * d * d + c3[idx] * d * d * d;
    if (L >= xs[nk - 1]) Lc = ys[nk - 1];
    if (L <= xs[0]) Lc = ys[0];
    L = Lc;
  }
  if constexpr (kStageLimit == 3) {
    out[0] = L; out[1] = A; out[2] = B;
    return;
  }

  // Lab -> XYZ -> linear RGB (color_conversions.rs:58-65,171-191).
  const float cl = L * 100.0f;
  const float ca = A * 255.0f - 127.0f;
  const float cb = B * 255.0f - 127.0f;
  const float fy2 = div_const<kDiv116>(cl + 16.0f);
  const float fx2 = div_const<kDiv500>(ca) + fy2;
  const float fz2 = fy2 - div_const<kDiv200>(cb);
  const float X = lab_inv(fx2) * kXW;
  float Y;
  if (cl > kLabKE) {
    Y = fy2 * fy2 * fy2 * kYW;
  } else {
    Y = div_const<kDivLabK>(cl) * kYW;
  }
  const float Z = lab_inv(fz2) * kZW;

#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = scal + 16 * (5 + r);
    float ch = X * m[0] + Y * m[1] + Z * m[2];
    if (!k.linear) {
      ch = fminf(fmaxf(ch, 0.0f), 1.0f);
      if (ch < 0.0031308f) {
        ch = ch * 12.92f;
      } else {
        ch = 1.055f * expf(logf(fmaxf(ch, 1e-30f)) * kInvGamma) - 0.055f;
      }
    }
    out[r] = ch;
  }
}

}  // namespace finish
