// The develop back end shared by the develop kernels: RGBE -> WB + camera
// matrix -> Lab -> tone spline -> Lab^-1 -> XYZ->RGB -> sRGB gamma ->
// quantized planar store.
//
// Counterpart of imagepipe_tpu/kernels/develop_pallas.py::_finish_tile
// (and _emit), which both Pallas develop kernels call, so the colour chain
// keeps one device form. It follows _finish_tile operation for operation.
// cbrt and pow are expf(logf(x) * k) with the same guards, never cbrtf,
// powf or the fast intrinsics: mismatched transcendental forms exceed 10
// LSB at 16-bit after the Lab^-1 cancellation. Divisions are IEEE. Build
// without --use_fast_math. nvcc contracts a + b*c into FMA, as XLA does;
// the 16-bit quantize scale uses __fmul_rn so that rounding to the output
// grid sees the same product as the plain version.

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

__device__ __forceinline__ float to_float(uint16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float lab_f(float t) {
  const float cb = expf(logf(fmaxf(t, 1e-30f)) * kThird);
  return t > kLabE ? cb : (kLabK * t + 16.0f) / 116.0f;
}

__device__ __forceinline__ float lab_inv(float f) {
  const float f3 = f * f * f;
  return f3 > kLabE ? f3 : (116.0f * f - 16.0f) / kLabK;
}

__device__ __forceinline__ void store(uint8_t* o, float v) {
  const float s = fminf(fmaxf(v * 256.0f, 0.0f), 255.0f);
  *o = static_cast<uint8_t>(static_cast<int>(s));
}

__device__ __forceinline__ void store(uint16_t* o, float v) {
  const float s = __fmul_rn(v, 65535.0f);
  const float r = truncf(s + (s >= 0.0f ? 0.5f : -0.5f));
  *o = static_cast<uint16_t>(static_cast<int>(fminf(fmaxf(r, 0.0f), 65535.0f)));
}

// Calibration as the kernels receive it.
struct Calib {
  const float* scal;        // [8,16]: levels, WB, camera matrix, XYZ->RGB
  const float* spline;      // [5, spline_stride]: xs, ys, c1, c2, c3
  int spline_stride;
  int n_knots;              // 0 = no tone curve
  int linear;               // skip gamma (16-bit linear output)
};

// Image b's calibration in a batch whose tables are scal [B, 8, 16] and
// spline [B, 5, spline_stride], given image 0's.
__device__ __forceinline__ Calib image_calib(const Calib& k, int b) {
  Calib c = k;
  c.scal = k.scal + b * 128;
  c.spline = k.spline + static_cast<long long>(b) * 5 * k.spline_stride;
  return c;
}

// Develop one pixel's RGBE and store its three channels at out[r*plane_px + at].
template <typename O>
__device__ __forceinline__ void finish_pixel(const float rgbe[4], const Calib& k,
                                             O* out, long long plane_px, long long at) {
  const float* __restrict__ scal = k.scal;

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
  const float fx = lab_f(xyz[0] / kXW);
  const float fy = lab_f(xyz[1] / kYW);
  const float fz = lab_f(xyz[2] / kZW);
  float L = (116.0f * fy - 16.0f) / 100.0f;
  const float A = (500.0f * (fx - fy) + 127.0f) / 255.0f;
  const float B = (200.0f * (fy - fz) + 127.0f) / 255.0f;

  // Tone spline on L: interval by compare count, end clamps.
  const int nk = k.n_knots;
  if (nk > 0) {
    const float* xs = k.spline;
    const float* ys = k.spline + k.spline_stride;
    const float* c1 = k.spline + 2 * k.spline_stride;
    const float* c2 = k.spline + 3 * k.spline_stride;
    const float* c3 = k.spline + 4 * k.spline_stride;
    int idx = 0;
    for (int i = 1; i < nk; ++i) idx += (L >= xs[i]) ? 1 : 0;
    idx = min(max(idx, 0), nk - 2);
    const float d = L - xs[idx];
    float Lc = ys[idx] + c1[idx] * d + c2[idx] * d * d + c3[idx] * d * d * d;
    if (L >= xs[nk - 1]) Lc = ys[nk - 1];
    if (L <= xs[0]) Lc = ys[0];
    L = Lc;
  }

  // Lab -> XYZ -> linear RGB (color_conversions.rs:58-65,171-191).
  const float cl = L * 100.0f;
  const float ca = A * 255.0f - 127.0f;
  const float cb = B * 255.0f - 127.0f;
  const float fy2 = (cl + 16.0f) / 116.0f;
  const float fx2 = ca / 500.0f + fy2;
  const float fz2 = fy2 - cb / 200.0f;
  const float X = lab_inv(fx2) * kXW;
  const float Y = (cl > kLabKE ? fy2 * fy2 * fy2 : cl / kLabK) * kYW;
  const float Z = lab_inv(fz2) * kZW;

#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = scal + 16 * (5 + r);
    float ch = X * m[0] + Y * m[1] + Z * m[2];
    if (!k.linear) {
      ch = fminf(fmaxf(ch, 0.0f), 1.0f);
      const float hi = 1.055f * expf(logf(fmaxf(ch, 1e-30f)) * kInvGamma) - 0.055f;
      ch = ch < 0.0031308f ? ch * 12.92f : hi;
    }
    store(out + r * plane_px + at, ch);
  }
}

}  // namespace finish
