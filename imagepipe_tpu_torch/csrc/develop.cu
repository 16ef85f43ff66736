// Full-size RAW develop for Hopper (sm_90a): one thread per output pixel.
//
// Replaces the TPU kernel imagepipe_tpu/kernels/develop_pallas.py::
// _develop_kernel (with its back end _finish_tile and _emit): levels,
// 3x3 neighbour-average demosaic, white balance + 3x4 camera matrix, Lab,
// tone spline on L, Lab^-1, 3x3 matrix, sRGB gamma and quantize, in one
// read of the sensor plane and one write of the planar output.
//
// What bounds it. Memory traffic is the floor: at 24 MP it reads 2 B/px of
// u16 sensor data and writes 3 B/px (6 B/px at 16-bit), 120 MB or 0.036 ms
// at 3.35 TB/s. So there is no staging: each thread reads its 3x3
// neighbourhood straight from the uncropped plane (row stride plus crop
// origin), neighbouring threads read neighbouring addresses, and the
// overlap between neighbourhoods is served by L1/L2. The Pallas kernel's
// 8/128-element halo padding was there for TPU DMA alignment only. This
// simple form is far above that floor (about 1.3 ms at 24 MP on an H100
// SXM at 700 W), which points at instruction issue rather than memory --
// six accurate expf/logf, some fifteen IEEE divisions and eighteen integer
// modulos per pixel. Not yet profiled; later tuning starts there.
//
// Semantics (demosaic.rs, demosaic_full.py:44-51 of the JAX package):
//  * a neighbour is valid iff it lies inside the CROPPED image, even where
//    the sensor has data beyond the crop;
//  * the colour at (y, x) is pattern[y mod ph][x mod pw] of the cropped CFA;
//  * the centre's own colour takes the centre sample; every other colour
//    averages its valid neighbours among the 8, or is 0 with none;
//  * mono replicates the sample.
// The neighbour sums are accumulated in the reference's offset order, so
// they equal the plain PyTorch form term for term.
//
// Numerics: the back end is csrc/finish.cuh, shared with the scaled
// kernel (develop_scaled.cu). nvcc contracts a + b*c into FMA, as XLA does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "finish.cuh"

namespace {

using finish::to_float;

struct DevelopArgs {
  const void* plane;        // uncropped sensor plane, row-major
  long long row_stride;     // elements per sensor row
  int crop_x, crop_y;       // crop origin on the sensor
  int height, width;        // cropped size = output size before flips
  finish::Calib calib;
  const uint8_t* pattern;   // [ph, pw] cropped CFA colours (0..3)
  int ph, pw;
  int mono;
  void* out;                // [3, height, width] u8 or u16
};

template <typename T, typename O>
__global__ void __launch_bounds__(256) develop_kernel(const DevelopArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.width || y >= a.height) return;

  const T* __restrict__ plane = static_cast<const T*>(a.plane)
      + static_cast<long long>(a.crop_y) * a.row_stride + a.crop_x;
  const float black = a.calib.scal[0];
  const float range = a.calib.scal[1];

  float rgbe[4];
  if (a.mono) {
    const float v = fminf((to_float(plane[static_cast<long long>(y) * a.row_stride + x]) - black) / range, 1.0f);
    rgbe[0] = v; rgbe[1] = v; rgbe[2] = v; rgbe[3] = 0.0f;
  } else {
    const uint8_t* __restrict__ pattern = a.pattern;
    const int c0 = pattern[(y % a.ph) * a.pw + (x % a.pw)];
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float n[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= a.height) continue;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = x + dx;
        if (xx < 0 || xx >= a.width) continue;
        const int oc = pattern[(yy % a.ph) * a.pw + (xx % a.pw)];
        // Same-colour neighbours are discarded: the centre keeps its own
        // sample (demosaic.rs:87).
        if (oc == c0 && (dy != 0 || dx != 0)) continue;
        const float v = fminf((to_float(plane[static_cast<long long>(yy) * a.row_stride + xx]) - black) / range, 1.0f);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (oc == c) { s[c] += v; n[c] += 1.0f; }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) rgbe[c] = n[c] > 0.0f ? s[c] / n[c] : 0.0f;
  }

  finish::finish_pixel(rgbe, a.calib, static_cast<O*>(a.out),
                       static_cast<long long>(a.height) * a.width,
                       static_cast<long long>(y) * a.width + x);
}

template <typename T, typename O>
cudaError_t launch(const DevelopArgs& a, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((a.width + block.x - 1) / block.x, (a.height + block.y - 1) / block.y);
  develop_kernel<T, O><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes. in_f32: 0 = u16 plane, 1 = f32 plane.
// out_bits: 8 or 16. Returns the cudaError_t of the launch (0 = success).
extern "C" int develop_launch(const void* plane, int in_f32, long long row_stride,
                              int crop_x, int crop_y, int height, int width,
                              const float* scal, const float* spline,
                              int spline_stride, int n_knots,
                              const uint8_t* pattern, int ph, int pw, int mono,
                              int linear, int out_bits, void* out, void* stream) {
  DevelopArgs a;
  a.plane = plane;
  a.row_stride = row_stride;
  a.crop_x = crop_x;
  a.crop_y = crop_y;
  a.height = height;
  a.width = width;
  a.calib.scal = scal;
  a.calib.spline = spline;
  a.calib.spline_stride = spline_stride;
  a.calib.n_knots = n_knots;
  a.calib.linear = linear;
  a.pattern = pattern;
  a.ph = ph;
  a.pw = pw;
  a.mono = mono;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (height <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (in_f32) {
    return static_cast<int>(out_bits == 8 ? launch<float, uint8_t>(a, s)
                                          : launch<float, uint16_t>(a, s));
  }
  return static_cast<int>(out_bits == 8 ? launch<uint16_t, uint8_t>(a, s)
                                        : launch<uint16_t, uint16_t>(a, s));
}
