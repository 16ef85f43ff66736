// Thumbnail RAW develop for Hopper (sm_90a): the CFA-aware scaled demosaic
// fused with the develop back end, one thread per output pixel, blockIdx.z
// the image of a batch, with no full-resolution intermediate.
//
// Replaces the TPU kernels imagepipe_tpu/kernels/develop_scaled.py::
// _scaled_kernel (:391) and ::_scaled_kernel_chunked (:500). They compute
// one function; the chunked form exists only to fit deep-scale windows
// into the TPU's VMEM, and this kernel serves every window size. One
// launch develops B planes of one shape class with shared geometry and
// per-image calibration: it also replaces the batch-in-the-grid launcher
// _develop_scaled_batchgrid_jit (:861) and the loop of single launches
// _develop_scaled_batch_jit (:846). A single image is the launch with
// B = 1. Per output pixel and colour c of the cropped CFA:
//
//   rgbe[c] = sum_w(v * w) / sum_w(w)   over the source window, 0 if empty
//   v = min((raw - black) / range, 1)   (levels, gofloat.rs:122-130)
//   w = max(0, (1 - dx^2) - dy^2)       (paraboloid, scaling.rs:104-107)
//
// then the shared back end (finish.cuh, the counterpart of _finish_tile).
//
// Not carried over from the Pallas kernels: the bf16 hi/lo one-hot matmul
// selection (a TPU gather workaround), the DMA windows and the ~H*W*5-byte
// per-offset weight/colour/count tables. Here each thread reads its window
// straight from the uncropped plane (row stride plus crop origin), and the
// geometry arrives as separable host tables of a few KB: the window bounds
// from/to per output row and column, dy^2 per (ky, row) and dx^2 per
// (kx, col), float32 as the reference rounds them. Every value that feeds
// floor() or the weight is computed on the host, clear of nvcc's FMA
// contraction. Sums run ky outer, kx inner, with __fmul_rn/__fadd_rn, so
// the RGBE values equal the plain PyTorch version's term for term; the
// remaining <= 1 LSB differences come from the back end's FMAs.
//
// What bounds it. Reads are ~(1 + 1/s)^2 * H * W samples at scale s, a
// little over one read of the plane (48 MB of u16 at 24 MP), mostly served
// by L1/L2 where windows of neighbouring threads overlap. At deep scales
// (160 px from 24 MP) only ~17k threads run, each walking a ~38x38 window
// in sequence, so occupancy and per-thread latency, not bytes, are the
// likely limit. Making it fast (splitting windows across threads, staging
// rows in shared memory) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "finish.cuh"

namespace {

using finish::to_float;

struct ScaledArgs {
  const void* plane;        // B uncropped sensor planes, row-major
  long long row_stride;     // elements per sensor row
  long long plane_stride;   // elements between two images' planes
  int crop_x, crop_y;       // crop origin on the sensor
  int nh, nw;               // output size before flips
  const int* from_x;        // [nw] first source column of each output column
  const int* to_x;          // [nw] last source column (inclusive)
  const int* from_y;        // [nh]
  const int* to_y;          // [nh]
  const float* dx2;         // [K_x, nw] dx^2 of window column kx
  const float* dy2;         // [K_y, nh] dy^2 of window row ky
  finish::Calib calib;      // image 0's; image b's tables follow at b * stride
  const uint8_t* pattern;   // [ph, pw] cropped CFA colours (0..3), shared
  int ph, pw;
  void* out;                // [B, 3, nh, nw] u8 or u16
};

template <typename T, typename O>
__global__ void __launch_bounds__(256) scaled_kernel(const ScaledArgs a) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= a.nw || row >= a.nh) return;
  const int b = blockIdx.z;
  const finish::Calib calib = finish::image_calib(a.calib, b);

  const T* __restrict__ plane = static_cast<const T*>(a.plane) + b * a.plane_stride
      + static_cast<long long>(a.crop_y) * a.row_stride + a.crop_x;
  const float black = calib.scal[0];
  const float range = calib.scal[1];
  const int fx = a.from_x[col], nx = a.to_x[col] - fx + 1;
  const int fy = a.from_y[row], ny = a.to_y[row] - fy + 1;

  float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float counts[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int ky = 0; ky < ny; ++ky) {
    const int y = fy + ky;
    const float dy2 = a.dy2[ky * a.nh + row];
    const T* __restrict__ src = plane + static_cast<long long>(y) * a.row_stride;
    const uint8_t* __restrict__ prow = a.pattern + (y % a.ph) * a.pw;
    for (int kx = 0; kx < nx; ++kx) {
      const int x = fx + kx;
      float w = (1.0f - a.dx2[kx * a.nw + col]) - dy2;
      w = w < 0.0f ? 0.0f : w;
      const float v = fminf((to_float(src[x]) - black) / range, 1.0f);
      const float vw = __fmul_rn(v, w);
      const int c = prow[x % a.pw];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c == k) {
          sums[k] = __fadd_rn(sums[k], vw);
          counts[k] = __fadd_rn(counts[k], w);
        }
      }
    }
  }
  float rgbe[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) rgbe[k] = counts[k] > 0.0f ? sums[k] / counts[k] : 0.0f;

  const long long plane_px = static_cast<long long>(a.nh) * a.nw;
  finish::finish_pixel(rgbe, calib, static_cast<O*>(a.out) + 3 * b * plane_px,
                       plane_px, static_cast<long long>(row) * a.nw + col);
}

template <typename T, typename O>
cudaError_t launch(const ScaledArgs& a, int batch, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((a.nw + block.x - 1) / block.x, (a.nh + block.y - 1) / block.y, batch);
  scaled_kernel<T, O><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes: develop `batch` planes [batch, H0, W0] (image b
// at plane + b * plane_stride elements) with the shared geometry tables and
// per-image calibration scal [batch, 8, 16], spline [batch, 5,
// spline_stride] into out [batch, 3, nh, nw]. in_f32: 0 = u16 planes, 1 =
// f32 planes. out_bits: 8 or 16. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int develop_scaled_batch_launch(
    const void* plane, int in_f32, int batch, long long plane_stride,
    long long row_stride, int crop_x, int crop_y, int nh, int nw,
    const int* from_x, const int* to_x, const int* from_y, const int* to_y,
    const float* dx2, const float* dy2, const float* scal, const float* spline,
    int spline_stride, int n_knots, const uint8_t* pattern, int ph, int pw,
    int linear, int out_bits, void* out, void* stream) {
  ScaledArgs a;
  a.plane = plane;
  a.row_stride = row_stride;
  a.plane_stride = plane_stride;
  a.crop_x = crop_x;
  a.crop_y = crop_y;
  a.nh = nh;
  a.nw = nw;
  a.from_x = from_x;
  a.to_x = to_x;
  a.from_y = from_y;
  a.to_y = to_y;
  a.dx2 = dx2;
  a.dy2 = dy2;
  a.calib.scal = scal;
  a.calib.spline = spline;
  a.calib.spline_stride = spline_stride;
  a.calib.n_knots = n_knots;
  a.calib.linear = linear;
  a.pattern = pattern;
  a.ph = ph;
  a.pw = pw;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nh <= 0 || nw <= 0 || batch <= 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in_f32) {
    return static_cast<int>(out_bits == 8 ? launch<float, uint8_t>(a, batch, s)
                                          : launch<float, uint16_t>(a, batch, s));
  }
  return static_cast<int>(out_bits == 8 ? launch<uint16_t, uint8_t>(a, batch, s)
                                        : launch<uint16_t, uint16_t>(a, batch, s));
}
