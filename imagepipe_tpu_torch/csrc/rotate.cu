// Rotated (affine) resample for Hopper (sm_90a): the resampler behind
// rotatecrop, one thread per output pixel computing all C channels.
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
// 6 x nw floats, a few KB) are the host's float32 values with two
// roundings (scaling.rotated_geometry); the device does one add of a row
// and a column term before each floor. K_x, K_y are _transform_impl's
// static bounds, so degenerate geometry (an output extent of 1, a zero
// step, infinite or NaN skips) gives the JAX package's answer; an empty or
// inverted window has no valid sample and gives 0. Every operation is an
// explicit round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn): nvcc contracts nothing, and the result equals the plain
// PyTorch version (kernels/rotate.py) bit for bit.
//
// Not carried over from the Pallas kernel: the one-hot bf16 hi/mid/lo MXU
// selection (a TPU gather workaround), the 8/128-aligned DMA windows and
// their double buffer, the D_g/D_y bucketing for jit reuse, the
// lane-replicated row table, the TC = 64/128 cost model, the whole-tile
// empty early-out and rotate_plan's tightened K with its gather fallback.
// Here each thread reads its window straight from the source in device
// memory, and the kernel takes every non-CFA geometry.
//
// What bounds it: bytes. At 24 MP (6000 x 4000, C = 4) rotated 0.05 and
// cropped 0.05 it reads a 384 MB source once and writes a 427 MB output:
// ~0.24 ms at 3.35 TB/s, against ~6 GFLOP (16 samples of ~14 operations
// per pixel), ~0.09 ms at 67 TFLOP/s. Neighbouring threads read source
// addresses along the rotated row, so loads coalesce less well as the
// angle grows; staging the source window in shared memory is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct RotateArgs {
  const float* src;     // [C, H, W]
  int height, width;    // source size
  const float* rows;    // [6, nh] row terms
  const float* cols;    // [6, nw] column terms
  int nh, nw;           // output size
  float sxx, syy;       // skips dividing dx and dy
  int k_x, k_y;         // window bounds
  float* out;           // [C, nh, nw]
};

__device__ __forceinline__ int sat_idx(float v, int maxv) {
  const float f = floorf(v);
  if (!(f >= 0.0f)) return 0;                 // NaN, negative
  return f >= static_cast<float>(maxv) ? maxv : static_cast<int>(f);
}

template <int C>
__global__ void __launch_bounds__(256) rotate_kernel(const RotateArgs a) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= a.nw || row >= a.nh) return;

  const float* __restrict__ rows = a.rows;
  const float* __restrict__ cols = a.cols;
  const int nh = a.nh, nw = a.nw;
  const int fy = sat_idx(__fadd_rn(rows[0 * nh + row], cols[0 * nw + col]), a.height - 1);
  const int ty = sat_idx(__fadd_rn(rows[1 * nh + row], cols[1 * nw + col]), a.height - 1);
  const int fx = sat_idx(__fadd_rn(rows[2 * nh + row], cols[2 * nw + col]), a.width - 1);
  const int tx = sat_idx(__fadd_rn(rows[3 * nh + row], cols[3 * nw + col]), a.width - 1);
  const float cy = __fadd_rn(rows[4 * nh + row], cols[4 * nw + col]);
  const float cx = __fadd_rn(rows[5 * nh + row], cols[5 * nw + col]);

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

  const long long o = static_cast<long long>(row) * nw + col;
  const long long out_plane = static_cast<long long>(nh) * nw;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    a.out[ch * out_plane + o] = count > 0.0f ? __fdiv_rn(sums[ch], count) : 0.0f;
  }
}

template <int C>
cudaError_t launch(const RotateArgs& a, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((a.nw + block.x - 1) / block.x, (a.nh + block.y - 1) / block.y);
  rotate_kernel<C><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes: resample src [components, height, width] f32
// into out [components, nh, nw] f32 with the row tables rows [6, nh] and
// column tables cols [6, nw] (scaling.rotated_geometry), skips sxx, syy and
// window bounds k_x, k_y. Returns the cudaError_t of the launch (0 =
// success).
extern "C" int rotate_resample_launch(
    const float* src, int components, int height, int width, const float* rows,
    const float* cols, int nh, int nw, float sxx, float syy, int k_x, int k_y,
    float* out, void* stream) {
  RotateArgs a;
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
  a.out = out;
  if (nh <= 0 || nw <= 0 || height <= 0 || width <= 0 || k_x <= 0 || k_y <= 0 ||
      (nh + 7) / 8 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (components) {
    case 1: return static_cast<int>(launch<1>(a, s));
    case 2: return static_cast<int>(launch<2>(a, s));
    case 3: return static_cast<int>(launch<3>(a, s));
    case 4: return static_cast<int>(launch<4>(a, s));
    case 5: return static_cast<int>(launch<5>(a, s));
    case 6: return static_cast<int>(launch<6>(a, s));
    case 7: return static_cast<int>(launch<7>(a, s));
    case 8: return static_cast<int>(launch<8>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
