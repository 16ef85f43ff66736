// Thumbnail RAW develop for Hopper (sm_90a): the CFA-aware scaled demosaic
// fused with the develop back end, blockIdx.z the image of a batch, with no
// full-resolution intermediate.
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
// then the shared back end (finish.cuh, the counterpart of _finish_tile),
// whole or cut after the demosaic, Lab or the spline (stage_limit 1..3, as
// _scaled_kernel(stage_limit=); a profiling knob, production is 4).
//
// Not carried over from the Pallas kernels: the bf16 hi/lo one-hot matmul
// selection (a TPU gather workaround), the DMA windows and the ~H*W*5-byte
// per-offset weight/colour/count tables. The geometry arrives as separable
// host tables of a few KB: the window bounds from/to per output row and
// column, dy^2 per (ky, row) and dx^2 per (kx, col), float32 as the
// reference rounds them. Every value that feeds floor() or the weight is
// computed on the host, clear of nvcc's FMA contraction.
//
// What bounds it, and the design. The samples of all windows are a little
// over one read of the plane (48 MB of u16 at 24 MP, 0.014 ms), so bytes
// are not the limit: per-sample instructions, the back end per output pixel
// and, at deep scales, too few threads are. So:
//  * each output pixel's window is split across sx lanes of one warp where
//    windows are wide (window_split in kernels/develop_scaled.py, from the
//    window width only), each lane taking every sx-th column of each window
//    row: at 24 MP -> 160 a 39 x 39 window is 8 lanes of ~5 columns, so
//    ~136k threads run instead of ~17k, and the lanes of a window row read
//    neighbouring samples. Each lane sums its share in ky-outer, kx-inner
//    order and the lanes' partial sums are added in a fixed tree
//    (shuffles), so the order depends on the geometry only: batched
//    launches equal single launches bit for bit. With one lane (windows
//    under 8 columns: -> 1024 and -> 2048 at 24 MP) the sums equal the
//    plain PyTorch version's term for term (same order, rounded products
//    and adds); with several, <= 1 LSB from it;
//  * per window sample the thread does the function's own work and little
//    else: the levels division is finish::div_rcp (a reciprocal multiply
//    and one FMA, proven equal to the IEEE division), the CFA colour steps
//    along the row from a phase computed once per thread (no modulo), and
//    1 - dx^2 of the tile's columns comes from shared memory;
//  * the calibration lives in shared memory; with one lane per pixel each
//    thread runs the back end on its own pixel, with several the back end
//    runs once per pixel, on the block's threads in turn.
// Staging the block's source rows as levels in shared memory (one division
// per source sample) was tried and lost at -> 1024 and -> 2048: the copy,
// the conversion pass and three barriers per block cost more than the ~1.4
// reads per sample they save (PERF.md).
// Numerics: products and sums are __fmul_rn/__fadd_rn; the back end's FMA
// contractions leave the cross-path contract of kernels/develop.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "finish.cuh"

namespace {

using finish::to_float;

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;               // 227 KB, the most a block can have

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
  const float* dx2;         // [kx, nw] dx^2 of window column kx
  const float* dy2;         // [ky, nh] dy^2 of window row ky
  finish::Calib calib;      // image 0's; image b's tables follow at b * stride
  const uint8_t* pattern;   // [ph, pw] cropped CFA colours (0..3), shared
  int ph, pw;
  int kx;                   // rows of dx2: the widest window
  int sx;                   // lanes per output pixel (a power of 2, <= 32)
  int tc, tr;               // output columns and rows per block
  void* out;                // [B, 3, nh, nw] u8 or u16
};

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// Floats per output column of the staged 1 - dx^2 ([tc][stride]): odd, so
// that lanes reading one column's window (split) or one window column of
// many output columns (no split) hit distinct banks.
__host__ __device__ constexpr int dx_stride(int kx) { return kx | 1; }

// Offsets into the block's dynamic shared memory; kernels/develop_scaled.py::
// scaled_smem_bytes mirrors the total.
struct Layout {
  int cal, rgbe, omdx, pat, total;
};

__host__ __device__ constexpr Layout layout(const ScaledArgs& a) {
  Layout l{};
  l.cal = 0;
  l.rgbe = l.cal + 4 * finish::calib_floats(a.calib.spline_stride);
  l.omdx = l.rgbe + 16 * (a.tc * a.tr);
  l.pat = l.omdx + align16(4 * dx_stride(a.kx) * a.tc);
  l.total = l.pat + align16(a.ph * a.pw);
  return l;
}

template <int kStageLimit, typename O>
__device__ __forceinline__ void finish_store(const float rgbe[4], const float* cal,
                                             const finish::Calib& k, O* out, long long plane_px,
                                             long long at) {
  float rgb[3];
  finish::develop_rgb<kStageLimit>(rgbe, cal, k, rgb);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out[r * plane_px + at] = static_cast<O>(finish::quantize(static_cast<O*>(nullptr), rgb[r]));
  }
}

// kStageLimit: finish::develop_rgb's cut (4: the whole chain).
template <typename T, typename O, int kStageLimit = 4>
__global__ void __launch_bounds__(kThreads) scaled_kernel(const ScaledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a);
  float* s_cal = reinterpret_cast<float*>(smem + L.cal);
  float* s_rgbe = reinterpret_cast<float*>(smem + L.rgbe);   // [tc * tr][4]
  float* s_omdx = reinterpret_cast<float*>(smem + L.omdx);   // [tc][dx_stride(kx)] 1 - dx^2
  uint8_t* s_pat = smem + L.pat;                             // [ph][pw]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * a.tc;
  const int r0 = blockIdx.y * a.tr;
  finish::load_calib(s_cal, a.calib, b, tid, kThreads);
  for (int i = tid; i < a.ph * a.pw; i += kThreads) s_pat[i] = a.pattern[i];
  const int dxs = dx_stride(a.kx);
  for (int i = tid; i < a.kx * a.tc; i += kThreads) {
    const int k = i / a.tc, col = c0 + i % a.tc;
    // 1 - dx^2, the weight's first term, as the plain version rounds it.
    s_omdx[(i % a.tc) * dxs + k] = col < a.nw ? 1.0f - a.dx2[k * a.nw + col] : 0.0f;
  }

  // This thread's output pixel, its lane in the pixel's group, its window.
  const int lanes = a.sx;
  const int g = tid / lanes, lane = tid % lanes;
  const int oc = g % a.tc, orow = g / a.tc;
  const int col = c0 + oc, row = r0 + orow;
  const bool active = col < a.nw && row < a.nh;
  const int fx = active ? a.from_x[col] : 0;
  const int nx = active ? a.to_x[col] - fx + 1 : 0;
  const int fy = active ? a.from_y[row] : 0;
  const int ny = active ? a.to_y[row] - fy + 1 : 0;
  const T* __restrict__ plane = static_cast<const T*>(a.plane) + b * a.plane_stride
      + static_cast<long long>(a.crop_y) * a.row_stride + a.crop_x;
  const finish::Levels lv = finish::make_levels(a.calib.scal[b * 128], a.calib.scal[b * 128 + 1]);
  // CFA phase of the lane's first sample, stepped by sx along a row and by
  // one down the window.
  const int xph0 = (fx + lane) % a.pw, xstep = a.sx % a.pw;
  int yph = fy % a.ph;
  __syncthreads();

  float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float counts[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* omdx = s_omdx + oc * dxs;
  for (int ky = 0; ky < ny; ++ky) {
    const T* __restrict__ src = plane + static_cast<long long>(fy + ky) * a.row_stride + fx;
    const uint8_t* prow = s_pat + yph * a.pw;
    const float dy2 = a.dy2[ky * a.nh + row];
    int xph = xph0;
    for (int kx = lane; kx < nx; kx += a.sx) {
      const float v = finish::levels(lv, to_float(src[kx]));
      float w = omdx[kx] - dy2;
      w = w < 0.0f ? 0.0f : w;
      const float vw = __fmul_rn(v, w);
      const int c = prow[xph];
      xph += xstep;
      if (xph >= a.pw) xph -= a.pw;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (c == q) {
          sums[q] = __fadd_rn(sums[q], vw);
          counts[q] = __fadd_rn(counts[q], w);
        }
      }
    }
    if (++yph == a.ph) yph = 0;
  }

  const long long plane_px = static_cast<long long>(a.nh) * a.nw;
  O* out = static_cast<O*>(a.out) + 3 * b * plane_px;
  float rgbe[4];
  if (lanes == 1) {
    if (!active) return;
#pragma unroll
    for (int k = 0; k < 4; ++k) rgbe[k] = counts[k] > 0.0f ? sums[k] / counts[k] : 0.0f;
    finish_store<kStageLimit>(rgbe, s_cal, a.calib, out, plane_px,
                              static_cast<long long>(row) * a.nw + col);
    return;
  }

  // Add the lanes' partial sums in a fixed tree; lane 0 holds the window's.
  for (int off = lanes / 2; off > 0; off /= 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sums[k] = __fadd_rn(sums[k], __shfl_down_sync(0xffffffffu, sums[k], off, lanes));
      counts[k] = __fadd_rn(counts[k], __shfl_down_sync(0xffffffffu, counts[k], off, lanes));
    }
  }
  if (active && lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s_rgbe[4 * g + k] = counts[k] > 0.0f ? sums[k] / counts[k] : 0.0f;
  }
  __syncthreads();
  // The back end, one output pixel per thread in turn.
  for (int o = tid; o < a.tc * a.tr; o += kThreads) {
    const int ocol = c0 + o % a.tc, orow2 = r0 + o / a.tc;
    if (ocol >= a.nw || orow2 >= a.nh) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) rgbe[k] = s_rgbe[4 * o + k];
    finish_store<kStageLimit>(rgbe, s_cal, a.calib, out, plane_px,
                              static_cast<long long>(orow2) * a.nw + ocol);
  }
}

template <typename T, typename O, int kStageLimit>
cudaError_t launch_as(const ScaledArgs& a, int batch, cudaStream_t stream) {
  const int smem = layout(a).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scaled_kernel<T, O, kStageLimit>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.nw + a.tc - 1) / a.tc, (a.nh + a.tr - 1) / a.tr, batch);
  scaled_kernel<T, O, kStageLimit><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch(const ScaledArgs& a, int batch, int stage_limit, cudaStream_t stream) {
  switch (stage_limit) {
    case 4: return launch_as<T, O, 4>(a, batch, stream);
    case 3: return launch_as<T, O, 3>(a, batch, stream);
    case 2: return launch_as<T, O, 2>(a, batch, stream);
    case 1: return launch_as<T, O, 1>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// C entry point for ctypes: develop `batch` planes [batch, H0, W0] (image b
// at plane + b * plane_stride elements) with the shared geometry tables and
// per-image calibration scal [batch, 8, 16], spline [batch, 5,
// spline_stride] into out [batch, 3, nh, nw]. The launch plan (sx, tc, tr)
// is kernels/develop_scaled.py::scaled_plan's: sx lanes of one warp per
// output pixel, tc * tr * sx == 256. in_f32: 0 = u16 planes, 1 =
// f32 planes. out_bits: 8 or 16. stage_limit: 4, or a cut 1..3
// (finish::develop_rgb). Returns the cudaError_t of the launch (0 =
// success).
extern "C" int develop_scaled_batch_launch(
    const void* plane, int in_f32, int batch, long long plane_stride,
    long long row_stride, int crop_x, int crop_y, int nh, int nw,
    const int* from_x, const int* to_x, const int* from_y, const int* to_y,
    const float* dx2, const float* dy2, int kx, const float* scal, const float* spline,
    int spline_stride, int n_knots, const uint8_t* pattern, int ph, int pw,
    int sx, int tc, int tr, int linear, int out_bits, int stage_limit, void* out,
    void* stream) {
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
  a.kx = kx;
  a.calib.scal = scal;
  a.calib.spline = spline;
  a.calib.spline_stride = spline_stride;
  a.calib.n_knots = n_knots;
  a.calib.linear = linear;
  a.pattern = pattern;
  a.ph = ph;
  a.pw = pw;
  a.sx = sx;
  a.tc = tc;
  a.tr = tr;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nh <= 0 || nw <= 0 || batch <= 0 || batch > 65535 || ph <= 0 || pw <= 0 || kx <= 0
      || !is_pow2(sx) || sx > 32 || tc <= 0 || tr <= 0 || tc * tr * sx != kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k = stage_limit;
  if (in_f32) {
    return static_cast<int>(out_bits == 8 ? launch<float, uint8_t>(a, batch, k, s)
                                          : launch<float, uint16_t>(a, batch, k, s));
  }
  return static_cast<int>(out_bits == 8 ? launch<uint16_t, uint8_t>(a, batch, k, s)
                                        : launch<uint16_t, uint16_t>(a, batch, k, s));
}
