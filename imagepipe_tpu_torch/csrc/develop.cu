// Full-size RAW develop for Hopper (sm_90a): a block develops a 128 x 8
// tile of output pixels, four pixels along a row per thread, blockIdx.z the
// image of a batch.
//
// Replaces the TPU kernel imagepipe_tpu/kernels/develop_pallas.py::
// _develop_kernel (with its back end _finish_tile and _emit): levels,
// 3x3 neighbour-average demosaic, white balance + 3x4 camera matrix, Lab,
// tone spline on L, Lab^-1, 3x3 matrix, sRGB gamma and quantize, in one
// read of the sensor plane and one write of the planar output. One launch
// develops B planes of one shape class, each with its own calibration: it
// also replaces the batch-in-the-grid launcher
// _develop_pallas_batchgrid_jit and the loop of single launches
// _develop_pallas_batch_jit. A single image is the launch with B = 1.
// A launch may develop one width shard of the crop (x_off, out_width): the
// body of the width-sharded launchers _sp_local_develop and
// _sp_local_develop_batch, whose halo exchange and assembly are host code
// (kernels/develop.py::develop_sp). The TPU's 128-column halo is a lane
// alignment; here a shard carries the stencil's 1-column radius.
//
// What bounds it. Memory traffic is far from the limit: at 24 MP it reads
// 2 B/px of u16 sensor data and writes 3 B/px (6 B/px at 16-bit), 120 MB
// or 0.036 ms at 3.35 TB/s. Instruction issue is the limit, and the design
// removes what is not the function's own work:
//  * the block stages its tile plus a 1-pixel halo (10 x 130 samples) in
//    shared memory, converted to levels as it loads them: one read and one
//    division per input sample (finish::div_rcp, equal to the IEEE one),
//    where each of the up to 9 threads that read a sample used to load and
//    divide it again. Each thread issues its six loads before it converts
//    any, so their latencies overlap;
//  * the CFA phase (y mod ph, x mod pw) is computed once per thread and
//    stepped along its four pixels; a host table per phase (demosaic_phases
//    in kernels/develop.py) gives the colour of each of the 9 offsets (4 =
//    not summed) and, for tiles whose halo lies inside the crop, the
//    neighbour count of each colour, so those tiles take a path with no
//    validity tests (the Pallas kernel's `interior` split). Border tiles
//    count their valid neighbours;
//  * an average by a count that is a power of two is a multiply by its
//    exact reciprocal (the same rounded result as the division); other
//    counts divide;
//  * on a 2x2 CFA (Bayer) an interior pixel's two other colours are the
//    plus and cross sums (R and B sites) or the row and column pairs (G
//    sites), added in the reference's order: 8 adds and a few selects
//    where the general path tests each of the 9 offsets against 4 colours;
//  * calibration, spline knots and the phase table live in shared memory;
//  * each thread stores its four pixels with one 32-bit (8-bit output) or
//    64-bit (16-bit) store per plane where the row allows it.
// What is left is mostly the back end (finish.cuh): some 400 of the ~550
// instructions per pixel.
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
//
// A whole-image launch may cut the back end after the demosaic, Lab or the
// spline (stage_limit 1..3, finish::develop_rgb's kStageLimit), the
// counterpart of _develop_pallas_jit(stage_limit=): a profiling knob that
// splits the kernel's time by differencing the cuts. Production is 4.

#include <cuda_runtime.h>
#include <stdint.h>

#include "finish.cuh"

namespace {

using finish::to_float;

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kPix = 4;                        // output pixels per thread, along a row
constexpr int kTileW = kThreadsX * kPix;        // 128
constexpr int kTileH = kThreadsY;              // 8
constexpr int kHaloW = kTileW + 2;             // 130
constexpr int kHaloH = kTileH + 2;             // 10
constexpr int kStagePerThread = (kHaloH * kHaloW + kThreads - 1) / kThreads;   // 6
constexpr int kMaxSmem = 232448;               // 227 KB, the most a block can have

// Bytes of dynamic shared memory: the levels tile, the calibration, the
// phase table (16 bytes per CFA phase). kernels/develop.py::develop_smem_bytes
// mirrors it.
constexpr int smem_bytes(int phases, int spline_stride) {
  return 4 * kHaloH * kHaloW + 4 * finish::calib_floats(spline_stride) + 16 * phases;
}

struct DevelopArgs {
  const void* plane;        // B input planes, row-major
  long long row_stride;     // elements per input row
  long long plane_stride;   // elements between two images' planes
  int in_x0;                // input column of cropped column 0 (< 0 for a width shard)
  int crop_y;               // input row of cropped row 0
  int height, width;        // cropped size: rows, and the columns that are valid
  int x_off, out_width;     // the launch's output: cropped columns x_off .. x_off + out_width - 1
  finish::Calib calib;      // image 0's; image b's tables follow at b * stride
  const uint4* phases;      // [ph * pw] per-phase tables (demosaic_phases), shared
  int ph, pw;
  int mono;
  void* out;                // [B, 3, height, width] u8 or u16
};

// Byte i (0..15) of a phase entry: 0..8 the colour of offset i in the
// reference's order (0..3, 4 = not summed), 9..12 the neighbour count of
// colour i - 9 when all 9 offsets are valid; on a 2x2 CFA, 13 and 14 the
// colours of the two neighbour groups and 15 their kind (1: plus and cross,
// 2: row and column; 0: take the general path).
__device__ __forceinline__ int phase_byte(const uint4& e, int i) {
  const uint32_t w = i < 4 ? e.x : i < 8 ? e.y : i < 12 ? e.z : e.w;
  return static_cast<int>((w >> (8 * (i & 3))) & 0xffu);
}

// s / n, 0 for n == 0; a power-of-two n multiplies by its exact reciprocal,
// which rounds as the division does.
__device__ __forceinline__ float average(float s, int n) {
  if (n == 0) return 0.0f;
  if ((n & (n - 1)) == 0) return s * __int_as_float((127 - (__ffs(n) - 1)) << 23);
  return s / static_cast<float>(n);
}

template <typename O>
struct Packed;                 // a thread's four quantized values of one plane
template <>
struct Packed<uint8_t> {
  using T = uint32_t;
  static constexpr int kBits = 8;
};
template <>
struct Packed<uint16_t> {
  using T = unsigned long long;
  static constexpr int kBits = 16;
};

// kShard = false is the whole image: x_off = 0 and out_width = width are
// compile-time facts there. Read at run time they cost the whole-image
// launch ~1.7% on an H100 (the same arithmetic, scheduled worse), so the
// shard form is compiled apart. kStageLimit: finish::develop_rgb's cut.
template <typename T, typename O, bool kShard, int kStageLimit = 4>
__global__ void __launch_bounds__(kThreads) develop_kernel(const DevelopArgs a) {
  const int x_off = kShard ? a.x_off : 0;
  const int out_width = kShard ? a.out_width : a.width;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lv = reinterpret_cast<float*>(smem);                  // [kHaloH][kHaloW]
  float* s_cal = s_lv + kHaloH * kHaloW;                         // finish::load_calib
  uint4* s_phase = reinterpret_cast<uint4*>(s_cal + finish::calib_floats(a.calib.spline_stride));

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int b = blockIdx.z;
  const int x0 = x_off + blockIdx.x * kTileW;    // the tile's first column in the crop: every
                                                 // test below is global
  const int y0 = blockIdx.y * kTileH;
  finish::load_calib(s_cal, a.calib, b, tid, kThreads);
  for (int i = tid; i < a.ph * a.pw; i += kThreads) s_phase[i] = a.phases[i];

  // Stage the tile and its halo as levels; samples outside the crop are 0
  // and never summed. A launch reads cropped columns x_off - 1 .. x_off +
  // out_width only (a width shard's own columns and its 1-column halos),
  // clamped to the crop. Sample (yy, xx) is at element base + yy * row_stride
  // + xx of the plane: `base` may be negative (in_x0 < 0 for a shard), the
  // sum is not for any sample read, and no pointer is formed before the
  // allocation.
  {
    const T* __restrict__ plane = static_cast<const T*>(a.plane);
    const long long base = b * a.plane_stride + static_cast<long long>(a.crop_y) * a.row_stride + a.in_x0;
    const int lo = kShard ? max(0, x_off - 1) : 0;
    const int hi = kShard ? min(a.width, x_off + out_width + 1) : a.width;
    const finish::Levels lv = finish::make_levels(a.calib.scal[b * 128], a.calib.scal[b * 128 + 1]);
    T raw[kStagePerThread];
    bool in[kStagePerThread];
#pragma unroll
    for (int j = 0; j < kStagePerThread; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / kHaloW, c = e - r * kHaloW;
      const int yy = y0 - 1 + r, xx = x0 - 1 + c;
      in[j] = e < kHaloH * kHaloW && yy >= 0 && yy < a.height && xx >= lo && xx < hi;
      raw[j] = in[j] ? plane[base + static_cast<long long>(yy) * a.row_stride + xx] : T(0);
    }
#pragma unroll
    for (int j = 0; j < kStagePerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < kHaloH * kHaloW) s_lv[e] = in[j] ? finish::levels(lv, to_float(raw[j])) : 0.0f;
    }
  }
  __syncthreads();

  const int y = y0 + threadIdx.y;
  const int xs = x0 + threadIdx.x * kPix;
  const int x_end = x_off + out_width;
  if (y >= a.height || xs >= x_end) return;
  // The whole halo inside the crop: every neighbour is valid.
  const bool interior = x0 >= 1 && y0 >= 1 && x0 + kTileW < a.width && y0 + kTileH < a.height;
  const bool row_up = y >= 1, row_down = y + 1 < a.height;
  const int prow = (y % a.ph) * a.pw;
  int px = xs % a.pw;

  using P = Packed<O>;
  typename P::T q[3] = {0, 0, 0};
  const float* centre = s_lv + (threadIdx.y + 1) * kHaloW + threadIdx.x * kPix + 1;
#pragma unroll 1
  for (int i = 0; i < kPix; ++i) {
    const int x = xs + i;
    if (x >= x_end) break;
    const float* lv = centre + i;
    float rgbe[4];
    if (a.mono) {
      const float v = lv[0];
      rgbe[0] = v; rgbe[1] = v; rgbe[2] = v; rgbe[3] = 0.0f;
    } else {
      const uint4 e = s_phase[prow + px];
      const int quad = phase_byte(e, 15);
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (interior && quad != 0) {
        // A 2x2 CFA: the other two colours sum the plus and the cross (R and
        // B sites) or the row and the column neighbours (G sites), in the
        // reference's offset order; the counts, 4 or 2, divide exactly.
        const float up = lv[-kHaloW], left = lv[-1], right = lv[1], down = lv[kHaloW];
        float va, vb;
        if (quad == 1) {
          va = (((up + left) + right) + down) * 0.25f;
          vb = (((lv[-kHaloW - 1] + lv[-kHaloW + 1]) + lv[kHaloW - 1]) + lv[kHaloW + 1]) * 0.25f;
        } else {
          va = (left + right) * 0.5f;
          vb = (up + down) * 0.5f;
        }
        const int c0 = phase_byte(e, 4), ca = phase_byte(e, 13), cb = phase_byte(e, 14);
#pragma unroll
        for (int c = 0; c < 4; ++c) rgbe[c] = c == c0 ? lv[0] : c == ca ? va : c == cb ? vb : 0.0f;
      } else if (interior) {
#pragma unroll
        for (int o = 0; o < 9; ++o) {
          const int code = phase_byte(e, o);
          const float v = lv[(o / 3 - 1) * kHaloW + (o % 3 - 1)];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (code == c) s[c] += v;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) rgbe[c] = average(s[c], phase_byte(e, 9 + c));
      } else {
        int n[4] = {0, 0, 0, 0};
        const bool col_left = x >= 1, col_right = x + 1 < a.width;
#pragma unroll
        for (int o = 0; o < 9; ++o) {
          const int dy = o / 3 - 1, dx = o % 3 - 1;
          const bool valid = (dy < 0 ? row_up : dy > 0 ? row_down : true)
              && (dx < 0 ? col_left : dx > 0 ? col_right : true);
          const int code = valid ? phase_byte(e, o) : 4;
          const float v = lv[dy * kHaloW + dx];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (code == c) { s[c] += v; n[c] += 1; }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) rgbe[c] = average(s[c], n[c]);
      }
    }
    float rgb[3];
    finish::develop_rgb<kStageLimit>(rgbe, s_cal, a.calib, rgb);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      q[r] |= static_cast<typename P::T>(finish::quantize(static_cast<O*>(nullptr), rgb[r]))
              << (P::kBits * i);
    }
    px = px + 1 == a.pw ? 0 : px + 1;
  }

  // Store at output column xs - x_off: one vector store per plane where the
  // thread's four pixels are whole and aligned (out_width a multiple of 4),
  // else one store per pixel.
  const int xl = xs - x_off;
  const long long plane_px = static_cast<long long>(a.height) * out_width;
  O* out = static_cast<O*>(a.out) + 3 * b * plane_px + static_cast<long long>(y) * out_width + xl;
  const bool whole = (out_width & (kPix - 1)) == 0 && xl + kPix <= out_width;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    O* o = out + r * plane_px;
    if (whole) {
      *reinterpret_cast<typename P::T*>(o) = q[r];
    } else {
      for (int i = 0; i < kPix && xl + i < out_width; ++i) {
        o[i] = static_cast<O>((q[r] >> (P::kBits * i)) & ((1u << P::kBits) - 1u));
      }
    }
  }
}

template <typename T, typename O, bool kShard, int kStageLimit = 4>
cudaError_t launch_as(const DevelopArgs& a, int batch, cudaStream_t stream) {
  const int smem = smem_bytes(a.ph * a.pw, a.calib.spline_stride);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(develop_kernel<T, O, kShard, kStageLimit>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((a.out_width + kTileW - 1) / kTileW, (a.height + kTileH - 1) / kTileH, batch);
  develop_kernel<T, O, kShard, kStageLimit><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

// A cut (stage_limit 1..3) is a whole-image launch only.
template <typename T, typename O>
cudaError_t launch(const DevelopArgs& a, int batch, int stage_limit, cudaStream_t stream) {
  const bool whole = a.x_off == 0 && a.out_width == a.width;
  switch (stage_limit) {
    case 4:
      return whole ? launch_as<T, O, false>(a, batch, stream)
                   : launch_as<T, O, true>(a, batch, stream);
    case 3:
      return whole ? launch_as<T, O, false, 3>(a, batch, stream) : cudaErrorInvalidValue;
    case 2:
      return whole ? launch_as<T, O, false, 2>(a, batch, stream) : cudaErrorInvalidValue;
    case 1:
      return whole ? launch_as<T, O, false, 1>(a, batch, stream) : cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point for ctypes: develop `batch` planes [batch, H0, W0] (image b
// at plane + b * plane_stride elements) with per-image calibration scal
// [batch, 8, 16] and spline [batch, 5, spline_stride] into out
// [batch, 3, height, out_width]: the cropped columns x_off .. x_off +
// out_width - 1 of a crop `width` columns wide, whose column xx is input
// column in_x0 + xx and row yy input row crop_y + yy. The whole image is
// x_off = 0, out_width = width, in_x0 = crop_x. A width shard is its own
// columns with a 1-column halo each side (kernels/develop.py::develop_sp):
// in_x0 = 1 - x_off, crop_y = 0; validity and CFA phase stay those of the
// whole crop. phases: the [ph * pw] 16-byte per-phase tables of the cropped
// CFA (kernels/develop.py::demosaic_phases). in_f32: 0 = u16 planes, 1 = f32
// planes. out_bits: 8 or 16. stage_limit: 4, or a cut 1..3 of a
// whole-image launch (finish::develop_rgb). Returns the cudaError_t of the
// launch (0 = success).
extern "C" int develop_batch_launch(const void* plane, int in_f32, int batch,
                                    long long plane_stride, long long row_stride,
                                    int in_x0, int crop_y, int height, int width,
                                    int x_off, int out_width,
                                    const float* scal, const float* spline,
                                    int spline_stride, int n_knots,
                                    const void* phases, int ph, int pw, int mono,
                                    int linear, int out_bits, int stage_limit, void* out,
                                    void* stream) {
  DevelopArgs a;
  a.plane = plane;
  a.row_stride = row_stride;
  a.plane_stride = plane_stride;
  a.in_x0 = in_x0;
  a.crop_y = crop_y;
  a.height = height;
  a.width = width;
  a.x_off = x_off;
  a.out_width = out_width;
  a.calib.scal = scal;
  a.calib.spline = spline;
  a.calib.spline_stride = spline_stride;
  a.calib.n_knots = n_knots;
  a.calib.linear = linear;
  a.phases = static_cast<const uint4*>(phases);
  a.ph = ph;
  a.pw = pw;
  a.mono = mono;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (height <= 0 || width <= 0 || batch <= 0 || batch > 65535 || ph <= 0 || pw <= 0
      || x_off < 0 || out_width <= 0 || x_off + out_width > width || crop_y < 0) {
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
