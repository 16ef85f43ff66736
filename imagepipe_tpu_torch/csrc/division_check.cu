// Proof, on the card, that finish.cuh's div_rcp (a reciprocal multiply with
// one FMA correction) gives the IEEE quotient __fdiv_rn gives, for the
// inputs the develop kernels feed it. Not on any develop path: chip_smoke.py
// phase 1 and the card tests run it through kernels/develop.py::
// division_mismatches before they trust the kernels.
//
//  * every constant divisor of the back end (finish::div_const<K> for each
//    K < finish::kDivisors), over all 2^32 float bit patterns of the
//    dividend;
//  * the levels of each (black, range) pair given, over all 65,536 u16 raws,
//    or over all 2^32 float raws.
// Two results agree when their bits are equal or both are NaN.

#include <cuda_runtime.h>
#include <stdint.h>

#include "finish.cuh"

namespace {

__device__ __forceinline__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
}

// Count, in bad[K..], the divisors K.. for which div_const<K>(x) is not
// __fdiv_rn(x, divisor(K)).
template <int K>
__device__ __forceinline__ void check_constants(float x, unsigned* bad) {
  bad[K] += same(finish::div_const<K>(x), __fdiv_rn(x, finish::divisor(K))) ? 0u : 1u;
  if constexpr (K + 1 < finish::kDivisors) check_constants<K + 1>(x, bad);
}

// checked[0] counts the dividends tried (2^32 when the kernel ran to its end).
__global__ void constants_kernel(unsigned long long* mismatches, unsigned long long* checked) {
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  unsigned bad[finish::kDivisors] = {};
  unsigned long long tried = 0;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32); i += stride) {
    ++tried;
    check_constants<0>(__uint_as_float(static_cast<unsigned>(i)), bad);
  }
#pragma unroll
  for (int k = 0; k < finish::kDivisors; ++k) {
    if (bad[k]) atomicAdd(mismatches + k, static_cast<unsigned long long>(bad[k]));
  }
  atomicAdd(checked, tried);
}

// pairs [n][2]: (black, range); raws: 2^16 u16 values, or 2^32 float bit
// patterns when f32. mismatches[p] counts pair p's; checked[0] the
// (pair, raw) inputs tried.
__global__ void levels_kernel(const float* pairs, int n, int f32, unsigned long long* mismatches,
                              unsigned long long* checked) {
  unsigned long long tried = 0;
  const int bits = f32 ? 32 : 16;
  const unsigned long long total = static_cast<unsigned long long>(n) << bits;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    ++tried;
    const int p = static_cast<int>(i >> bits);
    const unsigned v = static_cast<unsigned>(i & ((1ull << bits) - 1));
    const float raw = f32 ? __uint_as_float(v) : static_cast<float>(v);
    const finish::Levels l = finish::make_levels(pairs[2 * p], pairs[2 * p + 1]);
    const float x = raw - l.black;
    if (!same(finish::div_rcp(x, l.range, l.rcp, l.lo), __fdiv_rn(x, l.range))) {
      atomicAdd(mismatches + p, 1ull);
    }
  }
  atomicAdd(checked, tried);
}

}  // namespace

// C entry points for ctypes. mismatches: zeroed device counters
// [finish::kDivisors] or [n]; checked: one zeroed counter. Return the
// cudaError_t of the launch.
extern "C" int division_check_constants(unsigned long long* mismatches,
                                        unsigned long long* checked, void* stream) {
  constants_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(mismatches, checked);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int division_check_levels(const float* pairs, int n, int f32,
                                     unsigned long long* mismatches,
                                     unsigned long long* checked, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  levels_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(pairs, n, f32, mismatches,
                                                                         checked);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int division_check_count() { return finish::kDivisors; }
