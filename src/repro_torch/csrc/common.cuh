// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded from Python
// with ctypes): the launch function takes raw device pointers, sizes and
// the CUDA stream, launches on that stream, never synchronises and
// never allocates, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

using bf16 = __nv_bfloat16;

// Masked scores use -1e30, not -inf, exactly as the reference kernels
// do: a fully masked tile then gives exp(0) = 1 weights that a later
// real score multiplies away, and never a NaN.
constexpr float kNegInf = -1e30f;
constexpr float kMinDenom = 1e-30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// N consecutive bf16 values (N = 2 or 4, 4- or 8-byte aligned) to fp32.
template <int N>
__device__ __forceinline__ void load_bf16(const bf16* __restrict__ p,
                                          float (&out)[N]) {
  static_assert(N == 2 || N == 4, "load_bf16 takes 2 or 4 values");
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  }
}

}  // namespace repro
