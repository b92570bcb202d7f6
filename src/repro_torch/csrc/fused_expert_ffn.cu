// Top-k expert FFN read straight from the stacked expert store.
//
// Replaces the TPU kernel repro/kernels/tiered_gather.py
// (fused_expert_ffn / _expert_ffn_kernel):
//
//   out[b] = sum_k wts[b,k] * (silu(x_b Wg[e]) * (x_b Wu[e])) Wd[e],
//   e = ids[b,k],
//
// in fp32, cast to bf16 at the end; a duplicated id adds both
// contributions, and only the routed experts' weights are read.  Pallas
// ran a (B, K) grid with K sequential and carried the sum in VMEM; the
// blocks of a Hopper grid run in no order, so the work is two passes
// behind one entry point:
//
//  pass 1 (up), grid (F / kUpCols, B*K): the block stages x[b] as fp32
//    in shared memory; each thread owns 8 neighbouring columns f, read
//    as one 16-byte load per row of Wg and of Wu, and the block's
//    kUpRows row groups split D.  The groups' partial sums meet in
//    shared memory and h = silu(g) * u goes to an fp32 scratch
//    (B, K, F).
//  pass 2 (down), grid (D / kDownCols, B): the block stages
//    wts[b,k] * h[b,k,:] for every k in shared memory; each thread owns
//    8 columns d of a narrow tile and walks k in order over its rows f
//    of Wd[e_k]; the row groups' partials meet in shared memory and the
//    sum is stored as bf16.
//
// Bound on the H100: device-memory bytes.  The routed experts' weights,
// 3 * D * F * 2 bytes each (9.4 MB at qwen3-moe-30b-a3b), dwarf x, h
// and the output, and each weight is used for one token's product.  At
// batch 4, top-8 the passes have 192 and 256 blocks for 132 SMs.  This
// first version reads each (token, slot)'s expert on its own, so an
// expert routed from several tokens is read several times (32 reads
// against the 28-32 distinct experts a batch of 4 routes); grouping the
// tokens by expert, and wgmma at larger batch, are later work.
//
// An id outside [0, E) reads nothing and makes its token's output NaN.
//
// Over an expert range (an expert shard of a mesh): the weight pointers
// are the shard's (e_hi - e_lo, D, F) / (.., F, D) stacks, and a
// (token, slot) whose id lies outside [e_lo, e_hi) reads nothing and
// adds 0.  With out_f32 the sum is stored as an fp32 (B, D) partial, so
// that the shards' partials are summed before the one rounding to bf16.
#include "common.cuh"

namespace {

using repro::bf16;

constexpr int kThreads = 256;
constexpr int kVec = 8;                              // bf16 per 16 bytes
constexpr int kUpCols = 128;                         // pass 1: F per block
constexpr int kUpRows = kThreads / (kUpCols / kVec);        // 16
constexpr int kDownCols = 32;                        // pass 2: D per block
constexpr int kDownRows = kThreads / (kDownCols / kVec);    // 64
constexpr int kUnroll = 4;           // rows in flight per thread and matrix

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[kVec]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// acc[i] += s * w[i] over the 8 values of one 16-byte load.
__device__ __forceinline__ void fma8(float s, const uint4& raw,
                                     float (&acc)[kVec]) {
  float w[kVec];
  unpack8(raw, w);
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = fmaf(s, w[i], acc[i]);
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Pass 1.  Shared memory: x[b] (D floats), then the (kUpRows, kUpCols)
// partials of g and of u.
__global__ void __launch_bounds__(kThreads)
expert_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                 const bf16* __restrict__ wu,
                 const int32_t* __restrict__ ids, float* __restrict__ h,
                 int K, int D, int F, int E, int e_lo, int e_hi) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* red_g = smem + D;
  float* red_u = red_g + kUpRows * kUpCols;
  const int bk = blockIdx.y;
  const int b = bk / K;
  const int e = __ldg(ids + bk);
  const bool valid = e >= 0 && e < E;
  const int tid = threadIdx.x;
  if (valid && (e < e_lo || e >= e_hi)) {
    // another shard's expert: nothing read; pass 2 skips the slot
    for (int c = tid; c < kUpCols; c += kThreads) {
      const int f = blockIdx.x * kUpCols + c;
      if (f < F) h[static_cast<int64_t>(bk) * F + f] = 0.f;
    }
    return;
  }
  for (int d = tid; d < D; d += kThreads)
    xs[d] = __bfloat162float(x[static_cast<int64_t>(b) * D + d]);
  __syncthreads();

  const int grp = tid % (kUpCols / kVec), row = tid / (kUpCols / kVec);
  const int f0 = blockIdx.x * kUpCols + grp * kVec;
  float ag[kVec] = {}, au[kVec] = {};
  if (valid && f0 < F) {
    const int64_t base = static_cast<int64_t>(e - e_lo) * D * F + f0;
    const bf16* pg = wg + base;
    const bf16* pu = wu + base;
    int d = row;
    for (; d + (kUnroll - 1) * kUpRows < D; d += kUnroll * kUpRows) {
      uint4 rg[kUnroll], ru[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t o = static_cast<int64_t>(d + j * kUpRows) * F;
        rg[j] = ld16(pg + o);
        ru[j] = ld16(pu + o);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const float xv = xs[d + j * kUpRows];
        fma8(xv, rg[j], ag);
        fma8(xv, ru[j], au);
      }
    }
    for (; d < D; d += kUpRows) {
      const int64_t o = static_cast<int64_t>(d) * F;
      fma8(xs[d], ld16(pg + o), ag);
      fma8(xs[d], ld16(pu + o), au);
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    red_g[row * kUpCols + grp * kVec + i] = ag[i];
    red_u[row * kUpCols + grp * kVec + i] = au[i];
  }
  __syncthreads();
  for (int c = tid; c < kUpCols; c += kThreads) {
    const int f = blockIdx.x * kUpCols + c;
    if (f >= F) continue;
    float g = 0.f, u = 0.f;
    for (int r = 0; r < kUpRows; ++r) {
      g += red_g[r * kUpCols + c];
      u += red_u[r * kUpCols + c];
    }
    h[static_cast<int64_t>(bk) * F + f] =
        valid ? g / (1.f + expf(-g)) * u : nan_f();
  }
}

// Pass 2.  Shared memory: wts[b,k] * h[b,k,:] (K*F floats), then the
// (kDownRows, kDownCols) partials.  Stores bf16 to out, or the fp32 sum
// to out_f32 where it is given.
__global__ void __launch_bounds__(kThreads)
expert_down_kernel(const float* __restrict__ h, const bf16* __restrict__ wd,
                   const int32_t* __restrict__ ids,
                   const float* __restrict__ wts, bf16* __restrict__ out,
                   float* __restrict__ out_f32, int K, int D, int F, int E,
                   int e_lo, int e_hi) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* red = smem + K * F;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t hb = static_cast<int64_t>(b) * K * F;
  for (int i = tid; i < K * F; i += kThreads)
    hs[i] = __ldg(wts + b * K + i / F) * h[hb + i];
  __syncthreads();

  const int grp = tid % (kDownCols / kVec), row = tid / (kDownCols / kVec);
  const int d0 = blockIdx.x * kDownCols + grp * kVec;
  float acc[kVec] = {};
  if (d0 < D) {
    for (int k = 0; k < K; ++k) {
      const int e = __ldg(ids + b * K + k);
      if (e < 0 || e >= E) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = nan_f();
        continue;
      }
      if (e < e_lo || e >= e_hi) continue;          // another shard's
      const bf16* p = wd + static_cast<int64_t>(e - e_lo) * F * D + d0;
      const float* hk = hs + k * F;
      int f = row;
      for (; f + (kUnroll - 1) * kDownRows < F; f += kUnroll * kDownRows) {
        uint4 r[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          r[j] = ld16(p + static_cast<int64_t>(f + j * kDownRows) * D);
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) fma8(hk[f + j * kDownRows], r[j], acc);
      }
      for (; f < F; f += kDownRows)
        fma8(hk[f], ld16(p + static_cast<int64_t>(f) * D), acc);
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    red[row * kDownCols + grp * kVec + i] = acc[i];
  __syncthreads();
  for (int c = tid; c < kDownCols; c += kThreads) {
    const int d = blockIdx.x * kDownCols + c;
    if (d >= D) continue;
    float s = 0.f;
    for (int r = 0; r < kDownRows; ++r) s += red[r * kDownCols + c];
    if (out_f32)
      out_f32[static_cast<int64_t>(b) * D + d] = s;
    else
      out[static_cast<int64_t>(b) * D + d] = __float2bfloat16(s);
  }
}

// Raises a kernel's dynamic shared memory limit when it needs more than
// the default 48 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// x (B, D) bf16; wg/wu (e_hi - e_lo, D, F) bf16; wd (e_hi - e_lo, F, D)
// bf16, the experts [e_lo, e_hi) of E; ids (B, K) int32 global ids; wts
// (B, K) fp32; h (B, K, F) fp32 scratch; out (B, D) bf16, or fp32 where
// out_f32 is nonzero.  All contiguous and 16-byte aligned; D and F
// multiples of 8.  The whole kernel: e_lo 0, e_hi E, out_f32 0.
extern "C" int fused_expert_ffn_bf16(const void* x, const void* wg,
                                     const void* wu, const void* wd,
                                     const void* ids, const void* wts,
                                     void* h, void* out, int B, int K,
                                     int D, int F, int E, int e_lo,
                                     int e_hi, int out_f32, void* stream) {
  if (B <= 0 || K <= 0 || D <= 0 || F <= 0 || E <= 0 || D % kVec ||
      F % kVec || B * K > 65535 || e_lo < 0 || e_hi > E || e_lo > e_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t up_smem =
      (static_cast<size_t>(D) + 2 * kUpRows * kUpCols) * sizeof(float);
  const size_t down_smem =
      (static_cast<size_t>(K) * F + kDownRows * kDownCols) * sizeof(float);
  cudaError_t err = allow_smem(expert_up_kernel, up_smem);
  if (err == cudaSuccess) err = allow_smem(expert_down_kernel, down_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  expert_up_kernel<<<dim3((F + kUpCols - 1) / kUpCols, B * K), kThreads,
                     up_smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const int32_t*>(ids),
      static_cast<float*>(h), K, D, F, E, e_lo, e_hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expert_down_kernel<<<dim3((D + kDownCols - 1) / kDownCols, B), kThreads,
                       down_smem, st>>>(
      static_cast<const float*>(h), static_cast<const bf16*>(wd),
      static_cast<const int32_t*>(ids), static_cast<const float*>(wts),
      out_f32 ? nullptr : static_cast<bf16*>(out),
      out_f32 ? static_cast<float*>(out) : nullptr, K, D, F, E, e_lo, e_hi);
  return static_cast<int>(cudaGetLastError());
}
