// One-pass AdamW over master/m/v/g: the ZeRO-Offload optimizer step.
//
// Replaces the TPU kernel repro/kernels/fused_adam.py (fused_adam_2d /
// _adam_kernel, with its wrapper fused_adam).  Per element:
//   m'      = b1 m + (1 - b1) g
//   v'      = b2 v + (1 - b2) g g
//   master' = master - lr ((m' / b1c) / (sqrt(v' / b2c) + eps) + wd master)
// master/m/v fp32 in, fp32 out (out of place), g fp32, bf16 or fp16.
//
// Bound on the H100: device-memory bytes.  Each element reads 12 bytes
// of state and 2 or 4 of g and writes 12, against about 15 fp32
// operations: at gpt2-xl-offload's largest leaf (491.5 M elements, bf16
// g) 12.8 GB, 3.8 ms at 3.35 TB/s.
//
// Design: a grid-stride loop in which each thread takes 4 elements as one
// 16-byte load of each state array plus an 8-byte (bf16, fp16) or
// 16-byte (fp32) load of g; the n % 4 tail is done by the first threads
// of the grid one element each.  When any pointer is not aligned for
// those loads (a contiguous view at an odd storage offset), the whole
// tensor goes through a scalar loop instead.  The TPU kernel's (rows,
// 128) lane padding does not exist here.  The hyperparameters are plain
// float arguments (the TPU kernel read them from SMEM refs so that b1c
// and b2c could change every step without a recompile); the complements
// 1 - b1 and 1 - b2 come formed by the wrapper, in double precision, as
// the plain version forms them.  The arithmetic keeps the reference's
// order and rounds after every operation (__fmul_rn and friends are
// never contracted into FMAs; sqrt and the divisions are IEEE), so the
// kernel agrees with the plain PyTorch version to about one fp32 ulp.
#include "common.cuh"

#include <cuda_fp16.h>

namespace {

struct Hyper {
  float lr, b1, b2, eps, wd, b1c, b2c, omb1, omb2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(repro::bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void adam_one(float& master, float& m, float& v,
                                         float g, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mh = __fdiv_rn(m, h.b1c);
  const float vh = __fdiv_rn(v, h.b2c);
  const float step = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps)),
                               __fmul_rn(h.wd, master));
  master = __fsub_rn(master, __fmul_rn(h.lr, step));
}

// Four consecutive g values as fp32: one 16-byte load (fp32) or one
// 8-byte load (bf16, fp16).
__device__ __forceinline__ void load4(const float* p, float (&g)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  g[0] = x.x; g[1] = x.y; g[2] = x.z; g[3] = x.w;
}
__device__ __forceinline__ void load4(const repro::bf16* p, float (&g)[4]) {
  repro::load_bf16<4>(p, g);
}
__device__ __forceinline__ void load4(const __half* p, float (&g)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  g[0] = a.x; g[1] = a.y; g[2] = b.x; g[3] = b.y;
}

template <typename G>
__global__ void __launch_bounds__(256)
fused_adam_vec4_kernel(const float* __restrict__ master,
                       const float* __restrict__ m,
                       const float* __restrict__ v,
                       const G* __restrict__ g, float* __restrict__ out_master,
                       float* __restrict__ out_m, float* __restrict__ out_v,
                       long long n, Hyper h) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  for (long long i = tid; i < n4; i += stride) {
    const float4 ma = reinterpret_cast<const float4*>(master)[i];
    const float4 mm = reinterpret_cast<const float4*>(m)[i];
    const float4 vv = reinterpret_cast<const float4*>(v)[i];
    float gg[4];
    load4(g + 4 * i, gg);
    float a[4] = {ma.x, ma.y, ma.z, ma.w};
    float b[4] = {mm.x, mm.y, mm.z, mm.w};
    float c[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) adam_one(a[j], b[j], c[j], gg[j], h);
    reinterpret_cast<float4*>(out_master)[i] = make_float4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<float4*>(out_m)[i] = make_float4(b[0], b[1], b[2], b[3]);
    reinterpret_cast<float4*>(out_v)[i] = make_float4(c[0], c[1], c[2], c[3]);
  }
  // the n % 4 tail: one element for each of the grid's first threads
  const long long t = 4 * n4 + tid;
  if (t < n) {
    float a = master[t], b = m[t], c = v[t];
    adam_one(a, b, c, to_f32(g[t]), h);
    out_master[t] = a;
    out_m[t] = b;
    out_v[t] = c;
  }
}

template <typename G>
__global__ void __launch_bounds__(256)
fused_adam_scalar_kernel(const float* __restrict__ master,
                         const float* __restrict__ m,
                         const float* __restrict__ v,
                         const G* __restrict__ g,
                         float* __restrict__ out_master,
                         float* __restrict__ out_m, float* __restrict__ out_v,
                         long long n, Hyper h) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float a = master[i], b = m[i], c = v[i];
    adam_one(a, b, c, to_f32(g[i]), h);
    out_master[i] = a;
    out_m[i] = b;
    out_v[i] = c;
  }
}

constexpr int kThreads = 256;

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename G>
int launch(const void* master, const void* m, const void* v, const void* g,
           void* out_master, void* out_m, void* out_v, long long n,
           const Hyper& h, cudaStream_t st) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long max_blocks = static_cast<long long>(sms) * 8;
  const bool vec = aligned(master, 16) && aligned(m, 16) && aligned(v, 16) &&
                   aligned(out_master, 16) && aligned(out_m, 16) &&
                   aligned(out_v, 16) && aligned(g, 4 * sizeof(G));
  const long long work = vec ? n / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  const auto* ma = static_cast<const float*>(master);
  const auto* mm = static_cast<const float*>(m);
  const auto* vv = static_cast<const float*>(v);
  const auto* gg = static_cast<const G*>(g);
  auto* oa = static_cast<float*>(out_master);
  auto* om = static_cast<float*>(out_m);
  auto* ov = static_cast<float*>(out_v);
  if (vec)
    fused_adam_vec4_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                                st>>>(ma, mm, vv, gg, oa, om, ov, n, h);
  else
    fused_adam_scalar_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  st>>>(ma, mm, vv, gg, oa, om, ov, n, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// master/m/v/out_*: n fp32 values each, contiguous; g: n values of type
// g_dtype (0 fp32, 1 bf16, 2 fp16).  Any alignment; n >= 0.
extern "C" int fused_adam_f32(const void* master, const void* m,
                              const void* v, const void* g, void* out_master,
                              void* out_m, void* out_v, long long n,
                              int g_dtype, float lr, float b1, float b2,
                              float eps, float wd, float b1c, float b2c,
                              float omb1, float omb2, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Hyper h{lr, b1, b2, eps, wd, b1c, b2c, omb1, omb2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case 0:
      return launch<float>(master, m, v, g, out_master, out_m, out_v, n, h,
                           st);
    case 1:
      return launch<repro::bf16>(master, m, v, g, out_master, out_m, out_v,
                                 n, h, st);
    case 2:
      return launch<__half>(master, m, v, g, out_master, out_m, out_v, n, h,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
