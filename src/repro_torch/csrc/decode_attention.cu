// GQA decode attention over contiguous per-sequence caches.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel).  The computation is in
// decode_common.cuh; this file adds the loop bound and the C entry.
#include "decode_common.cuh"

namespace {

using repro::bf16;

// Grid (KV, B).  kv_len (B,) int32: positions >= kv_len are masked.
// The loop stops at min(kv_len, S), which masked positions make exact;
// kv_len <= 0 reads all S positions fully masked, which gives the
// reference's uniform weights over the padded cache.
template <int HD, int REP>
__global__ void __launch_bounds__(repro::kDecodeThreads)
decode_attention_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int32_t* __restrict__ kv_len,
                        bf16* __restrict__ out, int H, int KV, int S,
                        float scale) {
  const int len = kv_len[blockIdx.y];
  const int end = len <= 0 ? S : min(len, S);
  repro::decode_body<HD, REP>(q, k, v, repro::ContiguousRows{S, KV, HD},
                              end, len, nullptr, nullptr, out, H, KV,
                              scale);
}

}  // namespace

// q (B, H, HD), k/v (B, S, KV, HD), out (B, H, HD): bf16, contiguous.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* out, int B, int H, int KV,
                                     int S, int HD, float scale,
                                     void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KV, B);
  const int rep = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(HD_, REP_)                                                  \
  decode_attention_kernel<HD_, REP_><<<grid, repro::kDecodeThreads, 0,     \
                                       st>>>(                              \
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),            \
      static_cast<const bf16*>(v), static_cast<const int32_t*>(kv_len),    \
      static_cast<bf16*>(out), H, KV, S, scale)
  REPRO_DECODE_DISPATCH(HD, rep, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
