// GQA decode attention over contiguous per-sequence caches, split over
// the sequence ("flash-decoding").
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel), the staged decode's attention.
// Where Pallas carried (m, l, acc) along a sequential kv grid axis, two
// kernels behind this one C call, over the bodies of decode_common.cuh:
// pass 1 (decode_split_kernel, grid (KV, B, n_split)) spreads each
// sequence over n_split blocks of T tokens, each writing a partial
// (m, l, acc) to fp32 scratch; pass 2 (decode_merge_kernel) merges a
// row's partials.  The staged path writes the step's token into the
// cache before the call, so there is no new token to fold in.
//
// Bound on the H100: device-memory bytes, the live K/V rows read once
// (6.8 MB at llama3-8b's main-path lengths, 2.05 us at 3.35 TB/s).  The
// wrapper picks n_split from the shapes so that the grid has at least
// one block per SM (288 blocks at KV 8, 144 at KV 4, batch 4, T 64), and
// each block starts all of its split's rows (32 KB at T 64, HD 128) with
// 16-byte cp.async copies before any math.
#include "decode_common.cuh"

namespace {

using repro::bf16;

// Grid (KV, B, n_split).  kv_len (B,) int32: positions >= kv_len are
// masked.  Tokens past min(kv_len, S) are not read, which the mask makes
// exact; kv_len <= 0 reads all S positions fully masked, which gives the
// reference's uniform weights over the padded cache.
template <int HD, int REP>
__global__ void __launch_bounds__(repro::kSplitThreads)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const int32_t* __restrict__ kv_len,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int H, int KV, int S,
                    int T, float scale) {
  const int len = kv_len[blockIdx.y];
  const int end = len <= 0 ? S : min(len, S);
  repro::split_partial_body<HD, REP>(q, k, v,
                                     repro::ContiguousRows{S, KV, HD}, end,
                                     len, T, m_part, l_part, acc_part, H,
                                     scale);
}

// Grid (ceil(H / kMergeWarps), B).
template <int HD, int REP>
__global__ void __launch_bounds__(repro::kMergeThreads)
decode_merge_kernel(const bf16* __restrict__ q,
                    const float* __restrict__ m_part,
                    const float* __restrict__ l_part,
                    const float* __restrict__ acc_part, int n_split,
                    bf16* __restrict__ out, int H, int KV, float scale) {
  repro::split_merge_body<HD, REP>(q, nullptr, nullptr, m_part, l_part,
                                   acc_part, n_split, out, H, KV, scale);
}

template <int HD, int REP>
int launch(const bf16* q, const bf16* k, const bf16* v,
           const int32_t* kv_len, bf16* out, float* m_part, float* l_part,
           float* acc_part, int B, int H, int KV, int S, int T, int n_split,
           float scale, cudaStream_t st) {
  const int smem = repro::split_smem_bytes<HD, REP>(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<HD, REP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_split_kernel<HD, REP>
      <<<dim3(KV, B, n_split), repro::kSplitThreads, smem, st>>>(
          q, k, v, kv_len, m_part, l_part, acc_part, H, KV, S, T, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid2((H + repro::kMergeWarps - 1) / repro::kMergeWarps, B);
  decode_merge_kernel<HD, REP><<<grid2, repro::kMergeThreads, 0, st>>>(
      q, m_part, l_part, acc_part, n_split, out, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, HD), k/v (B, S, KV, HD), out (B, H, HD): bf16, contiguous;
// kv_len (B,) int32.  Scratch, fp32: m_part and l_part (B, H, n_split),
// acc_part (B, H, n_split, HD).  T tokens per split, with
// n_split * T >= S.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* out, void* m_part, void* l_part,
                                     void* acc_part, int B, int H, int KV,
                                     int S, int HD, int T, int n_split,
                                     float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || T <= 0 ||
      n_split <= 0 || static_cast<int64_t>(n_split) * T < S ||
      B > 65535 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / KV;
  int rc = static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(HD_, REP_)                                                  \
  rc = launch<HD_, REP_>(                                                  \
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),            \
      static_cast<const bf16*>(v), static_cast<const int32_t*>(kv_len),    \
      static_cast<bf16*>(out), static_cast<float*>(m_part),                \
      static_cast<float*>(l_part), static_cast<float*>(acc_part), B, H,    \
      KV, S, T, n_split, scale, static_cast<cudaStream_t>(stream))
  REPRO_DECODE_DISPATCH(HD, rep, LAUNCH);
#undef LAUNCH
  return rc;
}
