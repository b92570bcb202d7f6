// GQA decode attention read straight from the paged KV pool, split over
// the sequence ("flash-decoding").
//
// Replaces the TPU kernel repro/kernels/tiered_gather.py
// (paged_decode_attention / _paged_decode_kernel).  Where Pallas rode
// the block table on scalar prefetch, each thread block reads its own
// table entries (PagedRows in decode_common.cuh) and offsets the pool
// pointer by tbl[b, j] * bt * KV * HD; no staging copy of the sequence
// exists.  Where Pallas carried (m, l, acc) along a sequential kv grid
// axis, two kernels behind this one C call: pass 1
// (paged_decode_split_kernel, grid (KV, B, n_split)) spreads each
// sequence over n_split blocks of T tokens, each writing a partial
// (m, l, acc) to fp32 scratch; pass 2 (paged_decode_merge_kernel) merges
// a row's partials and folds the step's (k_new, v_new), not yet in the
// pool, in at position kv_len, so the output covers kv_len + 1
// positions.  Table slots past the cached tokens (pad slots repeat
// block 0) are never read: a split past kv_len reads nothing, and a
// kv_len = 0 row (a padded batch row) attends to its new token only.
//
// Bound on the H100: device-memory bytes, the live K/V rows read once
// (6.9 MB at llama3-8b's main-path lengths, 2.1 us at 3.35 TB/s).  The
// old form had B * KV blocks (32 at KV 8, batch 4) each walking one row
// at a time, and waited on memory latency; here the wrapper picks
// n_split so that the grid has at least one block per SM (288 blocks at
// KV 8, 144 at KV 4, batch 4, T 64), and each block starts all of its
// split's rows (32 KB at T 64, HD 128) with 16-byte cp.async copies
// before any math.
#include "decode_common.cuh"

namespace {

using repro::bf16;

// Grid (KV, B, n_split).  kv_len (B,) int32 tokens cached; tokens past
// min(kv_len, nb * bt) are not read.
template <int HD, int REP>
__global__ void __launch_bounds__(repro::kSplitThreads)
paged_decode_split_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k_pool,
                          const bf16* __restrict__ v_pool,
                          const int32_t* __restrict__ tbl,
                          const int32_t* __restrict__ kv_len,
                          float* __restrict__ m_part,
                          float* __restrict__ l_part,
                          float* __restrict__ acc_part, int H, int KV,
                          int nb, int bt, int T, float scale) {
  const int end = max(0, min(kv_len[blockIdx.y], nb * bt));
  repro::split_partial_body<HD, REP>(
      q, k_pool, v_pool, repro::PagedRows{tbl, nb, bt, KV, HD}, end, end,
      T, m_part, l_part, acc_part, H, scale);
}

// Grid (ceil(H / kMergeWarps), B).
template <int HD, int REP>
__global__ void __launch_bounds__(repro::kMergeThreads)
paged_decode_merge_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k_new,
                          const bf16* __restrict__ v_new,
                          const float* __restrict__ m_part,
                          const float* __restrict__ l_part,
                          const float* __restrict__ acc_part, int n_split,
                          bf16* __restrict__ out, int H, int KV,
                          float scale) {
  repro::split_merge_body<HD, REP>(q, k_new, v_new, m_part, l_part,
                                   acc_part, n_split, out, H, KV, scale);
}

template <int HD, int REP>
int launch(const bf16* q, const bf16* k_pool, const bf16* v_pool,
           const int32_t* tbl, const int32_t* kv_len, const bf16* k_new,
           const bf16* v_new, bf16* out, float* m_part, float* l_part,
           float* acc_part, int B, int H, int KV, int nb, int bt, int T,
           int n_split, float scale, cudaStream_t st) {
  const int smem = repro::split_smem_bytes<HD, REP>(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_split_kernel<HD, REP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_decode_split_kernel<HD, REP>
      <<<dim3(KV, B, n_split), repro::kSplitThreads, smem, st>>>(
          q, k_pool, v_pool, tbl, kv_len, m_part, l_part, acc_part, H, KV,
          nb, bt, T, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid2((H + repro::kMergeWarps - 1) / repro::kMergeWarps, B);
  paged_decode_merge_kernel<HD, REP><<<grid2, repro::kMergeThreads, 0, st>>>(
      q, k_new, v_new, m_part, l_part, acc_part, n_split, out, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, HD); pools (num_blocks, bt, KV, HD); tbl (B, nb) int32;
// kv_len (B,) int32; k_new/v_new (B, KV, HD); out (B, H, HD): bf16
// unless stated, all contiguous.  Scratch, fp32: m_part and l_part
// (B, H, n_split), acc_part (B, H, n_split, HD).  T tokens per split,
// a multiple of bt, with n_split * T >= nb * bt.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tbl, const void* kv_len, const void* k_new,
    const void* v_new, void* out, void* m_part, void* l_part,
    void* acc_part, int B, int H, int KV, int nb, int bt, int HD, int T,
    int n_split, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || nb <= 0 || bt <= 0 || T <= 0 ||
      T % bt != 0 || n_split <= 0 ||
      static_cast<int64_t>(n_split) * T < static_cast<int64_t>(nb) * bt ||
      B > 65535 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / KV;
  int rc = static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(HD_, REP_)                                                   \
  rc = launch<HD_, REP_>(                                                   \
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),        \
      static_cast<const bf16*>(v_pool), static_cast<const int32_t*>(tbl),   \
      static_cast<const int32_t*>(kv_len), static_cast<const bf16*>(k_new), \
      static_cast<const bf16*>(v_new), static_cast<bf16*>(out),             \
      static_cast<float*>(m_part), static_cast<float*>(l_part),             \
      static_cast<float*>(acc_part), B, H, KV, nb, bt, T, n_split, scale,   \
      static_cast<cudaStream_t>(stream))
  REPRO_DECODE_DISPATCH(HD, rep, LAUNCH);
#undef LAUNCH
  return rc;
}
