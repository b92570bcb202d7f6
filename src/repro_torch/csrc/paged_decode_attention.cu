// GQA decode attention read straight from the paged KV pool.
//
// Replaces the TPU kernel repro/kernels/tiered_gather.py
// (paged_decode_attention / _paged_decode_kernel).  Where Pallas rode
// the block table on scalar prefetch, each thread block reads its own
// table row (PagedRows in decode_common.cuh) and offsets the pool
// pointer by tbl[b, j] * bt * KV * HD; no staging copy of the sequence
// exists.  The step's (k_new, v_new), not yet in the pool, is folded
// into the online softmax at position kv_len, so the output covers
// kv_len + 1 positions.  Table slots past the cached tokens (pad slots
// repeat block 0) are never read: the loop stops at kv_len, and a
// kv_len = 0 row (a padded batch row) attends to its new token only.
#include "decode_common.cuh"

namespace {

using repro::bf16;

template <int HD, int REP>
__global__ void __launch_bounds__(repro::kDecodeThreads)
paged_decode_attention_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k_pool,
                              const bf16* __restrict__ v_pool,
                              const int32_t* __restrict__ tbl,
                              const int32_t* __restrict__ kv_len,
                              const bf16* __restrict__ k_new,
                              const bf16* __restrict__ v_new,
                              bf16* __restrict__ out, int H, int KV,
                              int nb, int bt, float scale) {
  const int len = kv_len[blockIdx.y];
  const int end = max(0, min(len, nb * bt));
  repro::decode_body<HD, REP>(q, k_pool, v_pool,
                              repro::PagedRows{tbl, nb, bt, KV, HD}, end,
                              end, k_new, v_new, out, H, KV, scale);
}

}  // namespace

// q (B, H, HD); pools (num_blocks, bt, KV, HD); tbl (B, nb) int32;
// kv_len (B,) int32; k_new/v_new (B, KV, HD); out (B, H, HD).  bf16
// unless stated, all contiguous.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tbl, const void* kv_len, const void* k_new,
    const void* v_new, void* out, int B, int H, int KV, int nb, int bt,
    int HD, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || nb <= 0 || bt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KV, B);
  const int rep = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(HD_, REP_)                                                   \
  paged_decode_attention_kernel<HD_, REP_><<<grid, repro::kDecodeThreads,   \
                                             0, st>>>(                      \
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),        \
      static_cast<const bf16*>(v_pool), static_cast<const int32_t*>(tbl),   \
      static_cast<const int32_t*>(kv_len), static_cast<const bf16*>(k_new), \
      static_cast<const bf16*>(v_new), static_cast<bf16*>(out), H, KV, nb,  \
      bt, scale)
  REPRO_DECODE_DISPATCH(HD, rep, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
