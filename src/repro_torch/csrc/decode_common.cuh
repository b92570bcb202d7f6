// GQA decode attention bodies shared by the contiguous-cache kernel
// (decode_attention.cu) and the paged-pool kernel
// (paged_decode_attention.cu).  Bound on the H100: device-memory bytes
// (the live K/V rows), at about one FMA per byte, so what matters is
// the whole card busy with many bytes in flight, not the tensor cores.
//
// Both kernels take the split-KV ("flash-decoding") form, two kernels
// behind one C call.  Pass 1 (split_partial_body) runs a grid (KV, B,
// n_split) in which each block takes T consecutive tokens of one
// sequence for one KV head and its REP query heads, so each K/V row is
// read from device memory once (the grouping the TPU kernels do with
// their (KV, rep) layout): it starts every K and V row of its split at
// once with 16-byte cp.async copies into shared memory, before any math,
// then writes its heads' partial (m, l, acc) in fp32 to scratch.  Where
// the TPU kernels carried (m, l, acc) along a sequential kv grid axis,
// pass 2 (split_merge_body) merges a row's partials with the usual max
// correction and, for the paged kernel, folds the step's new token in.
// A split past the row's last read token writes the empty partial
// (m = -1e30, l = 0, acc = 0) and reads nothing, so the host sizes the
// grid from the shapes alone, with no sync on the lengths.  Rows come
// through ContiguousRows or PagedRows.
#pragma once

#include "common.cuh"

namespace repro {

// Element offset of the (b, t, kvh) row of a contiguous (B, S, KV, HD)
// cache.
struct ContiguousRows {
  int S, KV, HD;
  __device__ __forceinline__ int64_t operator()(int b, int t,
                                                int kvh) const {
    return ((static_cast<int64_t>(b) * S + t) * KV + kvh) * HD;
  }
};

// Element offset of token t of sequence b in a (num_blocks, bt, KV, HD)
// pool, through the (B, nb) int32 block table: logical block t / bt
// lives in physical block tbl[b, t / bt].
struct PagedRows {
  const int32_t* __restrict__ tbl;
  int nb, bt, KV, HD;
  __device__ __forceinline__ int64_t operator()(int b, int t,
                                                int kvh) const {
    const int64_t phys = __ldg(tbl + static_cast<int64_t>(b) * nb + t / bt);
    return ((phys * bt + t % bt) * KV + kvh) * HD;
  }
};

// ---- split-KV decode ------------------------------------------------- //
constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kMergeWarps = 4;            // one query head per warp
constexpr int kMergeThreads = kMergeWarps * 32;

// Shared memory of one pass-1 block: K and V rows [T][HD] bf16 and the
// scores [REP][T] fp32.
template <int HD, int REP>
__host__ __device__ constexpr int split_smem_bytes(int T) {
  return 2 * T * HD * 2 + REP * T * 4;
}

// Pass 1, block (kvh, b, split) of a (KV, B, n_split) grid: tokens
// [split * T, split * T + T) of sequence b, cut at `end`, for KV head kvh
// and its REP query heads.  q (B, H, HD); k/v rows through `rows`.  A
// score at a position >= mask_len is -1e30, as the reference masks it
// (only the contiguous kernel with kv_len <= 0 reads masked positions,
// to keep the reference's uniform weights over the padded cache; the
// paged kernel passes mask_len = end, which masks nothing).
// Partials (B, H, n_split) for m and l, (B, H, n_split, HD) for acc:
// m the split's max score, l = sum exp(s - m), acc = sum exp(s - m) v.
template <int HD, int REP, class Rows>
__device__ __forceinline__ void split_partial_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, Rows rows, int end, int mask_len, int T,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int H, float scale) {
  constexpr int EPL = HD / 32;   // channels per lane
  constexpr int CH = HD / 8;     // 16-byte chunks per row
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h0 = kvh * REP;
  const int t0 = split * T;
  const int n = max(0, min(T, end - t0));   // live tokens of the split
  // partial index of (b, h0, split); head h0 + r is r * n_split further
  const int64_t p0 = (static_cast<int64_t>(b) * H + h0) * n_split + split;

  if (n == 0) {
    for (int i = threadIdx.x; i < REP * HD; i += kSplitThreads)
      acc_part[(p0 + (i / HD) * n_split) * HD + i % HD] = 0.f;
    if (threadIdx.x < REP) {
      m_part[p0 + threadIdx.x * n_split] = kNegInf;
      l_part[p0 + threadIdx.x * n_split] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char split_smem[];
  bf16* sK = reinterpret_cast<bf16*>(split_smem);
  bf16* sV = sK + T * HD;
  float* sP = reinterpret_cast<float*>(sV + T * HD);   // [REP][T]
  for (int c = threadIdx.x; c < n * CH; c += kSplitThreads) {
    const int t = c / CH, ch = c % CH;
    const int64_t off = rows(b, t0 + t, kvh) + ch * 8;
    cp_async16(smem_addr(sK + t * HD + ch * 8), k + off, true);
    cp_async16(smem_addr(sV + t * HD + ch * 8), v + off, true);
  }
  cp_async_commit();

  float qf[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    load_bf16<EPL>(q + (static_cast<int64_t>(b) * H + h0 + r) * HD +
                       lane * EPL, qf[r]);
  cp_async_wait<0>();
  __syncthreads();

  // scores: a warp per token, a lane per EPL channels
#pragma unroll 2
  for (int t = warp; t < n; t += kSplitWarps) {
    float kf[EPL];
    load_bf16<EPL>(sK + t * HD + lane * EPL, kf);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part += qf[r][e] * kf[e];
      part = warp_sum(part) * scale;
      if (t0 + t >= mask_len) part = kNegInf;
      if (lane == 0) sP[r * T + t] = part;
    }
  }
  __syncthreads();

  // per head: the split's max, its weights and their sum
  for (int r = warp; r < REP; r += kSplitWarps) {
    float mx = kNegInf;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sP[r * T + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sP[r * T + t] - mx);
      sP[r * T + t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_part[p0 + r * n_split] = mx;
      l_part[p0 + r * n_split] = sum;
    }
  }
  __syncthreads();

  // acc = P V over the live tokens, two channels a thread
  for (int i = threadIdx.x; i < REP * HD / 2; i += kSplitThreads) {
    const int r = i / (HD / 2);
    const int d = (i % (HD / 2)) * 2;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
      const float p = sP[r * T + t];
      const float2 vv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sV + t * HD + d));
      a0 += p * vv.x;
      a1 += p * vv.y;
    }
    *reinterpret_cast<float2*>(acc_part + (p0 + r * n_split) * HD + d) =
        make_float2(a0, a1);
  }
}

// Pass 2, block (i, b) of a (ceil(H / kMergeWarps), B) grid: warp w
// merges the n_split partials of head h = i * kMergeWarps + w and writes
// out (B, H, HD) in bf16.  k_new/v_new (B, KV, HD), or null: the step's
// new token, folded in after the cached ones (paged kernel; the
// contiguous kernel's cache already holds it).
template <int HD, int REP>
__device__ __forceinline__ void split_merge_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k_new,
    const bf16* __restrict__ v_new, const float* __restrict__ m_part,
    const float* __restrict__ l_part, const float* __restrict__ acc_part,
    int n_split, bf16* __restrict__ out, int H, int KV, float scale) {
  constexpr int EPL = HD / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x * kMergeWarps + warp;
  const int b = blockIdx.y;
  if (h >= H) return;
  const int kvh = h / REP;
  const int64_t row = static_cast<int64_t>(b) * H + h;
  const int64_t p0 = row * n_split;

  float M = kNegInf;
  for (int s = lane; s < n_split; s += 32) M = fmaxf(M, m_part[p0 + s]);
  M = warp_max(M);
  float L = 0.f, A[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) A[e] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float c = expf(m_part[p0 + s] - M);
    L += l_part[p0 + s] * c;
    float a[EPL];
    load_f32<EPL>(acc_part + (p0 + s) * HD + lane * EPL, a);
#pragma unroll
    for (int e = 0; e < EPL; ++e) A[e] += a[e] * c;
  }
  if (k_new != nullptr) {
    const int64_t nrow = (static_cast<int64_t>(b) * KV + kvh) * HD;
    float qf[EPL], kn[EPL], vn[EPL];
    load_bf16<EPL>(q + row * HD + lane * EPL, qf);
    load_bf16<EPL>(k_new + nrow + lane * EPL, kn);
    load_bf16<EPL>(v_new + nrow + lane * EPL, vn);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part += qf[e] * kn[e];
    const float sn = warp_sum(part) * scale;
    const float mf = fmaxf(M, sn);
    const float corr = expf(M - mf);
    const float pn = expf(sn - mf);
    L = L * corr + pn;
#pragma unroll
    for (int e = 0; e < EPL; ++e) A[e] = A[e] * corr + pn * vn[e];
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    out[row * HD + lane * EPL + e] =
        __float2bfloat16(A[e] / fmaxf(L, kMinDenom));
}

}  // namespace repro

// Instantiates a launcher for every supported (HD, REP): HD in {64, 128},
// REP in {1, 2, 4, 8}.  LAUNCH(HD, REP) must expand to the launch of
// the kernel template for that pair.
#define REPRO_DECODE_DISPATCH(HD_, REP_, LAUNCH)                  \
  do {                                                            \
    if ((HD_) == 128) {                                           \
      switch (REP_) {                                             \
        case 1: LAUNCH(128, 1); break;                            \
        case 2: LAUNCH(128, 2); break;                            \
        case 4: LAUNCH(128, 4); break;                            \
        case 8: LAUNCH(128, 8); break;                            \
        default: return static_cast<int>(cudaErrorInvalidValue); \
      }                                                           \
    } else if ((HD_) == 64) {                                     \
      switch (REP_) {                                             \
        case 1: LAUNCH(64, 1); break;                             \
        case 2: LAUNCH(64, 2); break;                             \
        case 4: LAUNCH(64, 4); break;                             \
        case 8: LAUNCH(64, 8); break;                             \
        default: return static_cast<int>(cudaErrorInvalidValue); \
      }                                                           \
    } else {                                                      \
      return static_cast<int>(cudaErrorInvalidValue);             \
    }                                                             \
  } while (0)
