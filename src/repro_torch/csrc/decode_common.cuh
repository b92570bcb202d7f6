// GQA decode attention body shared by the contiguous-cache kernel
// (decode_attention.cu) and the paged-pool kernel
// (paged_decode_attention.cu).
//
// One thread block per (KV head, sequence) serves that KV head's REP
// query heads, so each K/V row is read from device memory once (the
// grouping the TPU kernel does with its (KV, rep) layout).  The TPU
// grid's sequential kv axis becomes a loop inside the block: each of
// the kWarps warps walks every kWarps-th group of kUnroll tokens and
// keeps its own fp32 online-softmax state (m, l, acc) per query head;
// a lane holds HD/32 consecutive channels of q, k, v and acc, and a
// score is one warp-wide shuffle sum.  At the end the warps' states are
// merged through shared memory, and the paged kernel folds the step's
// new token in as one more position.
//
// Bound on the H100: device-memory bytes (the K/V rows), at about one
// FMA per byte.  Weakness kept on purpose in this first version: only
// B*KV blocks (32 at llama3-8b, batch 4) for 132 SMs; the split-K form
// that spreads one sequence over several blocks is later work.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeUnroll = 4;
constexpr int kDecodeThreads = kDecodeWarps * 32;

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

// q (B, H, HD); k/v rows through `rows`; positions [0, end) are read and
// positions >= kv_len among them are masked (only the contiguous kernel
// with kv_len == 0 reads masked positions, to keep the reference's
// uniform-weights result).  k_new/v_new (B, KV, HD) or null: the token
// folded in after the cached ones.  out (B, H, HD).
template <int HD, int REP, class Rows>
__device__ __forceinline__ void decode_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, Rows rows, int end, int kv_len,
    const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
    bf16* __restrict__ out, int H, int KV, float scale) {
  constexpr int EPL = HD / 32;  // channels per lane
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h0 = kvh * REP;

  float qf[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    load_bf16<EPL>(q + (static_cast<int64_t>(b) * H + h0 + r) * HD +
                       lane * EPL, qf[r]);

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = warp * kDecodeUnroll; t0 < end;
       t0 += kDecodeWarps * kDecodeUnroll) {
    float kf[kDecodeUnroll][EPL], vf[kDecodeUnroll][EPL];
#pragma unroll
    for (int j = 0; j < kDecodeUnroll; ++j) {
      const int t = t0 + j;
      if (t < end) {
        const int64_t off = rows(b, t, kvh) + lane * EPL;
        load_bf16<EPL>(k + off, kf[j]);
        load_bf16<EPL>(v + off, vf[j]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[j][e] = vf[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float s[kDecodeUnroll];
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kDecodeUnroll; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qf[r][e] * kf[j][e];
        s[j] = warp_sum(part) * scale;
        if (t0 + j >= kv_len) s[j] = kNegInf;
        if (t0 + j < end) mx = fmaxf(mx, s[j]);
      }
      const float corr = expf(m[r] - mx);
      float psum = 0.f;
      float pv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) pv[e] = 0.f;
#pragma unroll
      for (int j = 0; j < kDecodeUnroll; ++j) {
        const float p = (t0 + j < end) ? expf(s[j] - mx) : 0.f;
        psum += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) pv[e] += p * vf[j][e];
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * corr + pv[e];
      m[r] = mx;
    }
  }

  __shared__ float sm_m[kDecodeWarps][REP];
  __shared__ float sm_l[kDecodeWarps][REP];
  __shared__ float sm_acc[kDecodeWarps][REP][HD];
  __shared__ float sm_sn[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][r][lane * EPL + e] = acc[r][e];
  }
  if (k_new != nullptr && warp == 0) {
    float kn[EPL];
    load_bf16<EPL>(k_new + (static_cast<int64_t>(b) * KV + kvh) * HD +
                       lane * EPL, kn);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part += qf[r][e] * kn[e];
      const float sn = warp_sum(part) * scale;
      if (lane == 0) sm_sn[r] = sn;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < REP * HD; idx += kDecodeThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float c = expf(sm_m[w][r] - M);
      L += sm_l[w][r] * c;
      A += sm_acc[w][r][d] * c;
    }
    if (k_new != nullptr) {
      const float sn = sm_sn[r];
      const float mf = fmaxf(M, sn);
      const float corr = expf(M - mf);
      const float pn = expf(sn - mf);
      const float vn = __bfloat162float(
          v_new[(static_cast<int64_t>(b) * KV + kvh) * HD + d]);
      L = L * corr + pn;
      A = A * corr + pn * vn;
    }
    out[(static_cast<int64_t>(b) * H + h0 + r) * HD + d] =
        __float2bfloat16(A / fmaxf(L, kMinDenom));
  }
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
