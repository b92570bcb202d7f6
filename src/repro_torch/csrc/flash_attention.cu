// Causal blocked flash attention for prefill.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_bh / _flash_kernel, with its GQA wrapper
// flash_attention).  One thread block per (query tile of kBQ rows,
// b * H + h); the TPU grid's sequential kv axis becomes a loop over kv
// tiles of kBK rows staged in shared memory, stopping at the diagonal
// when causal (the tiles Pallas skipped with pl.when).  Online softmax
// in fp32 registers.  GQA reads KV head h / (H / KV) directly, which
// computes what the reference wrapper's jnp.repeat computes without the
// copy; ragged Sq and Sk are masked here, with no padded copies.
//
// Four threads own one query row: each holds HD/4 of its channels
// (pairs p*8 + quarter*2 + {0, 1}, so the four read neighbouring shared
// memory words), a score is their partial dot products summed with two
// shuffles, and each thread keeps its channels' slice of acc.
//
// Bound on the H100: about 2 * L * (L + 1) * H * HD FLOP causal against
// 2 * L * (H + KV) * HD * 2 bytes in and out.  At H = 32, KV = 8 the
// bf16 peak and the memory rate give equal times near L = 737: bytes
// bind below that (the 512-token prompts), operations above.  This
// first version runs the products on the fp32 FMA units, not the bf16
// tensor cores, so it sits far from either bound; an mma/wgmma tiling
// is later work.
#include "common.cuh"

namespace {

using repro::bf16;

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kThreads = kBQ * 4;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int Sq, int Sk, int H, int KV, int causal,
                       float scale) {
  constexpr int DPT = HD / 4;     // channels per thread
  constexpr int PAIRS = DPT / 2;  // bf16 pairs per thread
  constexpr int CHUNKS = kBK * HD / 8;  // 16-byte chunks per K/V tile
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int row = threadIdx.x / 4;
  const int quarter = threadIdx.x % 4;
  const int qi = q0 + row;

  float qf[DPT];
  const bf16* qrow = q + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    float2 f = make_float2(0.f, 0.f);
    if (qi < Sq)
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          qrow + p * 8 + quarter * 2));
    qf[2 * p] = f.x;
    qf[2 * p + 1] = f.y;
  }
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = repro::kNegInf, l = 0.f;

  __shared__ __align__(16) bf16 ks[kBK][HD];
  __shared__ __align__(16) bf16 vs[kBK][HD];

  // keys past the tile's last query row are masked for every row
  const int kend = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < CHUNKS; c += kThreads) {
      const int r = c / (HD / 8);
      const int col = (c % (HD / 8)) * 8;
      const int t = k0 + r;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (t < Sk) {
        const int64_t off =
            ((static_cast<int64_t>(b) * Sk + t) * KV + kvh) * HD + col;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][col]) = kk;
      *reinterpret_cast<uint4*>(&vs[r][col]) = vv;
    }
    __syncthreads();

    float s[kBK];
    float mx = m;
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      float part = 0.f;
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const float2 kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                &ks[c][p * 8 + quarter * 2]));
        part += qf[2 * p] * kf.x + qf[2 * p + 1] * kf.y;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + c;
      const bool ok = kj < Sk && (!causal || kj <= qi);
      s[c] = ok ? part * scale : repro::kNegInf;
      mx = fmaxf(mx, s[c]);
    }
    const float corr = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      s[c] = expf(s[c] - mx);
      psum += s[c];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const float2 vf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                &vs[c][p * 8 + quarter * 2]));
        acc[2 * p] += s[c] * vf.x;
        acc[2 * p + 1] += s[c] * vf.y;
      }
    }
    m = mx;
  }

  if (qi < Sq) {
    const float denom = fmaxf(l, repro::kMinDenom);
    bf16* orow = out + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
      *reinterpret_cast<__nv_bfloat162*>(orow + p * 8 + quarter * 2) =
          __floats2bfloat162_rn(acc[2 * p] / denom, acc[2 * p + 1] / denom);
  }
}

}  // namespace

// q (B, Sq, H, HD), k/v (B, Sk, KV, HD), out (B, Sq, H, HD): bf16,
// contiguous.  causal: key j attends to query i iff j <= i.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B,
                                    int Sq, int Sk, int H, int KV, int HD,
                                    int causal, float scale,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128) {
    flash_attention_kernel<128><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H,
        KV, causal, scale);
  } else if (HD == 64) {
    flash_attention_kernel<64><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H,
        KV, causal, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
