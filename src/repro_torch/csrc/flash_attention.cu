// Causal blocked flash attention for prefill, on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_bh / _flash_kernel, with its GQA wrapper
// flash_attention).  The TPU grid's sequential kv axis becomes a loop
// over K/V tiles inside the block, stopping at the diagonal when causal
// (the tiles Pallas skipped with pl.when).  GQA reads KV head
// h / (H / KV) in place of the reference wrapper's jnp.repeat; ragged Sq
// and Sk are masked here, with no padded copies.
//
// Bound on the H100: causal attention over L rows does about
// 2 * L * (L + 1) * H * HD FLOP against 2 * L * (H + KV) * HD * 2 bytes
// in and out.  At llama3-8b's H = 32, KV = 8, HD = 128: L = 512 moves
// 10.5 MB (3.1 us at 3.35 TB/s) for 2.15 GFLOP (2.2 us at 989 TFLOP/s),
// so bytes bind; L = 2048 does 34.4 GFLOP (35 us) for 42 MB (12.5 us),
// so operations bind.
//
// Design: FlashAttention-2 on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate).  A block of 4 warps takes 64 query rows of one (b, h),
// 16 rows a warp, and loops over 64-key tiles:
//   - Q is copied once and held in registers as A fragments (ldmatrix);
//     S = Q K^T takes K's B fragments from shared memory by ldmatrix.
//   - The online softmax runs on the S accumulators in fp32: a thread
//     holds two rows (g and g + 8 of its warp's 16), whose max is
//     reduced over the quad with two shuffles; the row sum stays a
//     per-thread partial until the end.  Masked scores are -1e30 (not
//     -inf), l is clamped at kMinDenom, causal means key j <= query i.
//   - O += P V: the S accumulator layout of m16n8k16 is the A-operand
//     layout of the next product, so P goes from fp32 accumulators to
//     bf16 A fragments in registers and never touches shared memory;
//     V's B fragments come by ldmatrix.trans.  P is split into two bf16
//     terms, hi = bf16(p) and lo = bf16(p - hi), each multiplied by V:
//     a single bf16 P (FlashAttention-2's choice) is off by up to 2^-9
//     of each weight, which at q, k of std 1.5 puts a few outputs near
//     0 outside 2e-3 + 1.6e-2 relative of the plain version; hi + lo
//     keeps P to 2^-17.  It costs a second P V mma per fragment (1.5x
//     the tensor-core work of one P).  Per 16-key step the V fragments
//     are loaded first, then the hi mma into all 16 O tiles, then the lo
//     ones, so that no mma waits on the one just issued.
//   - K and V tiles go through a 2-stage cp.async ring (16-byte copies,
//     neighbouring threads on neighbouring addresses), so tile j + 1
//     loads while tile j is computed.  Rows are stored with their
//     16-byte chunks XOR-swizzled by row, so ldmatrix's eight row
//     addresses fall in distinct banks.  Shared memory: Q 64 x HD plus
//     2 x (K + V) 64 x HD, 80 KB at HD 128 (above 48 KB, so the launch
//     sets cudaFuncAttributeMaxDynamicSharedMemorySize first).
//   - Causal query tiles launch heaviest first (reversed blockIdx.x), so
//     the long diagonal tiles do not end the grid alone.
// mma.sync rather than wgmma/TMA: at the main path's shape (B 1,
// L <= 512, 256 blocks of 64 rows) the kernel is bound by latency and
// occupancy, not by the tensor-core rate, and mma.sync reaches the
// tensor cores with register-level fragments that are simpler to get
// right; wgmma is the later step for long prompts.
#include "common.cuh"

namespace {

using repro::bf16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::smem_addr;

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per K/V tile
constexpr int kWarps = kBQ / 16;    // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of 16-byte chunk c of row r in a [rows][HD] bf16 tile:
// chunk c of row r sits at chunk position c ^ (r % 8).
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (HD * 2) + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// (x, y) -> bf16 pair hi and the bf16 pair of what hi leaves out.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int Sq, int Sk, int H, int KV, int causal,
                       float scale) {
  constexpr int CH = HD / 8;          // 16-byte chunks per row
  constexpr int KC = HD / 16;         // k-steps of Q K^T
  constexpr int NT = kBK / 8;         // 8-key n-tiles of S
  constexpr int DT = HD / 8;          // 8-channel n-tiles of O
  constexpr uint32_t TILE = kBK * HD * 2;   // bytes of one K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK = sQ + kBQ * HD * 2;     // 2 stages
  const uint32_t sV = sK + 2 * TILE;         // 2 stages

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;            // fragment row (and g + 8)
  const int t4 = lane & 3;            // fragment column pair
  const int wrow = warp * 16;         // the warp's first row in the tile
  const int64_t qstride = static_cast<int64_t>(H) * HD;
  const int64_t kstride = static_cast<int64_t>(KV) * HD;
  const bf16* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * HD;
  const bf16* kb = k + (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;
  const bf16* vb = v + (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;

  for (int c = threadIdx.x; c < kBQ * CH; c += kThreads) {
    const int r = c / CH, ch = c % CH;
    const bool ok = q0 + r < Sq;
    cp_async16(sQ + swz<HD>(r, ch),
               ok ? qb + (q0 + r) * qstride + ch * 8 : qb, ok);
  }
  auto load_kv = [&](int tile, uint32_t stage) {
    const int k0 = tile * kBK;
    for (int c = threadIdx.x; c < kBK * CH; c += kThreads) {
      const int r = c / CH, ch = c % CH;
      const bool ok = k0 + r < Sk;
      const int64_t off = ok ? (k0 + r) * kstride + ch * 8 : 0;
      cp_async16(sK + stage * TILE + swz<HD>(r, ch), kb + off, ok);
      cp_async16(sV + stage * TILE + swz<HD>(r, ch), vb + off, ok);
    }
  };

  // keys past the tile's last query row are masked for every row
  const int kend = causal ? min(Sk, q0 + kBQ) : Sk;
  const int ntiles = (kend + kBK - 1) / kBK;
  load_kv(0, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;   // scores in log2 units: exp2f
  const int qi0 = q0 + wrow + g, qi1 = qi0 + 8;
  uint32_t qf[KC][4];
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = repro::kNegInf, m1 = repro::kNegInf, l0 = 0.f, l1 = 0.f;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, its row

  for (int j = 0; j < ntiles; ++j) {
    const uint32_t stage = j & 1;
    if (j + 1 < ntiles) {
      load_kv(j + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(sQ + swz<HD>(wrow + (lane & 15), kc * 2 + (lane >> 4)),
                qf[kc]);
    }

    // S = Q K^T: 16 rows x 64 keys a warp, in 8 n-tiles
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const uint32_t kst = sK + stage * TILE;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(kst + swz<HD>(np * 16 + (mi >> 1) * 8 + mr,
                              kc * 2 + (mi & 1)), bk);
        mma_bf16(s[2 * np], qf[kc], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kc], bk[2], bk[3]);
      }
    }

    // online softmax on the accumulators
    const int k0 = j * kBK;
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * sl2;
        if (edge) {
          const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int qi = e < 2 ? qi0 : qi1;
          if (key >= Sk || (causal && key > qi)) x = repro::kNegInf;
        }
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx0);
      s[nt][1] = exp2f(s[nt][1] - mx0);
      s[nt][2] = exp2f(s[nt][2] - mx1);
      s[nt][3] = exp2f(s[nt][3] - mx1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * c0 + ps0;     // this thread's columns; the quad sums at the end
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= c0;
      o[dt][1] *= c0;
      o[dt][2] *= c1;
      o[dt][3] *= c1;
    }

    // O += P V: P's A fragments straight from the S accumulators
    const uint32_t vst = sV + stage * TILE;
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
      uint32_t bv[DT / 2][4];
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp)
        ldsm_x4_trans(vst + swz<HD>(kc * 16 + (mi & 1) * 8 + mr,
                                    dp * 2 + (mi >> 1)), bv[dp]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        mma_bf16(o[2 * dp], ph, bv[dp][0], bv[dp][1]);
        mma_bf16(o[2 * dp + 1], ph, bv[dp][2], bv[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        mma_bf16(o[2 * dp], pl, bv[dp][0], bv[dp][1]);
        mma_bf16(o[2 * dp + 1], pl, bv[dp][2], bv[dp][3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before refill
  }

  // normalise; stage the warp's 16 rows in its own (consumed) Q rows so
  // that each lane stores 16 contiguous bytes
  const float inv0 = 1.f / fmaxf(quad_sum(l0), repro::kMinDenom);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), repro::kMinDenom);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    *reinterpret_cast<__nv_bfloat162*>(smem + swz<HD>(wrow + g, dt) +
                                       4 * t4) =
        __floats2bfloat162_rn(o[dt][0] * inv0, o[dt][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(smem + swz<HD>(wrow + g + 8, dt) +
                                       4 * t4) =
        __floats2bfloat162_rn(o[dt][2] * inv1, o[dt][3] * inv1);
  }
  __syncwarp();
  bf16* ob = out + (static_cast<int64_t>(b) * Sq * H + h) * HD;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH;
    const int qi = q0 + wrow + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(ob + qi * qstride + ch * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<HD>(wrow + r, ch));
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
           int Sq, int Sk, int H, int KV, int causal, float scale,
           cudaStream_t st) {
  constexpr int smem = (kBQ + 4 * kBK) * HD * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<HD><<<grid, kThreads, smem, st>>>(
      q, k, v, out, Sq, Sk, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, HD), k/v (B, Sk, KV, HD), out (B, Sq, H, HD): bf16,
// contiguous, 16-byte aligned.  causal: key j attends to query i iff
// j <= i.  HD 64 or 128.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B,
                                    int Sq, int Sk, int H, int KV, int HD,
                                    int causal, float scale,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch<128>(qp, kp, vp, op, B, Sq, Sk, H, KV, causal, scale, st);
  if (HD == 64)
    return launch<64>(qp, kp, vp, op, B, Sq, Sk, H, KV, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
