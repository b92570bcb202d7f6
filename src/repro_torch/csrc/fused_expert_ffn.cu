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
// behind one entry point.  Each launch covers an expert range
// [e_lo, e_hi) of E (an expert shard of a mesh; the whole kernel is the
// range [0, E)), and a (token, slot) is "in range" when its id lies in
// it.  The in-range slots are found on the device, never on the host:
//
//  pass 1 (up), grid (ceil(F / kUpCols) * S, groups) in clusters of S:
//    every block ranks the B*K ids itself (a ballot and a block scan
//    over chunks of kThreads ids), so that the in-range slots form one
//    compact list in slot order; block (tile * S + s, g) takes the
//    list's entries g, g + groups, ...  For each it reads the rows
//    [s * rows, (s + 1) * rows) of Wg[e] and Wu[e], and x[b] at them:
//    each thread owns 8 neighbouring columns f of the F tile, read as
//    one 16-byte load per row of Wg and of Wu with x's value beside it,
//    kUpUnroll rows in flight, and the block's kUpRows row groups split
//    the rows.  Their sums meet in shared memory as the split's fp32
//    partial g and u; splits 1.. store theirs to scratch, and after a
//    barrier over the cluster (the S splits of one F tile and slot
//    group) split 0 adds them to its own in split order and stores
//    h = silu(g) * u (silu after the sum over the splits: it is not
//    linear) to the (B*K, F) scratch.
//  pass 2 (down), grid (D / kDownCols, B): the block ranks its token's K
//    ids and stages wts[b,k] * h[b,k,:] for the in-range slots alone in
//    shared memory, its first weight rows already in flight; each thread
//    owns 8 columns d of a narrow tile and walks the rows (slot, f) of
//    those slots' Wd[e], slot-major (the order of the sum over the
//    slots), kDownUnroll rows in flight; the row groups' partials meet
//    in shared memory and the sum is stored as bf16, or as an fp32
//    partial with out_f32.
//
// Bound on the H100: device-memory bytes.  The routed experts' weights,
// 3 * D * F * 2 bytes each (9.4 MB at qwen3-moe-30b-a3b), dwarf x, h,
// the partials and the output, and each weight is used for one token's
// product.  So the launch has to keep loads in flight on every SM, and
// its grid follows the slots the range expects, not B*K: with m =
// ceil(B*K * (e_hi - e_lo) / E) the expected in-range slots,
// kernels/_launch.py::expert_plan picks S D-splits (at most 8, the
// portable cluster size) from the shapes alone so that m * ceil(F /
// kUpCols) * S blocks reach twice the SM count, and the grid has
// groups = m + ceil(2 sqrt(m)) slot groups (at most B*K): the count a
// range sees is about binomial, so all but a few percent of draws take
// one round of the grid, and a group past the count exits after its
// ranking.  A quarter of qwen3-moe-30b-a3b's 128 experts at batch 4,
// top-8: m = 8, 6 tiles x 6 splits, 288 expected working blocks of 504
// for 132 SMs, where one block per (token, slot) left about 48 of 192
// blocks working.  A range that routes more slots than the grid has
// groups walks them in the same grid; one that routes none reads no
// weight.  The wrapper sizes the scratch for the plan's S, and the
// kernel splits D as many ways as the scratch holds partials for.  What
// is left: each (token, slot) reads its expert on its own, so an expert
// that several tokens route to is read several times (32 reads against
// the 28-32 distinct experts a batch of 4 routes); grouping the tokens
// by expert, and wgmma at larger batch, are later work.
//
// An id outside [0, E) reads nothing and makes its token's output NaN,
// in the whole kernel and in every range.  Over a range the weight
// pointers are the shard's (e_hi - e_lo, D, F) / (.., F, D) stacks and
// a slot routed elsewhere adds 0; with out_f32 the sum is stored as an
// fp32 (B, D) partial, so that the shards' partials are summed before
// the one rounding to bf16.
#include "common.cuh"

namespace {

using repro::bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                              // bf16 per 16 bytes
constexpr int kUpCols = 128;                         // pass 1: F per block
constexpr int kUpRows = kThreads / (kUpCols / kVec);        // 16
constexpr int kUpUnroll = 8;         // pass 1: rows in flight per matrix
constexpr int kDownCols = 32;                        // pass 2: D per block
constexpr int kDownRows = kThreads / (kDownCols / kVec);    // 64
constexpr int kDownUnroll = 8;       // pass 2: rows in flight
constexpr int kMaxSplits = 8;        // D splits: the portable cluster size

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

__device__ __forceinline__ bool in_range(int e, int e_lo, int e_hi) {
  return e >= e_lo && e < e_hi;
}

// The rank of this thread's ``flag`` among the block's set flags, in
// thread order; ``total`` gets their count.  Every thread must call it.
__device__ __forceinline__ int block_rank(bool flag, int* warp_tot,
                                          int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_tot[warp] = __popc(m);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    total += t;
  }
  return before + __popc(m & ((1u << lane) - 1u));
}

// Every thread of every block of the cluster must call it: a barrier
// over the cluster whose release / acquire makes the partials that the
// other blocks stored before it visible to the first block after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// x[i] as fp32, through the read-only cache (a value is shared by the
// 16 threads of a row).
__device__ __forceinline__ float ld_x(const bf16* x, int64_t i) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(x) + i)));
}

// Pass 1, launched in clusters of the S blocks of one (F tile, slot
// group), split s = the block's rank.  Shared memory: one chunk's
// in-range slots, the warps' counts, and the (kUpRows, kUpCols)
// partials of g and of u.  Each thread reads its rows' x values beside
// their weight rows, kUpUnroll rows a batch.
// Splits 1.. store their column sums to ``part`` (B*K, S - 1, 2, F);
// after the cluster barrier split 0 adds them to its own in split order
// and stores h = silu(g) * u to ``h`` (B*K, F).
__global__ void __launch_bounds__(kThreads)
expert_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                 const bf16* __restrict__ wu,
                 const int32_t* __restrict__ ids, float* __restrict__ h,
                 float* __restrict__ part, int BK, int K, int D, int F,
                 int e_lo, int e_hi, int S, int rows) {
  __shared__ int slots[kThreads];
  __shared__ int warp_tot[kWarps];
  __shared__ float red_g[kUpRows * kUpCols], red_u[kUpRows * kUpCols];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x / S, s = blockIdx.x % S;
  const int d_lo = s * rows, d_hi = min(D, d_lo + rows);
  const int grp = tid % (kUpCols / kVec), row = tid / (kUpCols / kVec);
  const int f0 = tile * kUpCols + grp * kVec;
  const int fc = tile * kUpCols + tid;        // the column tid sums
  const bool col = tid < kUpCols && fc < F;
  const int groups = gridDim.y, g = blockIdx.y;
  int seen = 0;                       // in-range slots of earlier chunks
  for (int c0 = 0; c0 < BK; c0 += kThreads) {
    const int i = c0 + tid;
    const bool mine = i < BK && in_range(__ldg(ids + i), e_lo, e_hi);
    int n;
    const int r = block_rank(mine, warp_tot, n);
    if (mine) slots[r] = i;
    __syncthreads();
    // this block's entries of the compact list: ranks = g mod groups;
    // the cluster's S blocks take the same ones
    int j = (g - seen) % groups;
    if (j < 0) j += groups;
    for (; j < n; j += groups) {
      const int slot = slots[j];
      const int64_t xb = static_cast<int64_t>(slot / K) * D;
      float ag[kVec] = {}, au[kVec] = {};
      if (f0 < F) {
        const int64_t base =
            static_cast<int64_t>(__ldg(ids + slot) - e_lo) * D * F + f0;
        const bf16* pg = wg + base;
        const bf16* pu = wu + base;
        for (int d = d_lo + row; d < d_hi; d += kUpUnroll * kUpRows) {
          uint4 rg[kUpUnroll], ru[kUpUnroll];
          float xv[kUpUnroll];
#pragma unroll
          for (int t = 0; t < kUpUnroll; ++t) {
            // past the split, its last row again with x's value 0: every
            // load is issued unconditionally, none waits for a branch
            const int dt = min(d + t * kUpRows, d_hi - 1);
            const int64_t o = static_cast<int64_t>(dt) * F;
            rg[t] = ld16(pg + o);
            ru[t] = ld16(pu + o);
            xv[t] = ld_x(x, xb + dt);
            if (d + t * kUpRows >= d_hi) xv[t] = 0.f;
          }
#pragma unroll
          for (int t = 0; t < kUpUnroll; ++t) {
            fma8(xv[t], rg[t], ag);
            fma8(xv[t], ru[t], au);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        red_g[row * kUpCols + grp * kVec + t] = ag[t];
        red_u[row * kUpCols + grp * kVec + t] = au[t];
      }
      __syncthreads();
      float sg = 0.f, su = 0.f;
      if (col) {
        for (int q = 0; q < kUpRows; ++q) {
          sg += red_g[q * kUpCols + tid];
          su += red_u[q * kUpCols + tid];
        }
        if (s > 0) {
          float* p = part + (static_cast<int64_t>(slot) * (S - 1) + s - 1)
                                * 2 * F;
          p[fc] = sg;
          p[F + fc] = su;
        }
      }
      cluster_sync();                 // also the block's: red reusable
      if (col && s == 0) {
        const float* p = part + static_cast<int64_t>(slot) * (S - 1) * 2 * F;
        for (int q = 1; q < S; ++q) {
          sg += __ldcg(p + (q - 1) * 2 * F + fc);
          su += __ldcg(p + (q - 1) * 2 * F + F + fc);
        }
        h[static_cast<int64_t>(slot) * F + fc] = sg / (1.f + expf(-sg)) * su;
      }
    }
    seen += n;
    __syncthreads();                  // slots are the next chunk's
  }
}

// Pass 2's weight rows q, q + kDownRows, ... (kDownUnroll of them) of
// the flattened (slot j, f) rows, j major; past ``total`` (> 0) the
// first slot's row 0 again, which the caller weighs with 0.
__device__ __forceinline__ void ld_down(const bf16* p, const int64_t* eoff,
                                        int q, int total, int F, int D,
                                        uint4 (&r)[kDownUnroll]) {
  int j = q / F, f = q - j * F;
#pragma unroll
  for (int t = 0; t < kDownUnroll; ++t) {
    const bool ok = q + t * kDownRows < total;
    r[t] = ld16(p + eoff[ok ? j : 0] + static_cast<int64_t>(ok ? f : 0) * D);
    f += kDownRows;
    while (f >= F) {
      f -= F;
      ++j;
    }
  }
}

// Pass 2.  Shared memory: wts[b,k] * h[b,k,:] for the token's n
// in-range slots in slot order (n*F floats, at most K*F), the
// (kDownRows, kDownCols) partials, each in-range slot's expert offset in
// wd and its k, then the warps' counts.  Each thread walks the rows
// (slot j, f) of its column tile, j major, kDownUnroll rows in flight.
// Stores bf16 to out, or the fp32 sum to out_f32 where it is given.
__global__ void __launch_bounds__(kThreads)
expert_down_kernel(const float* __restrict__ h, const bf16* __restrict__ wd,
                   const int32_t* __restrict__ ids,
                   const float* __restrict__ wts, bf16* __restrict__ out,
                   float* __restrict__ out_f32, int K, int D, int F, int E,
                   int e_lo, int e_hi) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* red = hs + static_cast<int64_t>(K) * F;
  int64_t* eoff = reinterpret_cast<int64_t*>(red + kDownRows * kDownCols);
  int* kl = reinterpret_cast<int*>(eoff + K);
  int* warp_tot = kl + K;
  const int tid = threadIdx.x;
  const int64_t tok = static_cast<int64_t>(blockIdx.y) * K;
  int n = 0;
  bool bad = false;
  for (int c0 = 0; c0 < K; c0 += kThreads) {
    const int k = c0 + tid;
    const int e = k < K ? __ldg(ids + tok + k) : 0;
    bad |= __syncthreads_or(k < K && (e < 0 || e >= E)) != 0;
    const bool mine = k < K && in_range(e, e_lo, e_hi);
    int cnt;
    const int r = n + block_rank(mine, warp_tot, cnt);
    if (mine) {
      kl[r] = k;
      eoff[r] = static_cast<int64_t>(e - e_lo) * F * D;
    }
    n += cnt;
    __syncthreads();
  }
  if (bad) n = 0;                     // the row is NaN: nothing read
  const int total = n * F;
  const int grp = tid % (kDownCols / kVec), row = tid / (kDownCols / kVec);
  const int d0 = blockIdx.x * kDownCols + grp * kVec;
  const bf16* p = wd + d0;
  const bool cols = d0 < D;
  uint4 r[kDownUnroll];
  if (cols && total > 0)           // in flight while h is staged
    ld_down(p, eoff, row, total, F, D, r);
#pragma unroll 4
  for (int i = tid; i < total; i += kThreads) {
    const int k = kl[i / F];
    hs[i] = __ldg(wts + tok + k) * h[(tok + k) * F + i % F];
  }
  __syncthreads();

  float acc[kVec] = {};
  if (cols) {
    for (int q = row; q < total; q += kDownUnroll * kDownRows) {
#pragma unroll
      for (int t = 0; t < kDownUnroll; ++t) {
        const int i = q + t * kDownRows;
        fma8(i < total ? hs[i] : 0.f, r[t], acc);
      }
      if (q + kDownUnroll * kDownRows < total)
        ld_down(p, eoff, q + kDownUnroll * kDownRows, total, F, D, r);
    }
  }
#pragma unroll
  for (int t = 0; t < kVec; ++t)
    red[row * kDownCols + grp * kVec + t] = acc[t];
  __syncthreads();
  for (int c = tid; c < kDownCols; c += kThreads) {
    const int d = blockIdx.x * kDownCols + c;
    if (d >= D) continue;
    float sum = 0.f;
    for (int q = 0; q < kDownRows; ++q) sum += red[q * kDownCols + c];
    if (bad) sum = nan_f();
    if (out_f32)
      out_f32[blockIdx.y * static_cast<int64_t>(D) + d] = sum;
    else
      out[blockIdx.y * static_cast<int64_t>(D) + d] = __float2bfloat16(sum);
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
// (B, K) fp32; [h, h_end) fp32 scratch: h (B*K, F), then the partials
// (B*K, S - 1, 2, F) of the D splits past the first, so that its size,
// B*K * (2S - 1) * F floats, gives S, the number of D splits (the plan
// of kernels/_launch.py::expert_plan, at most kMaxSplits, the portable
// cluster size; each split ceil(D / S) rows rounded up to a multiple of
// 8, none empty); out (B, D) bf16, or fp32 where out_f32 is nonzero.
// All contiguous and 16-byte aligned; D and F multiples of 8.  The whole
// kernel: e_lo 0, e_hi E, out_f32 0.
extern "C" int fused_expert_ffn_bf16(const void* x, const void* wg,
                                     const void* wu, const void* wd,
                                     const void* ids, const void* wts,
                                     void* h, void* h_end, void* out, int B,
                                     int K, int D, int F, int E, int e_lo,
                                     int e_hi, int out_f32, void* stream) {
  if (B <= 0 || K <= 0 || D <= 0 || F <= 0 || E <= 0 || D % kVec ||
      F % kVec || B * K > 65535 || e_lo < 0 || e_hi > E || e_lo > e_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  const int BK = B * K;
  const int64_t row_bytes = static_cast<int64_t>(BK) * F * sizeof(float);
  const int64_t bytes = static_cast<char*>(h_end) - static_cast<char*>(h);
  if (bytes <= 0 || bytes % row_bytes || (bytes / row_bytes) % 2 == 0 ||
      (bytes / row_bytes + 1) / 2 > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = static_cast<int>((bytes / row_bytes + 1) / 2);
  const int rows = ((D + S - 1) / S + kVec - 1) / kVec * kVec;
  if ((S - 1) * rows >= D) return static_cast<int>(cudaErrorInvalidValue);
  // the slots the range expects, and two standard deviations over them
  const int m = static_cast<int>(
      (static_cast<int64_t>(BK) * (e_hi - e_lo) + E - 1) / E);
  const int groups =
      m ? min(BK, m + static_cast<int>(ceil(2.0 * sqrt(double(m))))) : 0;
  const size_t down_smem =
      (static_cast<size_t>(K) * F + kDownRows * kDownCols) * sizeof(float) +
      static_cast<size_t>(K) * (sizeof(int64_t) + sizeof(int)) +
      kWarps * sizeof(int);
  cudaError_t err = allow_smem(expert_down_kernel, down_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h);
  if (groups > 0) {
    cudaLaunchConfig_t up = {};
    up.gridDim = dim3((F + kUpCols - 1) / kUpCols * S, groups);
    up.blockDim = dim3(kThreads);
    up.dynamicSmemBytes = 0;
    up.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = S;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    up.attrs = cluster;
    up.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &up, expert_up_kernel, static_cast<const bf16*>(x),
        static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
        static_cast<const int32_t*>(ids), hf,
        hf + static_cast<int64_t>(BK) * F, BK, K, D, F, e_lo, e_hi, S, rows);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  expert_down_kernel<<<dim3((D + kDownCols - 1) / kDownCols, B), kThreads,
                       down_smem, st>>>(
      hf, static_cast<const bf16*>(wd), static_cast<const int32_t*>(ids),
      static_cast<const float*>(wts),
      out_f32 ? nullptr : static_cast<bf16*>(out),
      out_f32 ? static_cast<float*>(out) : nullptr, K, D, F, E, e_lo, e_hi);
  return static_cast<int>(cudaGetLastError());
}
