// The prefill MoE's dispatch and combine (models/modules.py::moe_fwd)
// as three kernels over one layout of the capacity buckets.
//
// No TPU kernel is replaced: the reference's moe_fwd is plain JAX (a
// one-hot cumsum, a scatter-add per slot, a gather per slot), and so
// were the port's plain versions (kernels/ref.py::moe_bucket_*), which
// on the card run as some 130 PyTorch operations a layer, each one or
// more launches: the host's enqueue of them was most of a prefill.
// Here the same work is three launches and one memset, and every value
// is the plain version's bit for bit:
//
//  moe_bucket_positions_kernel, grid (G): for each (token t, slot j) of
//    group g, in token-major order with j fastest, the number of earlier
//    slots of the group routed to the same expert (its position in the
//    expert's bucket; the plain cumsum of a one-hot, minus one).  One
//    block per group walks its T*k slots in chunks of blockDim: each
//    warp ranks its lanes by __match_any_sync (lanes routed alike, the
//    lower lanes first), the warps' per-expert counts go to shared
//    memory, and one thread per expert turns them into each warp's
//    first position, carrying the running count to the next chunk.  An
//    id outside [0, E) gets position INT_MAX (kept by no bucket).
//  moe_bucket_scatter_kernel, grid (G*T): each token's row of x is
//    read once, as 16-byte vectors, and stored to the row (e, g, pos)
//    of the expert-major buffer (E, G, C, D) for each of its slots with
//    pos < C; the launch function first zeroes the buffer (the rows no
//    slot fills).  The plain version adds each row to a zero buffer
//    (index_put_ with accumulate), so a -0 element lands as +0: the
//    kernel adds +0 too, and the buffer the expert products read is
//    the plain one.  Slots past capacity are dropped, where the plain
//    version sends them to a dump slot it then discards.
//  moe_bucket_combine_kernel, grid (G*T): out[g, t] = the sum over j in
//    order of row(e_j, g, min(pos_j, C - 1)) * w_j, w_j = topw_j * (pos_j
//    < C) rounded to the element type, each product rounded to it
//    before it is added and each sum rounded after (the plain
//    version's bf16 tensor arithmetic, operation for operation; the
//    intrinsics keep the multiply and the add apart).  A dropped slot
//    reads row C - 1 and adds its product with a zero weight, as the
//    plain version does.  A token with an id outside [0, E) is NaN.
//
// Bound on the H100: device-memory bytes.  At qwen3-moe-30b-a3b's
// prefill (D 2048, E 128, top-8, capacity 1.25) of 5003 tokens (one
// group, C 390): the memset writes E*G*C*D*2 = 204 MB, the scatter
// reads 20 MB of x and writes up to 164 MB of rows, the combine reads
// 164 MB of rows and writes 20 MB; positions read and write 0.5 MB.
// Element types: bf16 and fp32 (a model held in fp32).
#include "common.cuh"

#include <algorithm>
#include <climits>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRowThreads = 128;   // threads a token's row takes
constexpr size_t kSmemLimit = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(repro::bf16 x) {
  return __bfloat162float(x);
}

// x rounded to the element type T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<repro::bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of T (8 bf16 or 4 fp32) as fp32, and back
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  static __device__ __forceinline__ void load(const T* p, float (&v)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f32(e[i]);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[N]) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = static_cast<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__global__ void __launch_bounds__(kMaxThreads)
moe_bucket_positions_kernel(const long long* __restrict__ ids,
                            int* __restrict__ pos, int TK, int E) {
  extern __shared__ int smem[];
  const int warps = blockDim.x / 32;
  int* cnt = smem;                   // (warps, E): a chunk's count per warp
  int* first = smem + warps * E;     // (warps, E): a warp's first position
  int* run = smem + 2 * warps * E;   // (E,): the group's count so far
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int i = threadIdx.x; i < warps * E; i += blockDim.x) cnt[i] = 0;
  for (int e = threadIdx.x; e < E; e += blockDim.x) run[e] = 0;
  const long long* gids = ids + static_cast<long long>(blockIdx.x) * TK;
  int* gpos = pos + static_cast<long long>(blockIdx.x) * TK;
  __syncthreads();
  for (int c0 = 0; c0 < TK; c0 += blockDim.x) {
    const int i = c0 + threadIdx.x;
    const long long id = i < TK ? gids[i] : -1;
    const bool ok = id >= 0 && id < E;
    const int e = ok ? static_cast<int>(id) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(same & ((1u << lane) - 1u));
    if (ok && rank == 0) cnt[warp * E + e] = __popc(same);
    __syncthreads();
    for (int x = threadIdx.x; x < E; x += blockDim.x) {
      int r = run[x];
      for (int w = 0; w < warps; ++w) {
        first[w * E + x] = r;
        r += cnt[w * E + x];
        cnt[w * E + x] = 0;
      }
      run[x] = r;
    }
    __syncthreads();
    // the next chunk writes cnt (zeroed above) before its first barrier
    // and first only after it, so no third barrier is needed
    if (i < TK) gpos[i] = ok ? first[warp * E + e] + rank : INT_MAX;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
moe_bucket_scatter_kernel(const T* __restrict__ x,
                          const long long* __restrict__ ids,
                          const int* __restrict__ pos, T* __restrict__ buf,
                          int Tg, int k, int D, int G, int C, int E) {
  using V = Vec<T>;
  const long long tok = blockIdx.x;
  const int g = static_cast<int>(tok / Tg);
  const T* row = x + tok * D;
  for (int c = threadIdx.x * V::N; c < D; c += kRowThreads * V::N) {
    float v[V::N];
    V::load(row + c, v);
#pragma unroll
    for (int i = 0; i < V::N; ++i) v[i] = __fadd_rn(v[i], 0.0f);  // -0 -> +0
    for (int j = 0; j < k; ++j) {
      const long long e = ids[tok * k + j];
      const int p = pos[tok * k + j];
      if (e < 0 || e >= E || p < 0 || p >= C) continue;
      V::store(buf + ((e * G + g) * C + p) * D + c, v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
moe_bucket_combine_kernel(const T* __restrict__ eo,
                          const long long* __restrict__ ids,
                          const float* __restrict__ topw,
                          const int* __restrict__ pos, T* __restrict__ out,
                          int Tg, int k, int D, int G, int C, int E) {
  using V = Vec<T>;
  const long long tok = blockIdx.x;
  const int g = static_cast<int>(tok / Tg);
  for (int c = threadIdx.x * V::N; c < D; c += kRowThreads * V::N) {
    float acc[V::N];
#pragma unroll
    for (int i = 0; i < V::N; ++i) acc[i] = 0.0f;
    bool bad = false;
    for (int j = 0; j < k; ++j) {
      const long long e = ids[tok * k + j];
      const int p = pos[tok * k + j];
      if (e < 0 || e >= E || p < 0) {
        bad = true;
        continue;
      }
      const float w =
          round_to<T>(__fmul_rn(topw[tok * k + j], p < C ? 1.0f : 0.0f));
      float r[V::N];
      V::load(eo + ((e * G + g) * C + min(p, C - 1)) * D + c, r);
#pragma unroll
      for (int i = 0; i < V::N; ++i)
        acc[i] =
            round_to<T>(__fadd_rn(acc[i], round_to<T>(__fmul_rn(r[i], w))));
    }
    if (bad) {
#pragma unroll
      for (int i = 0; i < V::N; ++i) acc[i] = __int_as_float(0x7fffffff);
    }
    V::store(out + tok * D + c, acc);
  }
}

bool bad_rows(long long N, int Tg, int k, int D, int G, int C, int E,
              int vec) {
  return N <= 0 || Tg <= 0 || k <= 0 || D <= 0 || G <= 0 || C <= 0 ||
         E <= 0 || D % vec || N != static_cast<long long>(G) * Tg ||
         N > INT_MAX;
}

template <typename T>
int scatter(const void* x, const void* ids, const void* pos, void* buf,
            long long N, int Tg, int k, int D, int G, int C, int E,
            cudaStream_t st) {
  if (bad_rows(N, Tg, k, D, G, C, E, Vec<T>::N))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(E) * G * C * D * sizeof(T);
  cudaError_t err = cudaMemsetAsync(buf, 0, bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_bucket_scatter_kernel<T><<<static_cast<unsigned>(N), kRowThreads, 0,
                                 st>>>(
      static_cast<const T*>(x), static_cast<const long long*>(ids),
      static_cast<const int*>(pos), static_cast<T*>(buf), Tg, k, D, G, C, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine(const void* eo, const void* ids, const void* topw,
            const void* pos, void* out, long long N, int Tg, int k, int D,
            int G, int C, int E, cudaStream_t st) {
  if (bad_rows(N, Tg, k, D, G, C, E, Vec<T>::N))
    return static_cast<int>(cudaErrorInvalidValue);
  moe_bucket_combine_kernel<T><<<static_cast<unsigned>(N), kRowThreads, 0,
                                 st>>>(
      static_cast<const T*>(eo), static_cast<const long long*>(ids),
      static_cast<const float*>(topw), static_cast<const int*>(pos),
      static_cast<T*>(out), Tg, k, D, G, C, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids: (G, TK) int64; pos: (G, TK) int32 out.  G >= 1, TK >= 1, E >= 1
// with a chunk of at least one warp fitting shared memory.
extern "C" int moe_bucket_positions_i64(const void* ids, void* pos, int G,
                                        int TK, int E, void* stream) {
  if (G <= 0 || TK <= 0 || E <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // (2 * warps + 1) * E counters in the 48 KiB a block may take
  const long long fit =
      (static_cast<long long>(kSmemLimit / sizeof(int)) / E - 1) / 2;
  int warps = static_cast<int>(
      std::min<long long>({fit, kMaxThreads / 32, (TK + 31) / 32}));
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2 * warps + 1) * E * sizeof(int);
  moe_bucket_positions_kernel<<<G, warps * 32, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ids), static_cast<int*>(pos), TK, E);
  return static_cast<int>(cudaGetLastError());
}

// x: (G*Tg, D); ids (int64), pos (int32): (G*Tg, k); buf: (E, G, C, D),
// zeroed here, then filled.  dtype 0 fp32, 1 bf16; D a multiple of 16
// bytes' elements; x and buf 16-byte aligned.
extern "C" int moe_bucket_scatter(const void* x, const void* ids,
                                  const void* pos, void* buf, long long N,
                                  int Tg, int k, int D, int G, int C, int E,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return scatter<float>(x, ids, pos, buf, N, Tg, k, D, G, C, E, st);
    case 1:
      return scatter<repro::bf16>(x, ids, pos, buf, N, Tg, k, D, G, C, E,
                                  st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// eo: (E, G, C, D) expert outputs; ids (int64), topw (fp32), pos (int32):
// (G*Tg, k); out: (G*Tg, D).  dtype, D and alignment as the scatter's.
extern "C" int moe_bucket_combine(const void* eo, const void* ids,
                                  const void* topw, const void* pos,
                                  void* out, long long N, int Tg, int k,
                                  int D, int G, int C, int E, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return combine<float>(eo, ids, topw, pos, out, N, Tg, k, D, G, C, E,
                            st);
    case 1:
      return combine<repro::bf16>(eo, ids, topw, pos, out, N, Tg, k, D, G,
                                  C, E, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
