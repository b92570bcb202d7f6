// One decode token of the Mamba-2 SSM for a batch of rows, over a pool
// of per-request state slots (models/modules.py::mamba2_step).
//
// No TPU kernel is replaced: the reference has no decode form of the
// published Mamba-2 block.  In plain PyTorch (kernels/ref.py::
// ssm_state_update) one step is a gather of the rows' states, the
// decay, the outer product dt B x^T, the add, a scatter back and the
// readout C^T state: four or five passes over the state and a
// temporary per layer.  At granite-4.0-h-small's shapes (128 heads,
// N 128, P 64: 4 MiB of fp32 state a row and layer) and 64 rows that
// is 512 MiB of state a layer, which this kernel reads once and writes
// once.
//
//  ssm_state_update_kernel, grid (H, B), kThreads threads: block (h, b)
//    owns the (N, P) state of head h in slot slots[b].  Thread t takes
//    the 4 columns 4 (t % (P/4)) .. + 3 and the rows t / (P/4) + k R,
//    R = kThreads / (P/4) rows a pass; it loads kBatch rows' float4s at
//    once (loads in flight before any store), then for each row n
//      s = exp(dt A_h) s + (dt B_n) x      (x: the head's 4 columns)
//    stores s in place and adds C_n s to its column sums.  The rows'
//    sums meet in shared memory: y = sum_n C_n s_n + D_h x.  B and C
//    are the row's group's (head h reads group h / (H / G)), read from
//    global memory (the block's threads share them through L1).  A slot
//    outside [0, n_slots) leaves every state untouched and gives a NaN
//    row of y.  x, B and C are column slices of row-major buffers with
//    row strides of their own (the conv output [x, B, C] of a step).
//
// Bound on the H100: device-memory bytes, the state read and written
// once: 2 * B * H * N * P * 4 bytes (512 MiB a layer at 64 rows,
// 0.16 ms at 3.35 TB/s); x, B, C, dt and y are under 0.3% of it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;   // rows a thread has in flight

__global__ void __launch_bounds__(kThreads)
ssm_state_update_kernel(float* __restrict__ state,
                        const int* __restrict__ slots,
                        const repro::bf16* __restrict__ x, long long x_ld,
                        const repro::bf16* __restrict__ Bm,
                        const repro::bf16* __restrict__ Cm, long long bc_ld,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Dv, float* __restrict__ y,
                        int n_slots, int H, int G, int N, int P) {
  __shared__ float4 part[kThreads];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int cols = P / 4;            // float4 columns of a state row
  const int c = t % cols;
  const int r0 = t / cols;
  const int R = kThreads / cols;     // rows a pass
  const int slot = slots[b];
  float* yrow = y + (static_cast<long long>(b) * H + h) * P;
  if (slot < 0 || slot >= n_slots) {
    for (int i = t; i < P; i += kThreads) yrow[i] = __int_as_float(0x7fc00000);
    return;
  }
  const repro::bf16* xr = x + b * x_ld + static_cast<long long>(h) * P;
  const int g = h / (H / G);
  const repro::bf16* br = Bm + b * bc_ld + static_cast<long long>(g) * N;
  const repro::bf16* cr = Cm + b * bc_ld + static_cast<long long>(g) * N;
  const float d = dt[b * H + h];
  const float a = expf(d * A[h]);
  float xv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xv[i] = __bfloat162float(xr[4 * c + i]);
  float4* s = reinterpret_cast<float4*>(
      state + (static_cast<long long>(slot) * H + h) * N * P);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = r0; n0 < N; n0 += R * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int n = n0 + k * R;
      if (n < N) v[k] = s[n * cols + c];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int n = n0 + k * R;
      if (n < N) {
        const float db = d * __bfloat162float(br[n]);
        const float cn = __bfloat162float(cr[n]);
        v[k].x = a * v[k].x + db * xv[0];
        v[k].y = a * v[k].y + db * xv[1];
        v[k].z = a * v[k].z + db * xv[2];
        v[k].w = a * v[k].w + db * xv[3];
        s[n * cols + c] = v[k];
        acc[0] += cn * v[k].x;
        acc[1] += cn * v[k].y;
        acc[2] += cn * v[k].z;
        acc[3] += cn * v[k].w;
      }
    }
  }
  part[t] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (t < cols) {
    float4 sum = part[t];
    for (int r = 1; r < R; ++r) {
      const float4 q = part[r * cols + t];
      sum.x += q.x; sum.y += q.y; sum.z += q.z; sum.w += q.w;
    }
    const float dh = Dv[h];
    yrow[4 * t + 0] = sum.x + dh * xv[0];
    yrow[4 * t + 1] = sum.y + dh * xv[1];
    yrow[4 * t + 2] = sum.z + dh * xv[2];
    yrow[4 * t + 3] = sum.w + dh * xv[3];
  }
}

}  // namespace

// state: (n_slots, H, N, P) fp32, in place; slots: (B,) int32; x: (B,
// H*P) bf16, row stride x_ld elements; Bm, Cm: (B, G*N) bf16, row stride
// bc_ld; dt: (B, H) fp32; A, D: (H,) fp32; y: (B, H, P) fp32.  P a
// multiple of 4 whose P/4 divides kThreads, H a multiple of G, state
// 16-byte aligned.
extern "C" int ssm_state_update_f32(void* state, const void* slots,
                                    const void* x, long long x_ld,
                                    const void* Bm, const void* Cm,
                                    long long bc_ld, const void* dt,
                                    const void* A, const void* Dv, void* y,
                                    int B, int n_slots, int H, int G, int N,
                                    int P, void* stream) {
  if (B <= 0 || n_slots <= 0 || H <= 0 || G <= 0 || N <= 0 || P <= 0 ||
      H % G || P % 4 || kThreads % (P / 4) || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ssm_state_update_kernel<<<dim3(H, B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(state), static_cast<const int*>(slots),
      static_cast<const repro::bf16*>(x), x_ld,
      static_cast<const repro::bf16*>(Bm),
      static_cast<const repro::bf16*>(Cm), bc_ld,
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Dv), static_cast<float*>(y), n_slots, H, G,
      N, P);
  return static_cast<int>(cudaGetLastError());
}
