// Fused RG-LRU scan (gates + sequential recurrence) for Hopper (sm_90a).
//
// Replaces the TPU kernel `rglru_scan` in src/repro/kernels/rglru.py
// (`_kernel`, called through `pl.pallas_call`).  For every (batch, channel w)
// and t = 0 .. L-1, in float32:
//
//   log_a = -8 softplus(lam[w]) sigmoid(r[t])
//   a     = exp(log_a),   beta = sqrt(max(1 - exp(2 log_a), 1e-12))
//   h     = a h + beta sigmoid(i[t]) x[t],   h starting at h0;  out[t] = h
//
// r and i are the gates' pre-activations: the sigmoids are applied here, so
// the gate tensors never round-trip to memory between the elementwise
// stages.  Inputs x / r / i in float32 or bfloat16, lam and h0 float32;
// outputs h (B, L, W) and h_T (B, W) float32.
//
// Design: one thread per (batch, channel) carries h in a register and walks
// L; a warp's 32 neighbouring channels make each load and store coalesced.
// The loop loads the gates of 8 steps ahead of the dependent recurrence, so
// 8 steps' loads are in flight at once.  Blocks of 64 threads spread the
// channels over the SMs (64 blocks at W = 4096, B = 1).
//
// Bound on this card: bytes.  At recurrentgemma-9b's prefill shape (1, 2048,
// 4096) in bfloat16 it reads 50 MB and writes 34 MB: 0.025 ms at 3.35 TB/s.
// One thread per channel leaves only W * B threads (4096) with ~200 KB of
// loads in flight, far below what the memory system needs to reach its rate,
// so this simple form is latency-bound at long L; a chunked two-pass scan
// over L (partial products, then a carry pass) is the later step.  The
// decode step (L = 1) is bound by launch latency.
//
// Nothing is allocated here and nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kAhead = 8;  // steps whose loads are issued together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const T* __restrict__ gi, const float* __restrict__ lam,
                  const float* __restrict__ h0, float* __restrict__ out,
                  float* __restrict__ hT, int L, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long b = blockIdx.y;
  const float lv = lam[w];
  // softplus as logaddexp(lam, 0)
  const float neg_c_sp = -8.f * (fmaxf(lv, 0.f) + log1pf(expf(-fabsf(lv))));
  float h = h0[b * W + w];
  const long long base = b * L * W + w;
  for (int t0 = 0; t0 < L; t0 += kAhead) {
    float xv[kAhead], rv[kAhead], iv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < L) {
        const long long off = base + static_cast<long long>(t0 + u) * W;
        xv[u] = to_f(x[off]);
        rv[u] = to_f(r[off]);
        iv[u] = to_f(gi[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < L) {
        const float log_a = neg_c_sp * sigmoid(rv[u]);
        const float a = expf(log_a);
        const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
        h = a * h + beta * sigmoid(iv[u]) * xv[u];
        out[base + static_cast<long long>(t0 + u) * W] = h;
      }
    }
  }
  hT[b * W + w] = h;
}

template <typename T>
int launch(const void* x, const void* r, const void* i, const float* lam,
           const float* h0, float* out, float* hT, int B, int L, int W,
           cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(i),
      lam, h0, out, hT, L, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, i: (B, L, W) contiguous, dtype 0 = float32, 1 = bfloat16; lam (W,)
// and h0 (B, W) float32; out (B, L, W) and hT (B, W) float32.  Returns
// cudaGetLastError() after the launch.
extern "C" int rglru_scan(const void* x, const void* r, const void* i,
                          const void* lam, const void* h0, void* out, void* hT,
                          int B, int L, int W, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lam);
  const float* hf = static_cast<const float*>(h0);
  float* of = static_cast<float*>(out);
  float* tf = static_cast<float*>(hT);
  if (dtype == 0) return launch<float>(x, r, i, lf, hf, of, tf, B, L, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, r, i, lf, hf, of, tf, B, L, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
