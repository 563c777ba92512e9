// Backward of the fused RG-LRU scan (csrc/rglru_scan.cu) for Hopper (sm_90a).
//
// Replaces the gradient that the reference takes by differentiating its
// recurrence (the `associative_scan` in src/repro/models/rglru.py, which
// computes what the TPU kernel `rglru_scan` in src/repro/kernels/rglru.py
// computes; the Pallas kernel itself has no VJP).  Per (batch, channel w),
// with dh_t the gradient of out[t] (and dh_T of h_T added at t = L - 1):
//
//   g_t   = dh_t + a_{t+1} g_{t+1}                       (a reverse scan)
//   da_t  = g_t h_{t-1}   (h_{t-1} from the saved output, h0 at t = 0)
//   dx_t  = g_t beta_t s_i,   di_t = g_t beta_t x_t s_i (1 - s_i)
//   dlog_a = da_t a_t - g_t s_i x_t exp(2 log_a) / beta_t   (0 where the
//            1e-12 clamp of 1 - a^2 holds)
//   dr_t  = dlog_a (-8 softplus(lam)) s_r (1 - s_r)
//   dlam  = sum over batch and t of dlog_a (-8 s_r) sigmoid(lam)
//   dh0   = a_0 g_0
//
// with s_r = sigmoid(r_t), s_i = sigmoid(i_t), a_t = exp(log_a),
// log_a = -8 softplus(lam) s_r, beta_t = sqrt(max(1 - a_t^2, 1e-12)), all in
// float32 and with IEEE math.  Inputs x / r / i float32 or bfloat16, lam
// float32, h0 float32 or bfloat16, out and dh (B, L, W) float32, dh_T
// (B, W) float32 or null; outputs dx / dr / di in x's dtype, dh0 (B, W)
// float32, and the per-batch partial of dlam (B, W) float32 that a second
// kernel sums over the batch in order.
//
// Bound on this card: bytes.  At recurrentgemma-9b's train shape (8, 128,
// 4096) in bf16 it reads x, r, i, out and dh (67 MB) and writes dx, dr, di
// (25 MB): 0.027 ms at 3.35 TB/s.  The forward's chunked two-pass design
// carries over reversed (`rglru_bwd_kernel`): a block owns 8 channels over
// the whole of L as 32 chunk lanes of Tc = ceil(L / 32) steps, so the
// threads in flight are B * W * 32 / 8 (131 072 at the train shape), not
// B * W.
//   1. Each lane runs its chunk backwards from g = 0 past its end, keeping
//      the chunk's end value and the product of the a that carry a later g
//      into it (a_{t1} of the next chunk's first step included).
//   2. One thread per channel composes the chunk maps from the last chunk
//      to the first, giving each chunk the g that enters it.
//   3. Each lane replays its chunk from that g, writing dx, dr, di and
//      summing its dlam terms; the lanes' sums add in lane order per
//      channel (shared memory), the batch's in a second kernel, so there are
//      no atomics and the result repeats bit for bit.
// Simple and right first: one channel a thread, scalar loads (ROADMAP
// queue B).
//
// Nothing is allocated here and nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;                    // channels per block
constexpr int kLanes = kThreads / kCols;    // chunk lanes per channel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float load_h0(const void* h0, int h0_bf16, long long i) {
  return h0_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(h0)[i])
                 : static_cast<const float*>(h0)[i];
}

// a_t from r_t: exp(ncs sigmoid(r_t)), ncs = -8 softplus(lam)
__device__ __forceinline__ float decay(float ncs, float rv) { return expf(ncs * sigmoid(rv)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ gi,
                 const float* __restrict__ lam, const void* __restrict__ h0, int h0_bf16,
                 const float* __restrict__ out, const float* __restrict__ dh,
                 const float* __restrict__ dhT, T* __restrict__ dx, T* __restrict__ dr,
                 T* __restrict__ di, float* __restrict__ dh0, float* __restrict__ dlam_part,
                 int L, int W, int Tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_prod = reinterpret_cast<float*>(smem_raw);   // [kLanes][kCols]
  float* s_val = s_prod + kLanes * kCols;               // [kLanes][kCols]
  float* s_lam = s_val + kLanes * kCols;                // [kLanes][kCols]

  const int col = threadIdx.x % kCols;
  const int lane = threadIdx.x / kCols;
  const int w = blockIdx.x * kCols + col;
  const long long b = blockIdx.y;
  const bool on = w < W;
  const int t0 = min(L, lane * Tc);
  const int t1 = min(L, t0 + Tc);
  const long long base = b * L * W + w;
  const float lv = on ? lam[w] : 0.f;
  const float ncs = -8.f * (fmaxf(lv, 0.f) + log1pf(expf(-fabsf(lv))));

  // dh_t, with dh_T added at the last step
  auto grad_out = [&](int t) {
    float v = dh[base + static_cast<long long>(t) * W];
    if (dhT != nullptr && t == L - 1) v += dhT[b * W + w];
    return v;
  };

  // 1. the chunk from g = 0 past its end: g_t0 = end + prod * g_{t1}
  float g = 0.f, prod = 1.f;
  if (on && t0 < t1) {
    float a_next = t1 < L ? decay(ncs, to_f(r[base + static_cast<long long>(t1) * W])) : 0.f;
    for (int t = t1 - 1; t >= t0; --t) {
      g = fmaf(a_next, g, grad_out(t));
      prod *= a_next;
      a_next = decay(ncs, to_f(r[base + static_cast<long long>(t) * W]));
    }
  }
  s_prod[lane * kCols + col] = prod;
  s_val[lane * kCols + col] = g;
  __syncthreads();

  // 2. per channel, from the last chunk to the first: the g entering each
  // chunk past its end (written over s_val)
  if (threadIdx.x < kCols) {
    float carry = 0.f;
    for (int l = kLanes - 1; l >= 0; --l) {
      const float p = s_prod[l * kCols + threadIdx.x];
      const float e = s_val[l * kCols + threadIdx.x];
      s_val[l * kCols + threadIdx.x] = carry;
      carry = fmaf(p, carry, e);
    }
  }
  __syncthreads();

  // 3. replay from the true g, forming the gradients
  float lam_sum = 0.f;
  if (on && t0 < t1) {
    g = s_val[lane * kCols + col];
    float a_next = t1 < L ? decay(ncs, to_f(r[base + static_cast<long long>(t1) * W])) : 0.f;
    for (int t = t1 - 1; t >= t0; --t) {
      const long long off = base + static_cast<long long>(t) * W;
      g = fmaf(a_next, g, grad_out(t));
      const float xv = to_f(x[off]);
      const float sr = sigmoid(to_f(r[off]));
      const float si = sigmoid(to_f(gi[off]));
      const float log_a = ncs * sr;
      const float a = expf(log_a);
      const float e2 = expf(2.f * log_a);
      const float z = 1.f - e2;
      const float beta = sqrtf(fmaxf(z, 1e-12f));
      const float h_prev = t > 0 ? out[off - W] : load_h0(h0, h0_bf16, b * W + w);
      float dlog_a = g * h_prev * a;
      if (z > 1e-12f) dlog_a -= g * si * xv * e2 / beta;
      dx[off] = from_f<T>(g * beta * si);
      di[off] = from_f<T>(g * beta * xv * si * (1.f - si));
      dr[off] = from_f<T>(dlog_a * ncs * sr * (1.f - sr));
      lam_sum = fmaf(dlog_a, sr, lam_sum);
      if (t == 0) dh0[b * W + w] = a * g;
      a_next = a;
    }
  }
  s_lam[lane * kCols + col] = lam_sum;
  __syncthreads();
  if (threadIdx.x < kCols && blockIdx.x * kCols + threadIdx.x < W) {
    float s = 0.f;
    for (int l = 0; l < kLanes; ++l) s += s_lam[l * kCols + threadIdx.x];
    dlam_part[b * W + blockIdx.x * kCols + threadIdx.x] = s;
  }
}

// dlam[w] = -8 sigmoid(lam[w]) * sum over b, in order, of dlam_part[b][w]
__global__ void __launch_bounds__(kThreads)
rglru_bwd_lam_kernel(const float* __restrict__ dlam_part, const float* __restrict__ lam,
                     float* __restrict__ dlam, int B, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += dlam_part[static_cast<long long>(b) * W + w];
  dlam[w] = s * (-8.f * sigmoid(lam[w]));
}

template <typename T>
int launch(const void* x, const void* r, const void* i, const float* lam, const void* h0,
           int h0_bf16, const float* out, const float* dh, const float* dhT, void* dx,
           void* dr, void* di, float* dh0, float* dlam_part, float* dlam, int B, int L, int W,
           cudaStream_t s) {
  const int Tc = (L + kLanes - 1) / kLanes;
  const dim3 grid((W + kCols - 1) / kCols, B);
  const size_t smem = sizeof(float) * 3 * kLanes * kCols;
  rglru_bwd_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(i), lam, h0,
      h0_bf16, out, dh, dhT, static_cast<T*>(dx), static_cast<T*>(dr), static_cast<T*>(di),
      dh0, dlam_part, L, W, Tc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2((W + kThreads - 1) / kThreads);
  rglru_bwd_lam_kernel<<<g2, kThreads, 0, s>>>(dlam_part, lam, dlam, B, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, i: (B, L, W) contiguous, dtype 0 = float32, 1 = bfloat16; lam (W,)
// float32; h0 (B, W) float32 (h0_dtype 0) or bfloat16 (1); out, dh (B, L, W)
// float32; dhT (B, W) float32 or null; dx, dr, di (B, L, W) in x's dtype;
// dh0 (B, W) float32; dlam_part (B, W) float32 scratch; dlam (W,) float32.
// Returns cudaGetLastError() after the launches.
extern "C" int rglru_scan_bwd(const void* x, const void* r, const void* i, const void* lam,
                              const void* h0, int h0_dtype, const void* out, const void* dh,
                              const void* dhT, void* dx, void* dr, void* di, void* dh0,
                              void* dlam_part, void* dlam, int B, int L, int W, int dtype,
                              void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || W <= 0 || (h0_dtype != 0 && h0_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lam);
  const float* of = static_cast<const float*>(out);
  const float* df = static_cast<const float*>(dh);
  const float* tf = static_cast<const float*>(dhT);
  float* h0f = static_cast<float*>(dh0);
  float* pf = static_cast<float*>(dlam_part);
  float* lamf = static_cast<float*>(dlam);
  if (dtype == 0)
    return launch<float>(x, r, i, lf, h0, h0_dtype, of, df, tf, dx, dr, di, h0f, pf, lamf, B,
                         L, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, r, i, lf, h0, h0_dtype, of, df, tf, dx, dr, di, h0f, pf,
                                 lamf, B, L, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
