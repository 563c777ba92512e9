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
// 4096) in bf16 it reads x, r, i (25 MB) and out and dh (34 MB, float32)
// and writes dx, dr, di (25 MB): 84 MB, 0.025 ms at 3.35 TB/s.  The
// forward's chunked two-pass design carries over reversed: L is cut into
// chunk lanes, so the threads in flight are B * W * lanes / (channels a
// thread), not B * W.
//   1. Each lane runs its chunk backwards from g = 0 past its end, keeping
//      the chunk's end value and the product of the a that carry a later g
//      into it.
//   2. The chunk maps are composed from the last chunk to the first, giving
//      each chunk the g that enters it.
//   3. Each lane replays its chunk from that g, writing dx, dr, di and
//      summing its dlam terms; the lanes' sums add in lane order per
//      channel (shared memory), the batch's in a second kernel, so there are
//      no atomics and the result repeats bit for bit.
// Two designs; the wrapper's plan (`rglru_bwd_path` in kernels/rglru.py)
// picks one from dtype, width and alignment, and `design` there names either:
// * bfloat16, W a multiple of 8, 16-byte aligned operands ("vec"):
//   `rglru_bwd_vec_kernel<G, KEEP>`, the forward's vectorised lanes: a
//   thread owns 8 channels (one 16-byte load of x, r, i; two of out and dh),
//   G thread columns side by side, 256 / G chunk lanes.  L <= 128 takes G = 8
//   (64 channels, 32 lanes of <= 4 steps), longer L G = 2 (16 channels, 128
//   lanes).  Where a lane's chunk is at most 4 steps its r and dh stay in
//   registers from pass 1 to pass 3 (KEEP = 4), so every input is read
//   once; longer chunks read r and dh again in pass 3 (at (1, 2048, 4096):
//   117 MB for a 100 MB bound).  A chunk's first decay a_t0 goes to shared
//   memory, so the lane before reads it there instead of reading r past its
//   end, and h_{t-1} is out[t - 1], read once.  The gates take the
//   forward's math: the sigmoid's division by __fdividef and the square
//   root as v rsqrt(v) (within ~2 ulp); the exps stay expf.
// * float32 (the card-vs-CPU cross-check), other widths, or `design`
//   "scalar": `rglru_bwd_kernel`, the first design: 8 channels a block, one
//   a thread, scalar loads, 32 chunk lanes, IEEE math.
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

// -8 softplus(lam), softplus as logaddexp(lam, 0)
__device__ __forceinline__ float neg_c_softplus(float lv) {
  return -8.f * (fmaxf(lv, 0.f) + log1pf(expf(-fabsf(lv))));
}

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
  const float ncs = neg_c_softplus(lv);

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

// ---------------------------------------------------------------------------
// bf16 on 16-byte chunk lanes
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kVec = 8;  // bf16 channels a thread: one 16-byte load

// __fdividef: within 2 ulp (0 for a denominator past 2^126, where the
// sigmoid is 0 anyway), as the forward's gates
__device__ __forceinline__ float fsigmoid(float x) { return __fdividef(1.f, 1.f + expf(-x)); }

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void ld8(const bf16* p, float (&v)[kVec]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void ld8(const float* p, float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void st8(bf16* p, const float (&v)[kVec]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void st8(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The carry over the chunks, from the last to the first: chunk l maps the g
// entering it past its end to g at its first step, G -> P_l G + E_l with P_l
// = prod'_l a_{t1(l)} (a_{t1} the next chunk's first decay, 0 past the last
// chunk).  Each chunk's entering g (written over s_val) is the composition
// of the later chunks' maps applied to g_L = 0.  One warp scans a channel as
// the forward does, over the chunks in reverse order.
template <int NL, int CW>
__device__ __forceinline__ void carry_scan_rev(float (*s_prod)[CW], float (*s_val)[CW],
                                               const float (*s_af)[CW]) {
  static_assert(NL % 32 == 0, "a warp scans a channel's chunks");
  constexpr int K = NL / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int c = warp; c < CW; c += kThreads / 32) {
    float Am = 1.f, Bm = 0.f;  // this lane's maps, composed (position m from the right)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = NL - 1 - (lane * K + k);
      const float pl = s_prod[l][c] * (l + 1 < NL ? s_af[l + 1][c] : 0.f);
      Bm = fmaf(pl, Bm, s_val[l][c]);
      Am *= pl;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // compose with the later chunks' lanes
      const float Ao = __shfl_up_sync(0xffffffffu, Am, o);
      const float Bo = __shfl_up_sync(0xffffffffu, Bm, o);
      if (lane >= o) {
        Bm = fmaf(Am, Bo, Bm);
        Am *= Ao;
      }
    }
    float Be = __shfl_up_sync(0xffffffffu, Bm, 1);
    if (lane == 0) Be = 0.f;
    float carry = Be;  // applied to g_L = 0
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = NL - 1 - (lane * K + k);
      const float pl = s_prod[l][c] * (l + 1 < NL ? s_af[l + 1][c] : 0.f);
      const float el = s_val[l][c];
      s_val[l][c] = carry;
      carry = fmaf(pl, carry, el);
    }
  }
}

// G thread columns of 8 channels each, kThreads / G chunk lanes of Tc steps;
// KEEP > 0: a lane's chunk is at most KEEP steps and its r and dh stay in
// registers from pass 1 to pass 3; KEEP = 0: pass 3 reads them again.  Two
// blocks an SM (<= 128 registers a thread).
template <int G, int KEEP>
__global__ void __launch_bounds__(kThreads, 2)
rglru_bwd_vec_kernel(const bf16* __restrict__ x, const bf16* __restrict__ r,
                     const bf16* __restrict__ gi, const float* __restrict__ lam,
                     const void* __restrict__ h0, int h0_bf16, const float* __restrict__ out,
                     const float* __restrict__ dh, const float* __restrict__ dhT,
                     bf16* __restrict__ dx, bf16* __restrict__ dr, bf16* __restrict__ di,
                     float* __restrict__ dh0, float* __restrict__ dlam_part, int L, int W,
                     int Tc) {
  constexpr int NL = kThreads / G;  // chunk lanes
  constexpr int CW = G * kVec;      // channels per block
  constexpr int NK = KEEP > 0 ? KEEP : 1;
  __shared__ float s_prod[NL][CW];  // the chunk's product of a past its first step
  __shared__ float s_val[NL][CW];   // its g at t0 from g = 0, then the g entering it
  __shared__ float s_af[NL][CW];    // a at its first step (0 for an empty chunk)
  __shared__ float s_lam[NL][CW];   // its dlam terms

  const int col = threadIdx.x % G;
  const int lane = threadIdx.x / G;
  const int c0 = col * kVec;
  const int w0 = blockIdx.x * CW + c0;
  const long long b = blockIdx.y;
  const int t0 = min(L, lane * Tc);
  const int t1 = min(L, t0 + Tc);
  const bool on = w0 < W;  // W is a multiple of 8
  const long long base = b * L * W + w0;

  float ncs[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) ncs[k] = on ? neg_c_softplus(lam[w0 + k]) : 0.f;
  // dh_t, with dh_T added at the last step
  auto grad = [&](int t, float (&v)[kVec]) {
    ld8(dh + base + static_cast<long long>(t) * W, v);
    if (dhT != nullptr && t == L - 1) {
      float e[kVec];
      ld8(dhT + b * W + w0, e);
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] += e[k];
    }
  };

  // h_{t-1}: out[t - 1], or h0 at t = 0
  auto h_prev = [&](int t, long long off, float (&v)[kVec]) {
    if (t > 0) {
      ld8(out + off - W, v);
    } else if (h0_bf16) {
      ld8(static_cast<const bf16*>(h0) + b * W + w0, v);
    } else {
      ld8(static_cast<const float*>(h0) + b * W + w0, v);
    }
  };

  // 1. the chunk from g = 0 past its end
  uint4 rk[NK];
  float dk[NK][kVec];
  float g[kVec], prod[kVec], an[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    g[k] = 0.f;
    prod[k] = 1.f;
    an[k] = 0.f;
  }
  auto step1 = [&](int t, const uint4& ru, const float (&du)[kVec]) {
    float rv[kVec];
    unpack8(ru, rv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float a = expf(ncs[k] * fsigmoid(rv[k]));
      g[k] = fmaf(an[k], g[k], du[k]);
      if (t > t0) prod[k] *= a;
      an[k] = a;
    }
  };
  if (on && t0 < t1) {
    if constexpr (KEEP > 0) {
#pragma unroll
      for (int j = 0; j < KEEP; ++j) {
        if (t0 + j < t1) {
          rk[j] = *reinterpret_cast<const uint4*>(r + base + static_cast<long long>(t0 + j) * W);
          grad(t0 + j, dk[j]);
        }
      }
#pragma unroll
      for (int j = KEEP - 1; j >= 0; --j)
        if (t0 + j < t1) step1(t0 + j, rk[j], dk[j]);
    } else {
      for (int t = t1 - 1; t >= t0; t -= 2) {
        uint4 ru[2];
        float du[2][kVec];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (t - u >= t0) {
            ru[u] = *reinterpret_cast<const uint4*>(r + base + static_cast<long long>(t - u) * W);
            grad(t - u, du[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (t - u >= t0) step1(t - u, ru[u], du[u]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    s_prod[lane][c0 + k] = prod[k];
    s_val[lane][c0 + k] = g[k];
    s_af[lane][c0 + k] = (on && t0 < t1) ? an[k] : 0.f;
  }
  __syncthreads();
  // 2. the g entering each chunk
  carry_scan_rev<NL, CW>(s_prod, s_val, s_af);
  __syncthreads();

  // 3. replay from the true g, forming the gradients
  float lam_acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) lam_acc[k] = 0.f;
  if (on && t0 < t1) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      g[k] = s_val[lane][c0 + k];
      an[k] = lane + 1 < NL ? s_af[lane + 1][c0 + k] : 0.f;
    }
    auto step3 = [&](int t, const uint4& ru, const float (&du)[kVec]) {
      const long long off = base + static_cast<long long>(t) * W;
      float rv[kVec], xv[kVec], iv[kVec], hp[kVec];
      unpack8(ru, rv);
      ld8(x + off, xv);
      ld8(gi + off, iv);
      h_prev(t, off, hp);
      float ox[kVec], orr[kVec], oi[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        g[k] = fmaf(an[k], g[k], du[k]);
        const float sr = fsigmoid(rv[k]);
        const float si = fsigmoid(iv[k]);
        const float log_a = ncs[k] * sr;
        const float a = expf(log_a);
        const float e2 = expf(2.f * log_a);
        const float z = 1.f - e2;
        const float v = fmaxf(z, 1e-12f);
        const float rb = rsqrtf(v);
        const float beta = v * rb;  // sqrt(v) within ~2 ulp
        float dlog_a = g[k] * hp[k] * a;
        if (z > 1e-12f) dlog_a -= g[k] * si * xv[k] * e2 * rb;
        ox[k] = g[k] * beta * si;
        oi[k] = g[k] * beta * xv[k] * si * (1.f - si);
        orr[k] = dlog_a * ncs[k] * sr * (1.f - sr);
        lam_acc[k] = fmaf(dlog_a, sr, lam_acc[k]);
        hp[k] = a * g[k];  // dh0 at t = 0
        an[k] = a;
      }
      st8(dx + off, ox);
      st8(dr + off, orr);
      st8(di + off, oi);
      if (t == 0) st8(dh0 + b * W + w0, hp);
    };
    if constexpr (KEEP > 0) {
#pragma unroll
      for (int j = KEEP - 1; j >= 0; --j)
        if (t0 + j < t1) step3(t0 + j, rk[j], dk[j]);
    } else {
      for (int t = t1 - 1; t >= t0; --t) {
        const uint4 ru = *reinterpret_cast<const uint4*>(r + base + static_cast<long long>(t) * W);
        float du[kVec];
        grad(t, du);
        step3(t, ru, du);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) s_lam[lane][c0 + k] = lam_acc[k];
  __syncthreads();
  // the lanes' dlam terms in lane order, per channel
  for (int c = threadIdx.x; c < CW; c += kThreads) {
    const int w = blockIdx.x * CW + c;
    if (w >= W) continue;
    float s = 0.f;
    for (int l = 0; l < NL; ++l) s += s_lam[l][c];
    dlam_part[b * W + w] = s;
  }
}

template <typename T>
int launch_scalar(const void* x, const void* r, const void* i, const float* lam, const void* h0,
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

template <int G, int KEEP>
int launch_vec_kernel(const void* x, const void* r, const void* i, const float* lam,
                      const void* h0, int h0_bf16, const float* out, const float* dh,
                      const float* dhT, void* dx, void* dr, void* di, float* dh0,
                      float* dlam_part, int B, int L, int W, cudaStream_t s) {
  constexpr int NL = kThreads / G;
  constexpr int CW = G * kVec;
  const int Tc = (L + NL - 1) / NL;
  const dim3 grid((W + CW - 1) / CW, B);
  rglru_bwd_vec_kernel<G, KEEP><<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(r), static_cast<const bf16*>(i),
      lam, h0, h0_bf16, out, dh, dhT, static_cast<bf16*>(dx), static_cast<bf16*>(dr),
      static_cast<bf16*>(di), dh0, dlam_part, L, W, Tc);
  return static_cast<int>(cudaGetLastError());
}

int launch_vec(const void* x, const void* r, const void* i, const float* lam, const void* h0,
               int h0_bf16, const float* out, const float* dh, const float* dhT, void* dx,
               void* dr, void* di, float* dh0, float* dlam_part, float* dlam, int B, int L,
               int W, cudaStream_t s) {
  int err;
  if (L <= 32 * 4) {
    err = launch_vec_kernel<8, 4>(x, r, i, lam, h0, h0_bf16, out, dh, dhT, dx, dr, di, dh0,
                                  dlam_part, B, L, W, s);
  } else if (L <= 128 * 4) {
    err = launch_vec_kernel<2, 4>(x, r, i, lam, h0, h0_bf16, out, dh, dhT, dx, dr, di, dh0,
                                  dlam_part, B, L, W, s);
  } else {
    err = launch_vec_kernel<2, 0>(x, r, i, lam, h0, h0_bf16, out, dh, dhT, dx, dr, di, dh0,
                                  dlam_part, B, L, W, s);
  }
  if (err != 0) return err;
  const dim3 g2((W + kThreads - 1) / kThreads);
  rglru_bwd_lam_kernel<<<g2, kThreads, 0, s>>>(dlam_part, lam, dlam, B, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, i: (B, L, W) contiguous, dtype 0 = float32, 1 = bfloat16; lam (W,)
// float32; h0 (B, W) float32 (h0_dtype 0) or bfloat16 (1); out, dh (B, L, W)
// float32; dhT (B, W) float32 or null; dx, dr, di (B, L, W) in x's dtype;
// dh0 (B, W) float32; dlam_part (B, W) float32 scratch; dlam (W,) float32.
// path 0 = the first design ("scalar"), 1 = the vectorised lanes ("vec":
// bfloat16, W a multiple of 8, every operand 16-byte aligned).  Returns
// cudaGetLastError() after the launches.
extern "C" int rglru_scan_bwd(const void* x, const void* r, const void* i, const void* lam,
                              const void* h0, int h0_dtype, const void* out, const void* dh,
                              const void* dhT, void* dx, void* dr, void* di, void* dh0,
                              void* dlam_part, void* dlam, int B, int L, int W, int dtype,
                              int path, void* stream) {
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
  if (path == 1) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                           reinterpret_cast<uintptr_t>(i) | reinterpret_cast<uintptr_t>(h0) |
                           reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(dh) |
                           reinterpret_cast<uintptr_t>(dhT) | reinterpret_cast<uintptr_t>(dx) |
                           reinterpret_cast<uintptr_t>(dr) | reinterpret_cast<uintptr_t>(di) |
                           reinterpret_cast<uintptr_t>(dh0);
    if (dtype != 1 || W % kVec != 0 || addr % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_vec(x, r, i, lf, h0, h0_dtype, of, df, tf, dx, dr, di, h0f, pf, lamf, B, L, W,
                      s);
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_scalar<float>(x, r, i, lf, h0, h0_dtype, of, df, tf, dx, dr, di, h0f, pf,
                                lamf, B, L, W, s);
  if (dtype == 1)
    return launch_scalar<__nv_bfloat16>(x, r, i, lf, h0, h0_dtype, of, df, tf, dx, dr, di, h0f,
                                        pf, lamf, B, L, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
