// Fused RG-LRU scan (gates + linear recurrence) for Hopper (sm_90a).
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
// stages.  Inputs x / r / i in float32 or bfloat16, lam float32, h0 float32
// or bfloat16; outputs h (B, L, W) and h_T (B, W) float32 (h_T may be
// omitted: the caller then reads out[:, L - 1]).
//
// Bound on this card: bytes.  At recurrentgemma-9b's prefill shape (1, 2048,
// 4096) in bfloat16 it reads 50 MB and writes 34 MB: 0.025 ms at 3.35 TB/s.
// Walking L with one thread per channel leaves B * W threads (4096 there),
// each waiting a memory latency per few steps: that form ran 39x its bound.
//
// Design: the recurrence h_t = a_t h_{t-1} + b_t is linear, so L is cut
// into chunks and scanned in two passes inside one launch
// (`rglru_chunked_kernel`).  A block of 256 threads owns 16 bf16 (8 float32)
// channels over the whole of L: 2 threads side by side, each on 16 bytes
// of neighbouring channels, times 128 chunk lanes of T = ceil(L / 128)
// steps (T = 16 at L = 2048), so the threads in flight grow from B * W to
// B * W * L / T (256 blocks of 256 at recurrentgemma's prefill, two an SM).
//   1. Each lane forms a_t and b_t of its chunk and runs them from h = 0,
//      keeping the chunk's product of a and its end value (shared memory).
//   2. The chunk summaries are scanned per channel (a warp per channel:
//      lanes compose consecutive chunks' affine maps, then a shuffle scan),
//      giving each chunk its start from h0.
//   3. Each lane replays its chunk from its true start, writing out (and
//      h_T at the last step).  It re-reads its inputs, which pass 1 read
//      moments before (the block's tile, 196 KB at L = 2048), and forms
//      a_t, b_t again bit for bit as pass 1 did.
// Only the carry is reassociated: prod a <= 1, so no rounding is amplified.
// The gates cost ~100 float32 instructions an element with IEEE division
// and square root, as much time as the bytes at this shape; the sigmoid's
// division (__fdividef) and the square root (v rsqrt(v)) are taken within
// ~2 ulp instead (the exps stay expf).  Two columns, 2-step load batches
// and <= 128 registers put two blocks on an SM.  scripts/ssm_variants.py
// times this form against those choices undone (NVIDIA H100 80GB HBM3,
// 700 W, (1, 2048, 4096) bf16: 0.080 ms against 0.170 for IEEE math, 4
// columns x 64 lanes, 4-step batches and one block an SM; 0.071 with the
// gates' math removed).  Holding a chunk's a_t, b_t in registers from pass
// 1 to pass 3 (256 lanes of <= 8 steps) needs ~200 registers, one block an
// SM, and measured slower than re-reading.
// A width that is not a multiple of 16 bytes (or unaligned operands) takes
// the same design with one channel per thread: 8 channels x 32 lanes.
//
// Short L (the decode step, L = 1, and the serve prefill, L = 16: L <= 32)
// takes `rglru_seq_kernel`: one thread per (batch, channel) carries h in a
// register and walks L, loading the gates of 8 steps ahead; a warp's 32
// neighbouring channels make each load coalesced.  There a launch costs
// more than the loads, and the chunked form would add two barriers.
//
// Nothing is allocated here and nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // chunked kernel
constexpr int kSeqThreads = 64;   // sequential kernel
constexpr int kAhead = 8;         // sequential kernel: steps whose loads are issued together
constexpr int kBatch = 2;         // chunked kernel: the same
constexpr int kShortL = 32;       // L <= kShortL: the sequential kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// __fdividef: within 2 ulp (0 for a denominator past 2^126, where the
// sigmoid is 0 anyway); an IEEE division costs ~3x its instructions
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + expf(-x)); }

// -8 softplus(lam), softplus as logaddexp(lam, 0)
__device__ __forceinline__ float neg_c_softplus(float lv) {
  return -8.f * (fmaxf(lv, 0.f) + log1pf(expf(-fabsf(lv))));
}

__device__ __forceinline__ float load_h0(const void* h0, int h0_bf16, long long i) {
  return h0_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(h0)[i])
                 : static_cast<const float*>(h0)[i];
}

// a_t and b_t = beta_t sigmoid(i_t) x_t of one element
__device__ __forceinline__ void gates(float ncs, float xv, float rv, float iv, float& a,
                                      float& b) {
  const float log_a = ncs * sigmoid(rv);
  a = expf(log_a);
  const float v = fmaxf(1.f - expf(2.f * log_a), 1e-12f);
  const float beta = v * rsqrtf(v);  // sqrt(v) within ~2 ulp
  b = beta * sigmoid(iv) * xv;
}

// V consecutive elements: one 16-byte load (V = 16 / sizeof(T)) or one
// scalar (V = 1)
template <typename T, int V>
struct Vec {
  float v[V];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V == 1) {
      v[0] = to_f(*p);
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
          const float2 f = __bfloat1622float2(h[k]);
          v[2 * k] = f.x;
          v[2 * k + 1] = f.y;
        }
      } else {
        v[0] = __uint_as_float(u.x);
        v[1] = __uint_as_float(u.y);
        v[2] = __uint_as_float(u.z);
        v[3] = __uint_as_float(u.w);
      }
    }
  }
};

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&h)[V]) {
  if constexpr (V == 1) {
    *p = h[0];
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      *reinterpret_cast<float4*>(p + k) = make_float4(h[k], h[k + 1], h[k + 2], h[k + 3]);
    }
  }
}

// One chunk lane's steps [t0, t1) of V channels: pass 1 (REPLAY false)
// runs them from h = 0 and multiplies up a; pass 3 (REPLAY true) runs them
// from h and writes out.  Loads are issued kBatch steps at a time.
template <bool REPLAY, typename T, int V>
__device__ __forceinline__ void walk(const T* __restrict__ x, const T* __restrict__ r,
                                     const T* __restrict__ gi, float* __restrict__ out,
                                     long long base, int t0, int t1, int W,
                                     const float (&ncs)[V], float (&h)[V], float (&p)[V]) {
  for (int t = t0; t < t1; t += kBatch) {
    Vec<T, V> xv[kBatch], rv[kBatch], iv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (t + u < t1) {
        const long long off = base + static_cast<long long>(t + u) * W;
        xv[u].load(x + off);
        rv[u].load(r + off);
        iv[u].load(gi + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (t + u < t1) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float a, b;
          gates(ncs[k], xv[u].v[k], rv[u].v[k], iv[u].v[k], a, b);
          h[k] = fmaf(a, h[k], b);
          if (!REPLAY) p[k] *= a;
        }
        if (REPLAY) store_vec<V>(out + base + static_cast<long long>(t + u) * W, h);
      }
    }
  }
}

// The carry over the chunks: chunk l maps its start h to prod_l h + end_l;
// each chunk's start (written over s_val) is the composition of the maps
// before it applied to h0.  One warp scans a channel: a lane composes
// NL / 32 consecutive maps, a shuffle scan composes the lanes' maps, and the
// lane applies its prefix to h0 and walks its chunks.
template <int NL, int CW>
__device__ __forceinline__ void carry_scan(float (*s_prod)[CW], float (*s_val)[CW],
                                           const void* h0, int h0_bf16, long long b, int W,
                                           int w_base) {
  static_assert(NL % 32 == 0, "a warp scans a channel's chunks");
  constexpr int K = NL / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int c = warp; c < CW; c += kThreads / 32) {
    const int w = w_base + c;
    const float h_in = w < W ? load_h0(h0, h0_bf16, b * W + w) : 0.f;
    float A = 1.f, B = 0.f;  // this lane's maps, composed
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float pl = s_prod[lane * K + k][c];
      B = fmaf(pl, B, s_val[lane * K + k][c]);
      A *= pl;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // compose with the earlier lanes' maps
      const float Ao = __shfl_up_sync(0xffffffffu, A, o);
      const float Bo = __shfl_up_sync(0xffffffffu, B, o);
      if (lane >= o) {
        B = fmaf(A, Bo, B);
        A *= Ao;
      }
    }
    float Ae = __shfl_up_sync(0xffffffffu, A, 1);
    float Be = __shfl_up_sync(0xffffffffu, B, 1);
    if (lane == 0) {
      Ae = 1.f;
      Be = 0.f;
    }
    float carry = fmaf(Ae, h_in, Be);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = lane * K + k;
      const float pl = s_prod[l][c];
      const float el = s_val[l][c];
      s_val[l][c] = carry;
      carry = fmaf(pl, carry, el);
    }
  }
}

// G thread columns of V channels each, kThreads / G chunk lanes of Tc steps;
// two blocks an SM (<= 128 registers a thread).
template <typename T, int V, int G>
__global__ void __launch_bounds__(kThreads, 2)
rglru_chunked_kernel(const T* __restrict__ x, const T* __restrict__ r,
                     const T* __restrict__ gi, const float* __restrict__ lam,
                     const void* __restrict__ h0, int h0_bf16, float* __restrict__ out,
                     float* __restrict__ hT, int L, int W, int Tc) {
  constexpr int NL = kThreads / G;  // chunk lanes
  constexpr int CW = G * V;         // channels per block
  __shared__ float s_prod[NL][CW];  // the chunk's product of a
  __shared__ float s_val[NL][CW];   // its end value from h = 0, then its start value

  const int col = threadIdx.x % G;
  const int lane = threadIdx.x / G;
  const int c0 = col * V;
  const int w0 = blockIdx.x * CW + c0;
  const long long b = blockIdx.y;
  const int t0 = min(L, lane * Tc);
  const int t1 = min(L, t0 + Tc);
  const bool on = w0 < W;  // V > 1 only when V divides W
  const long long base = b * L * W + w0;

  float ncs[V], h[V], p[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ncs[k] = on ? neg_c_softplus(lam[w0 + k]) : 0.f;
    h[k] = 0.f;
    p[k] = 1.f;
  }
  if (on) walk<false, T, V>(x, r, gi, out, base, t0, t1, W, ncs, h, p);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s_prod[lane][c0 + k] = p[k];
    s_val[lane][c0 + k] = h[k];
  }
  __syncthreads();
  carry_scan<NL, CW>(s_prod, s_val, h0, h0_bf16, b, W, blockIdx.x * CW);
  __syncthreads();

  if (!on || t0 >= t1) return;
#pragma unroll
  for (int k = 0; k < V; ++k) h[k] = s_val[lane][c0 + k];
  walk<true, T, V>(x, r, gi, out, base, t0, t1, W, ncs, h, p);
  if (hT != nullptr && t1 == L) {
#pragma unroll
    for (int k = 0; k < V; ++k) hT[b * W + w0 + k] = h[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
rglru_seq_kernel(const T* __restrict__ x, const T* __restrict__ r,
                 const T* __restrict__ gi, const float* __restrict__ lam,
                 const void* __restrict__ h0, int h0_bf16, float* __restrict__ out,
                 float* __restrict__ hT, int L, int W) {
  const int w = blockIdx.x * kSeqThreads + threadIdx.x;
  if (w >= W) return;
  const long long b = blockIdx.y;
  const float ncs = neg_c_softplus(lam[w]);
  float h = load_h0(h0, h0_bf16, b * W + w);
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
        float a, bb;
        gates(ncs, xv[u], rv[u], iv[u], a, bb);
        h = fmaf(a, h, bb);
        out[base + static_cast<long long>(t0 + u) * W] = h;
      }
    }
  }
  if (hT != nullptr) hT[b * W + w] = h;
}

template <typename T>
int launch(const void* x, const void* r, const void* i, const float* lam, const void* h0,
           int h0_bf16, float* out, float* hT, int B, int L, int W, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* it = static_cast<const T*>(i);
  if (L <= kShortL) {
    const dim3 grid((W + kSeqThreads - 1) / kSeqThreads, B);
    rglru_seq_kernel<T><<<grid, kSeqThreads, 0, stream>>>(xt, rt, it, lam, h0, h0_bf16, out,
                                                           hT, L, W);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(i) | reinterpret_cast<uintptr_t>(out);
  if (W % kVec == 0 && addr % 16 == 0) {
    constexpr int G = 2, NL = kThreads / G;
    const int Tc = (L + NL - 1) / NL;
    const dim3 grid((W + G * kVec - 1) / (G * kVec), B);
    rglru_chunked_kernel<T, kVec, G><<<grid, kThreads, 0, stream>>>(
        xt, rt, it, lam, h0, h0_bf16, out, hT, L, W, Tc);
  } else {
    constexpr int G = 8, NL = kThreads / G;
    const int Tc = (L + NL - 1) / NL;
    const dim3 grid((W + G - 1) / G, B);
    rglru_chunked_kernel<T, 1, G><<<grid, kThreads, 0, stream>>>(
        xt, rt, it, lam, h0, h0_bf16, out, hT, L, W, Tc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, i: (B, L, W) contiguous, dtype 0 = float32, 1 = bfloat16; lam (W,)
// float32; h0 (B, W) float32 (h0_dtype 0) or bfloat16 (1); out (B, L, W)
// float32; hT (B, W) float32, or null to skip it.  Returns
// cudaGetLastError() after the launch.
extern "C" int rglru_scan(const void* x, const void* r, const void* i, const void* lam,
                          const void* h0, int h0_dtype, void* out, void* hT, int B, int L,
                          int W, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || W <= 0 || (h0_dtype != 0 && h0_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lam);
  float* of = static_cast<float*>(out);
  float* tf = static_cast<float*>(hT);
  if (dtype == 0) return launch<float>(x, r, i, lf, h0, h0_dtype, of, tf, B, L, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, r, i, lf, h0, h0_dtype, of, tf, B, L, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
