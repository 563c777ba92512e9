// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_intra_chunk` in src/repro/kernels/ssd.py
// (`_kernel`, called through `pl.pallas_call`).  For every (batch, chunk,
// head) it computes, with acum = cumsum_s(dt[s] * A[h]) over the chunk:
//
//   y_intra[t, p]  = sum_{s <= t} (C_t . B_s) exp(acum_t - acum_s) dt_s x[s, p]
//   contrib[p, n]  = sum_s dt_s exp(acum_last - acum_s) x[s, p] B[s, n]
//   chunk_decay    = exp(acum_last)
//
// in float32 (inputs x, B, C in float32 or bfloat16; dt and A float32).  The
// prefix sum acum is summed in float64 and rounded once to float32 (see
// kernels/ssd.py: at C = 256 a float32 running sum would carry ~1e-3 of
// order-dependent error into y).
// The exp of a masked entry (s > t, where acum_t - acum_s is large and
// positive) is never computed: masked weights are 0.
//
// Layouts, all contiguous: x (B, nb, C, H, P), dt (B, nb, C, H), A (H,),
// Bm / Cm (B, nb, C, N); y (B, nb, C, H, P), contrib (B, nb, H, P, N),
// chunk_decay (B, nb, H); scratch cb (B, nb, C, C) float32.
//
// Design: two launches on the caller's stream.
//   1. `ssd_cb_kernel`: CB[t, s] = C_t . B_s for each (batch, chunk), in
//      32 x 32 tiles on and below the diagonal (tiles above it are never
//      read).  The product is shared by every head of the chunk, as the
//      Pallas kernel's head block shares it, so it is computed once per
//      chunk (C^2 N FMAs) instead of once per head (H times that).
//   2. `ssd_chunk_kernel`: one block of 256 threads per (batch * chunk,
//      head).  The chunk's x[:, h, :] (C x P, float32) stays in shared
//      memory; thread 0 forms the cumulative sum.  y is built 32 query rows
//      at a time: for each 32-key tile at or below them, the weight tile
//      W[t, s] = CB[t, s] exp(acum_t - acum_s) dt_s is formed in shared
//      memory once (one exp per (t, s) pair), then each thread adds
//      W[t, s] x[s, p] for its column p and its rows, so one load of x[s, p]
//      feeds all the thread's rows.  contrib is an outer-product sum over s
//      in 16 x 16 thread micro-tiles (p by n), B streamed in 32-row tiles.
//   At C = 256 the f32 (C, C) decay matrix of a head (256 KB) never exists:
//   only 32 x 32 tiles of it do.
//
// Bound on this card: at mamba2-2.7b's full width with L = 1024 (C = 256,
// nb = 4, H = 80, P = 64, N = 128, bfloat16 inputs) the call reads 10.5 MB
// of x and 0.5 MB of B/C and writes 21 MB of y and 10.5 MB of contrib
// (43 MB, 0.013 ms at 3.35 TB/s) and does 1.3 GFLOP for y (the causal half)
// and 1.3 GFLOP for contrib: bound by bytes on paper.  This simple form runs
// the products on the CUDA cores in float32, two shared-memory loads per
// FMA at best, so it is bound by those operations in practice (tensor cores,
// mma / wgmma, are later work).  At the serve prefill (C = 16) it is bound
// by launch latency.
//
// Nothing is allocated here; the caller owns every buffer.  No
// synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;      // query rows / keys per tile
constexpr int kMaxC = 256;
constexpr int kMaxP = 128;     // a power of two
constexpr int kMaxN = 256;
constexpr int kMicro = 16;     // contrib: 16 x 16 threads
constexpr int kNPer = 8;                // n columns per thread per pass
constexpr int kNPass = kMicro * kNPer;  // n columns per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cb, int C, int N) {
  __shared__ float cs[kTile][kTile + 1];
  __shared__ float bs[kTile][kTile + 1];
  const int tt = blockIdx.y;
  const int st = blockIdx.x;
  if (st > tt) return;  // above the diagonal: never read
  const long long bc = blockIdx.z;
  const int t0 = tt * kTile;
  const int s0 = st * kTile;
  const int tid = threadIdx.x;
  const int r = tid >> 3;   // query row in the tile (0..31)
  const int c0 = tid & 7;   // key columns c0, c0 + 8, c0 + 16, c0 + 24
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const long long base = bc * C * N;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    __syncthreads();
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int rr = i / kTile;
      const int nn = i - rr * kTile;
      const int n = n0 + nn;
      const int t = t0 + rr;
      const int s = s0 + rr;
      cs[rr][nn] = (t < C && n < N) ? to_f(Cm[base + static_cast<long long>(t) * N + n]) : 0.f;
      bs[rr][nn] = (s < C && n < N) ? to_f(Bm[base + static_cast<long long>(s) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < kTile; ++nn) {
      const float cv = cs[r][nn];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(cv, bs[c0 + 8 * k][nn], acc[k]);
    }
  }
  const int t = t0 + r;
  if (t < C) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = s0 + c0 + 8 * k;
      if (s < C) cb[(bc * C + t) * C + s] = acc[k];
    }
  }
}

// RPT: query rows per thread in a 32-row tile = max(1, 32 * P / 256);
// kPPer = max(1, P / 16): contrib rows p per thread.
template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const float* __restrict__ cb, float* __restrict__ y,
                 float* __restrict__ contrib, float* __restrict__ decay, int C,
                 int H, int P, int N) {
  extern __shared__ float smem[];
  float* xs = smem;                      // [C][P]
  float* ack = xs + C * P;               // [C]
  float* dts = ack + C;                  // [C]
  float* coef = dts + C;                 // [C] dt_s exp(acum_last - acum_s)
  float* ws = coef + C;                  // [kTile][kTile + 1]
  float* bs = ws + kTile * (kTile + 1);  // [kTile][kNPass]

  const int h = blockIdx.x;
  const long long bc = blockIdx.y;
  const int tid = threadIdx.x;

  for (int s = tid; s < C; s += kThreads) dts[s] = dt[(bc * C + s) * H + h];
  for (int i = tid; i < C * P; i += kThreads) {
    const int s = i / P;
    const int p = i - s * P;
    xs[i] = to_f(x[((bc * C + s) * H + h) * P + p]);
  }
  __syncthreads();
  if (tid == 0) {
    // the prefix sum in float64, each value rounded once to float32
    const double a = A[h];
    double run = 0.0;
    for (int s = 0; s < C; ++s) {
      run += static_cast<double>(dts[s]) * a;
      ack[s] = static_cast<float>(run);
    }
    decay[bc * H + h] = expf(ack[C - 1]);
  }
  __syncthreads();
  const float alast = ack[C - 1];
  for (int s = tid; s < C; s += kThreads) coef[s] = dts[s] * expf(alast - ack[s]);

  // ---- y_intra --------------------------------------------------------
  const int p = tid % P;          // this thread's column
  const int r0 = tid / P;         // first row in a tile
  const int rstep = kThreads / P; // P divides 256
  for (int t0 = 0; t0 < C; t0 += kTile) {
    float acc[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) acc[k] = 0.f;
    for (int s0 = 0; s0 <= t0; s0 += kTile) {
      __syncthreads();  // ws is free (and coef written)
      for (int i = tid; i < kTile * kTile; i += kThreads) {
        const int tl = i / kTile;
        const int sl = i - tl * kTile;
        const int t = t0 + tl;
        const int s = s0 + sl;
        float w = 0.f;
        if (s <= t && t < C) w = cb[(bc * C + t) * C + s] * expf(ack[t] - ack[s]) * dts[s];
        ws[tl * (kTile + 1) + sl] = w;
      }
      __syncthreads();
      const int sn = min(kTile, C - s0);
      for (int sl = 0; sl < sn; ++sl) {
        const float xv = xs[(s0 + sl) * P + p];
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const int tl = r0 + k * rstep;
          if (tl < kTile) acc[k] = fmaf(ws[tl * (kTile + 1) + sl], xv, acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int t = t0 + r0 + k * rstep;
      if (r0 + k * rstep < kTile && t < C) y[((bc * C + t) * H + h) * P + p] = acc[k];
    }
  }

  // ---- contrib ----------------------------------------------------------
  constexpr int kPPer = RPT >= 2 ? RPT / 2 : 1;
  const int tp = tid / kMicro;
  const int tn = tid - tp * kMicro;
  const long long bbase = bc * C * N;
  for (int n0 = 0; n0 < N; n0 += kNPass) {
    float acc[kPPer][kNPer];
#pragma unroll
    for (int i = 0; i < kPPer; ++i)
#pragma unroll
      for (int j = 0; j < kNPer; ++j) acc[i][j] = 0.f;
    for (int s0 = 0; s0 < C; s0 += kTile) {
      __syncthreads();  // bs is free
      for (int i = tid; i < kTile * kNPass; i += kThreads) {
        const int sl = i / kNPass;
        const int nl = i - sl * kNPass;
        const int s = s0 + sl;
        const int n = n0 + nl;
        bs[i] = (s < C && n < N) ? to_f(Bm[bbase + static_cast<long long>(s) * N + n]) : 0.f;
      }
      __syncthreads();
      const int sn = min(kTile, C - s0);
      for (int sl = 0; sl < sn; ++sl) {
        const int s = s0 + sl;
        const float cf = coef[s];
        float xv[kPPer];
#pragma unroll
        for (int i = 0; i < kPPer; ++i) {
          const int pp = tp + kMicro * i;
          xv[i] = pp < P ? cf * xs[s * P + pp] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kNPer; ++j) {
          const float bv = bs[sl * kNPass + tn + kMicro * j];
#pragma unroll
          for (int i = 0; i < kPPer; ++i) acc[i][j] = fmaf(xv[i], bv, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPPer; ++i) {
      const int pp = tp + kMicro * i;
      if (pp >= P) continue;
#pragma unroll
      for (int j = 0; j < kNPer; ++j) {
        const int n = n0 + tn + kMicro * j;
        if (n < N) contrib[((bc * H + h) * P + pp) * N + n] = acc[i][j];
      }
    }
  }
}

template <typename T, int RPT>
int launch_chunk(const void* x, const float* dt, const float* A, const void* Bm,
                 const float* cb, float* y, float* contrib, float* decay,
                 int BC, int C, int H, int P, int N, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(C) * P + 3 * C + kTile * (kTile + 1) + kTile * kNPass);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_chunk_kernel<T, RPT><<<dim3(H, BC), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), cb, y, contrib,
      decay, C, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, float* cb, float* y, float* contrib, float* decay,
           int BC, int C, int H, int P, int N, cudaStream_t stream) {
  const int nt = (C + kTile - 1) / kTile;
  ssd_cb_kernel<T><<<dim3(nt, nt, BC), kThreads, 0, stream>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), cb, C, N);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rpt = kTile * P / kThreads;
  switch (rpt) {
    case 16: return launch_chunk<T, 16>(x, dt, A, Bm, cb, y, contrib, decay, BC, C, H, P, N, stream);
    case 8: return launch_chunk<T, 8>(x, dt, A, Bm, cb, y, contrib, decay, BC, C, H, P, N, stream);
    case 4: return launch_chunk<T, 4>(x, dt, A, Bm, cb, y, contrib, decay, BC, C, H, P, N, stream);
    case 2: return launch_chunk<T, 2>(x, dt, A, Bm, cb, y, contrib, decay, BC, C, H, P, N, stream);
    default: return launch_chunk<T, 1>(x, dt, A, Bm, cb, y, contrib, decay, BC, C, H, P, N, stream);
  }
}

}  // namespace

// BC = batch * chunks; 0 < C <= 256, P a power of two <= 128, 0 < N <= 256.
// dtype 0 = float32, 1 = bfloat16 (x, Bm, Cm).  Returns cudaGetLastError()
// after the launches (or the error that refused one).
extern "C" int ssd_intra_chunk(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* cb,
                               void* y, void* contrib, void* decay, int BC,
                               int C, int H, int P, int N, int dtype,
                               void* stream) {
  if (BC <= 0 || BC > 65535 || C <= 0 || C > kMaxC || H <= 0 || P <= 0 ||
      P > kMaxP || (P & (P - 1)) != 0 || N <= 0 || N > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* cbf = static_cast<float*>(cb);
  float* yf = static_cast<float*>(y);
  float* cf = static_cast<float*>(contrib);
  float* df = static_cast<float*>(decay);
  if (dtype == 0) {
    return launch<float>(x, dtf, Af, Bm, Cm, cbf, yf, cf, df, BC, C, H, P, N, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, cbf, yf, cf, df, BC, C, H, P, N, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
