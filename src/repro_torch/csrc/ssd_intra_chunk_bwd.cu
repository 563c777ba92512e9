// Backward of the Mamba-2 SSD intra-chunk part (csrc/ssd_intra_chunk.cu)
// for Hopper (sm_90a).
//
// Replaces the gradient that the reference takes by differentiating its
// model-level chunked scan (`ssd_chunked` in src/repro/models/mamba2.py,
// whose intra-chunk part the TPU kernel `ssd_intra_chunk` in
// src/repro/kernels/ssd.py computes; the Pallas kernel itself has no VJP).
// Per (batch, chunk) and head h, with acum = cumsum(dt A) over the chunk
// (float64, rounded once to float32, as the forward forms it):
//
//   y[t]     = sum_{s<=t} W[t,s] x[s],  W[t,s] = CB[t,s] exp(acum_t - acum_s) dt_s
//   contrib  = sum_s coef_s x_s B_s^T,  coef_s = dt_s exp(acum_last - acum_s)
//   decay    = exp(acum_last),           CB = C B^T (one group: shared by heads)
//
// Given dy, dcontrib and ddecay (any may be null: a zero gradient), with
// dW = dy x^T and q = dW CB exp(seg):
//
//   dx[s]  = sum_{t>=s} W[t,s] dy[t] + coef_s G[s],   G = B dcontrib^T
//   dCB    = sum_h dW exp(seg) dt_s                   (over heads: one group)
//   dC     = dCB B,   dB = dCB^T C + sum_h coef x dcontrib
//   dacum  = rowsum(q dt_s) - colsum(q dt_s) - dcoef coef
//            (+ sum_s dcoef coef + ddecay decay at the last step),
//            dcoef_s = x_s . G[s]
//   ddt_s  = colsum_t(q)[s] + dcoef_s exp(acum_last - acum_s) + A revcumsum(dacum)_s
//   dA     = sum over batch, chunks and s of revcumsum(dacum)_s dt_s
//
// x (BC, C, H, P), B and C (BC, C, N) in float32 or bfloat16, dt (BC, C, H)
// and A (H,) float32, contiguous; dy (BC, C, H, P), dcontrib (BC, H, P, N),
// ddecay (BC, H) float32.  dx, dB, dC come out in x's dtype, ddt and dA in
// float32.  The caller gives float32 scratch of `ssd_intra_chunk_bwd_scratch`
// floats.
//
// Bound on this card: at mamba2-2.7b's train shape (8 sequences of one
// chunk of 128, 80 heads of 64, state 128, bf16) the products are ~6 GFLOP
// and the bytes ~60 MB, so the work bounds it (~6 us at the bf16
// tensor-core rate).  This first design runs the products on the CUDA cores
// in float32 through `bwd::tile_product` (64 x 64 tiles), in seven
// launches, each reducing what it reduces inside one block in a fixed order:
//   0. per (chunk, head): acum (float64 sum) and coef; per chunk's lower
//      (t, s) tiles: CB;
//   1. per lower (t, s) tile and group of heads: dW for each head of the
//      group, its decay weight, the group's partial dCB in registers, and
//      the head's row and column sums of q dt_s and of q over the tile
//      (shared memory, in order) as per-tile partials;
//   2. the groups' partial dCB summed in group order;
//   3. per (s, p) tile and head: dx from W^T dy and coef G, and the tile's
//      partial of dcoef;
//   4. per (row, n) tile: dC = dCB B, and dB = dCB^T C plus the head-summed
//      contrib term, one product of depth H P;
//   5. per (chunk, head): the partials summed in tile order, dacum, its
//      reverse cumulative sum, ddt and the chunk's term of dA;
//   6. dA summed over batch and chunks in order.
// There are no atomics: a resumed step repeats bit for bit.  Tensor cores
// (mma.sync / wgmma) are ROADMAP queue B.
//
// Nothing is allocated here and nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_tile.cuh"

namespace {

using bwd::kBM;
using bwd::kBN;
using bwd::kLd;
using bwd::kT;
using bwd::kTileSmem;
using bwd::tile_col;
using bwd::tile_row;
using bwd::to_f;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
constexpr int kBlocksWanted = 264;  // two blocks per SM for the head-group split

// Offsets (floats) of the scratch regions.
struct Scratch {
  long long ack, coef, cb, dcb_part, dcb, rowp, colp, qcol, dcoef_part, da_part, total;
};

__host__ __device__ inline Scratch scratch_layout(long long BC, int C, int H, int P, int HG) {
  const long long nt = (C + kBM - 1) / kBM;
  const long long np = (P + kBN - 1) / kBN;
  Scratch s;
  s.ack = 0;
  s.coef = s.ack + BC * C * H;
  s.cb = s.coef + BC * C * H;
  s.dcb_part = s.cb + BC * C * C;
  s.dcb = s.dcb_part + HG * BC * C * C;
  s.rowp = s.dcb + BC * C * C;
  s.colp = s.rowp + BC * H * nt * C;
  s.qcol = s.colp + BC * H * nt * C;
  s.dcoef_part = s.qcol + BC * H * nt * C;
  s.da_part = s.dcoef_part + BC * H * np * C;
  s.total = s.da_part + BC * H;
  return s;
}

int head_groups(long long BC, int C, int H) {
  const int nt = cdiv(C, kBM);
  const long long blocks = BC * (nt * (nt + 1) / 2);
  const long long hg = (kBlocksWanted + blocks - 1) / blocks;
  return static_cast<int>(hg < 1 ? 1 : hg > H ? H : hg);
}

// the lower (ti, si <= ti) tile of pair index p
__device__ __forceinline__ void lower_tile(int p, int& ti, int& si) {
  ti = 0;
  while (p > ti) {
    p -= ti + 1;
    ++ti;
  }
  si = p;
}

// 0a. acum and coef, one thread per (chunk, head)
__global__ void __launch_bounds__(kT)
ssd_bwd_prep_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                    float* __restrict__ ack, float* __restrict__ coef, long long BC, int C,
                    int H) {
  const long long idx = static_cast<long long>(blockIdx.x) * kT + threadIdx.x;
  if (idx >= BC * H) return;
  const long long bc = idx / H;
  const int h = static_cast<int>(idx - bc * H);
  const double a = A[h];
  double run = 0.0;
  for (int t = 0; t < C; ++t) {
    const long long o = (bc * C + t) * H + h;
    run += static_cast<double>(dt[o]) * a;
    ack[o] = static_cast<float>(run);
  }
  const float last = ack[(bc * C + C - 1) * H + h];
  for (int t = 0; t < C; ++t) {
    const long long o = (bc * C + t) * H + h;
    coef[o] = dt[o] * expf(last - ack[o]);
  }
}

// 0b. CB = C B^T over the chunk's lower tiles
template <typename T>
__global__ void __launch_bounds__(kT)
ssd_bwd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cb,
                  int C, int N) {
  if (blockIdx.x > blockIdx.y) return;  // an upper tile: every entry masked
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const long long bc = blockIdx.z;
  const int t0 = blockIdx.y * kBM;
  const int s0 = blockIdx.x * kBN;
  const T* Be = Bm + bc * C * N;
  const T* Ce = Cm + bc * C * N;
  float acc[4][4];
  bwd::zero(acc);
  bwd::tile_product<true, false>(
      acc, sm, t0, s0, N,
      [=](int t, int n) { return t < C ? to_f(Ce[static_cast<long long>(t) * N + n]) : 0.f; },
      [=](int n, int s) { return s < C ? to_f(Be[static_cast<long long>(s) * N + n]) : 0.f; });
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tile_row(i);
      const int s = s0 + tile_col(j);
      if (t < C && s < C) cb[(bc * C + t) * C + s] = acc[i][j];
    }
}

// 1. per lower (t, s) tile, head group and chunk: the group's dCB and each
// head's row / column sums of q dt_s and column sums of q over the tile
template <typename T>
__global__ void __launch_bounds__(kT)
ssd_bwd_dcb_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ dy, const float* __restrict__ ack,
                   const float* __restrict__ cb, float* __restrict__ dcb_part,
                   float* __restrict__ rowp, float* __restrict__ colp,
                   float* __restrict__ qcol, long long BC, int C, int H, int P, int HG) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* sd = sm + kTileSmem;      // [kBM][kLd]: q dt_s of the head's tile
  float* sq = sd + kBM * kLd;      // [kBM][kLd]: q
  int ti, si;
  lower_tile(blockIdx.x, ti, si);
  const int grp = blockIdx.y;
  const long long bc = blockIdx.z;
  const int nt = cdiv(C, kBM);
  const int t0 = ti * kBM;
  const int s0 = si * kBN;
  const int h_lo = static_cast<int>(static_cast<long long>(grp) * H / HG);
  const int h_hi = static_cast<int>(static_cast<long long>(grp + 1) * H / HG);
  const int tid = threadIdx.x;

  float cbv[4][4], dcb[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tile_row(i);
      const int s = s0 + tile_col(j);
      cbv[i][j] = t < C && s <= t ? cb[(bc * C + t) * C + s] : 0.f;
      dcb[i][j] = 0.f;
    }
  for (int h = h_lo; h < h_hi; ++h) {
    float dw[4][4];
    bwd::zero(dw);
    if (dy != nullptr) {
      bwd::tile_product<true, false>(
          dw, sm, t0, s0, P,
          [=](int t, int p) { return t < C ? dy[((bc * C + t) * H + h) * P + p] : 0.f; },
          [=](int p, int s) { return s < C ? to_f(x[((bc * C + s) * H + h) * P + p]) : 0.f; });
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tile_row(i);
        const int c = tile_col(j);
        const int t = t0 + r;
        const int s = s0 + c;
        float q = 0.f, qd = 0.f;
        if (t < C && s <= t) {
          const float lv = expf(ack[(bc * C + t) * H + h] - ack[(bc * C + s) * H + h]);
          const float dts = dt[(bc * C + s) * H + h];
          q = dw[i][j] * cbv[i][j] * lv;
          qd = q * dts;
          dcb[i][j] = fmaf(dw[i][j] * lv, dts, dcb[i][j]);
        }
        sd[r * kLd + c] = qd;
        sq[r * kLd + c] = q;
      }
    __syncthreads();
    const long long head = (bc * H + h) * nt;
    if (tid < kBM) {                      // row t0 + tid of q dt_s, over s
      if (t0 + tid < C) {
        float v = 0.f;
        for (int c = 0; c < kBN; ++c) v += sd[tid * kLd + c];
        rowp[(head + si) * C + t0 + tid] = v;
      }
    } else if (tid < 2 * kBM) {           // column s0 + c of q dt_s, over t
      const int c = tid - kBM;
      if (s0 + c < C) {
        float v = 0.f;
        for (int r = 0; r < kBM; ++r) v += sd[r * kLd + c];
        colp[(head + ti) * C + s0 + c] = v;
      }
    } else if (tid < 3 * kBM) {           // column s0 + c of q, over t
      const int c = tid - 2 * kBM;
      if (s0 + c < C) {
        float v = 0.f;
        for (int r = 0; r < kBM; ++r) v += sq[r * kLd + c];
        qcol[(head + ti) * C + s0 + c] = v;
      }
    }
    __syncthreads();
  }
  float* out = dcb_part + (grp * BC + bc) * C * C;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tile_row(i);
      const int s = s0 + tile_col(j);
      if (t < C && s < C) out[static_cast<long long>(t) * C + s] = dcb[i][j];
    }
}

// 2. dCB = the groups' partials summed in group order (0 above the diagonal)
__global__ void __launch_bounds__(kT)
ssd_bwd_dcb_sum_kernel(const float* __restrict__ dcb_part, float* __restrict__ dcb,
                       long long BC, int C, int HG) {
  const long long n = BC * C * C;
  const long long idx = static_cast<long long>(blockIdx.x) * kT + threadIdx.x;
  if (idx >= n) return;
  const int s = static_cast<int>(idx % C);
  const int t = static_cast<int>((idx / C) % C);
  float v = 0.f;
  if (s <= t)
    for (int g = 0; g < HG; ++g) v += dcb_part[g * n + idx];
  dcb[idx] = v;
}

// 3. per (s, p) tile, head and chunk: dx = W^T dy + coef G, and the tile's
// part of dcoef = sum_p x G
template <typename T>
__global__ void __launch_bounds__(kT)
ssd_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                  const float* __restrict__ dt, const float* __restrict__ dy,
                  const float* __restrict__ dcon, const float* __restrict__ ack,
                  const float* __restrict__ coef, const float* __restrict__ cb,
                  T* __restrict__ dx, float* __restrict__ dcoef_part, int C, int H, int P,
                  int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* sg = sm + kTileSmem;   // [kBM][kLd]: x G of the tile
  const int np = cdiv(P, kBN);
  const int pi = blockIdx.x % np;
  const int s0 = (blockIdx.x / np) * kBM;
  const int p0 = pi * kBN;
  const int h = blockIdx.y;
  const long long bc = blockIdx.z;
  float wd[4][4], g[4][4];
  bwd::zero(wd);
  bwd::zero(g);
  if (dy != nullptr) {
    // A(m = s, k = t) = W[t, s] (0 where t < s), B(k = t, n = p) = dy[t, h, p]
    bwd::tile_product<false, true>(
        wd, sm, s0, p0, C,
        [=](int s, int t) -> float {
          if (s >= C || t < s) return 0.f;
          const long long os = (bc * C + s) * H + h;
          return cb[(bc * C + t) * C + s] * expf(ack[(bc * C + t) * H + h] - ack[os]) * dt[os];
        },
        [=](int t, int p) { return p < P ? dy[((bc * C + t) * H + h) * P + p] : 0.f; });
  }
  if (dcon != nullptr) {
    // G: A(m = s, k = n) = B[s, n], B(k = n, n = p) = dcontrib[h, p, n]
    const T* Be = Bm + bc * C * N;
    const float* de = dcon + (bc * H + h) * P * N;
    bwd::tile_product<true, false>(
        g, sm, s0, p0, N,
        [=](int s, int n) { return s < C ? to_f(Be[static_cast<long long>(s) * N + n]) : 0.f; },
        [=](int n, int p) { return p < P ? de[static_cast<long long>(p) * N + n] : 0.f; });
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tile_row(i);
    const int s = s0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tile_col(j);
      const int p = p0 + c;
      float xg = 0.f;
      if (s < C && p < P) {
        const long long o = ((bc * C + s) * H + h) * P + p;
        const float cf = coef[(bc * C + s) * H + h];
        dx[o] = bwd::from_f<T>(fmaf(cf, g[i][j], wd[i][j]));
        xg = to_f(x[o]) * g[i][j];
      }
      sg[r * kLd + c] = xg;
    }
  }
  __syncthreads();
  if (threadIdx.x < kBM && s0 + threadIdx.x < C) {
    float v = 0.f;
    for (int c = 0; c < kBN; ++c) v += sg[threadIdx.x * kLd + c];
    dcoef_part[((bc * H + h) * np + pi) * C + s0 + threadIdx.x] = v;
  }
}

// 4. per (row, n) tile and chunk: dC (y 0) and dB (y 1)
template <typename T>
__global__ void __launch_bounds__(kT)
ssd_bwd_dbc_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const float* __restrict__ dcon, const float* __restrict__ coef,
                   const float* __restrict__ dcb, T* __restrict__ dB, T* __restrict__ dC,
                   int C, int H, int P, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int nn = cdiv(N, kBN);
  const int m0 = (blockIdx.x / nn) * kBM;
  const int n0 = (blockIdx.x % nn) * kBN;
  const long long bc = blockIdx.z;
  const float* de = dcb + bc * C * C;
  float acc[4][4];
  bwd::zero(acc);
  if (blockIdx.y == 0) {
    // dC[t, n] = sum_{s <= t} dCB[t, s] B[s, n]
    const T* Be = Bm + bc * C * N;
    bwd::tile_product<true, true>(
        acc, sm, m0, n0, min(C, m0 + kBM),
        [=](int t, int s) { return t < C && s <= t ? de[static_cast<long long>(t) * C + s] : 0.f; },
        [=](int s, int n) { return n < N ? to_f(Be[static_cast<long long>(s) * N + n]) : 0.f; });
  } else {
    // dB[s, n] = sum_{t >= s} dCB[t, s] C[t, n] + sum_{h, p} coef[s, h] x[s, h, p] dcontrib[h, p, n]
    const T* Ce = Cm + bc * C * N;
    bwd::tile_product<false, true>(
        acc, sm, m0, n0, C,
        [=](int s, int t) { return s < C && t >= s ? de[static_cast<long long>(t) * C + s] : 0.f; },
        [=](int t, int n) { return n < N ? to_f(Ce[static_cast<long long>(t) * N + n]) : 0.f; });
    if (dcon != nullptr) {
      const float* dce = dcon + bc * H * P * N;
      bwd::tile_product<true, true>(
          acc, sm, m0, n0, H * P,
          [=](int s, int hp) -> float {
            if (s >= C) return 0.f;
            const int h = hp / P;
            return coef[(bc * C + s) * H + h] * to_f(x[(bc * C + s) * H * P + hp]);
          },
          [=](int hp, int n) { return n < N ? dce[static_cast<long long>(hp) * N + n] : 0.f; });
    }
  }
  T* out = (blockIdx.y == 0 ? dC : dB) + bc * C * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tile_row(i);
      const int n = n0 + tile_col(j);
      if (m < C && n < N) out[static_cast<long long>(m) * N + n] = bwd::from_f<T>(acc[i][j]);
    }
}

// 5. per (chunk, head): dacum from the partials, its reverse cumulative
// sum, ddt and the chunk's term of dA
__global__ void __launch_bounds__(kT)
ssd_bwd_finalize_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                        const float* __restrict__ ddecay, const float* __restrict__ ack,
                        const float* __restrict__ coef, const float* __restrict__ rowp,
                        const float* __restrict__ colp, const float* __restrict__ qcol,
                        const float* __restrict__ dcoef_part, float* __restrict__ ddt,
                        float* __restrict__ da_part, long long BC, int C, int H, int P) {
  const long long idx = static_cast<long long>(blockIdx.x) * kT + threadIdx.x;
  if (idx >= BC * H) return;
  const long long bc = idx / H;
  const int h = static_cast<int>(idx - bc * H);
  const int nt = cdiv(C, kBM);
  const int np = cdiv(P, kBN);
  const long long head = bc * H + h;
  auto dcoef = [&](int s) {
    float v = 0.f;
    for (int pi = 0; pi < np; ++pi) v += dcoef_part[(head * np + pi) * C + s];
    return v;
  };
  const float last = ack[(bc * C + C - 1) * H + h];
  float extra = ddecay != nullptr ? ddecay[head] * expf(last) : 0.f;
  for (int s = 0; s < C; ++s) extra = fmaf(dcoef(s), coef[(bc * C + s) * H + h], extra);
  const float a = A[h];
  float dz = 0.f, da = 0.f;
  for (int t = C - 1; t >= 0; --t) {
    const int tt = t / kBM;
    float row = 0.f, col = 0.f, qc = 0.f;
    for (int k = 0; k <= tt; ++k) row += rowp[(head * nt + k) * C + t];
    for (int k = tt; k < nt; ++k) {
      col += colp[(head * nt + k) * C + t];
      qc += qcol[(head * nt + k) * C + t];
    }
    const long long o = (bc * C + t) * H + h;
    const float dco = dcoef(t);
    float d_ack = row - col - dco * coef[o];
    if (t == C - 1) d_ack += extra;
    dz += d_ack;
    ddt[o] = qc + dco * expf(last - ack[o]) + dz * a;
    da = fmaf(dz, dt[o], da);
  }
  da_part[head] = da;
}

// 6. dA[h] = sum over (batch, chunk) in order
__global__ void __launch_bounds__(kT)
ssd_bwd_da_kernel(const float* __restrict__ da_part, float* __restrict__ dA, long long BC, int H) {
  const int h = blockIdx.x * kT + threadIdx.x;
  if (h >= H) return;
  float v = 0.f;
  for (long long bc = 0; bc < BC; ++bc) v += da_part[bc * H + h];
  dA[h] = v;
}

template <typename T>
int launch(const void* xv, const float* dt, const float* A, const void* Bv, const void* Cv,
           const float* dy, const float* dcon, const float* ddec, void* dxv, float* ddt,
           float* dA, void* dBv, void* dCv, float* scratch, long long BC, int C, int H, int P,
           int N, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* Bm = static_cast<const T*>(Bv);
  const T* Cm = static_cast<const T*>(Cv);
  const int HG = head_groups(BC, C, H);
  const Scratch o = scratch_layout(BC, C, H, P, HG);
  float* ack = scratch + o.ack;
  float* coef = scratch + o.coef;
  float* cb = scratch + o.cb;
  float* dcb_part = scratch + o.dcb_part;
  float* dcb = scratch + o.dcb;
  float* rowp = scratch + o.rowp;
  float* colp = scratch + o.colp;
  float* qcol = scratch + o.qcol;
  float* dcoef_part = scratch + o.dcoef_part;
  float* da_part = scratch + o.da_part;
  const int nt = cdiv(C, kBM);
  const size_t tile = sizeof(float) * kTileSmem;
  const size_t tile_sq = sizeof(float) * kBM * kLd;
  cudaError_t err;
#define SSD_BWD_CHECK()                          \
  err = cudaGetLastError();                      \
  if (err != cudaSuccess) return static_cast<int>(err)

  const dim3 g0(static_cast<unsigned>((BC * H + kT - 1) / kT));
  ssd_bwd_prep_kernel<<<g0, kT, 0, s>>>(dt, A, ack, coef, BC, C, H);
  SSD_BWD_CHECK();
  const dim3 g0b(nt, nt, static_cast<unsigned>(BC));
  ssd_bwd_cb_kernel<T><<<g0b, kT, tile, s>>>(Bm, Cm, cb, C, N);
  SSD_BWD_CHECK();
  const dim3 g1(nt * (nt + 1) / 2, HG, static_cast<unsigned>(BC));
  ssd_bwd_dcb_kernel<T><<<g1, kT, tile + 2 * tile_sq, s>>>(x, dt, dy, ack, cb, dcb_part, rowp,
                                                          colp, qcol, BC, C, H, P, HG);
  SSD_BWD_CHECK();
  const dim3 g2(static_cast<unsigned>((BC * C * C + kT - 1) / kT));
  ssd_bwd_dcb_sum_kernel<<<g2, kT, 0, s>>>(dcb_part, dcb, BC, C, HG);
  SSD_BWD_CHECK();
  const dim3 g3(nt * cdiv(P, kBN), H, static_cast<unsigned>(BC));
  ssd_bwd_dx_kernel<T><<<g3, kT, tile + tile_sq, s>>>(x, Bm, dt, dy, dcon, ack, coef, cb,
                                                      static_cast<T*>(dxv), dcoef_part, C, H,
                                                      P, N);
  SSD_BWD_CHECK();
  const dim3 g4(nt * cdiv(N, kBN), 2, static_cast<unsigned>(BC));
  ssd_bwd_dbc_kernel<T><<<g4, kT, tile, s>>>(x, Bm, Cm, dcon, coef, dcb, static_cast<T*>(dBv),
                                             static_cast<T*>(dCv), C, H, P, N);
  SSD_BWD_CHECK();
  ssd_bwd_finalize_kernel<<<g0, kT, 0, s>>>(dt, A, ddec, ack, coef, rowp, colp, qcol,
                                            dcoef_part, ddt, da_part, BC, C, H, P);
  SSD_BWD_CHECK();
  const dim3 g6((H + kT - 1) / kT);
  ssd_bwd_da_kernel<<<g6, kT, 0, s>>>(da_part, dA, BC, H);
  SSD_BWD_CHECK();
#undef SSD_BWD_CHECK
  return 0;
}

}  // namespace

// Floats of float32 scratch that `ssd_intra_chunk_bwd` needs for this shape.
extern "C" long long ssd_intra_chunk_bwd_scratch(long long BC, int C, int H, int P, int N) {
  (void)N;
  return scratch_layout(BC, C, H, P, head_groups(BC, C, H)).total;
}

// x (BC, C, H, P), Bm / Cm (BC, C, N): dtype 0 = float32, 1 = bfloat16;
// dt (BC, C, H), A (H,) float32; dy (BC, C, H, P), dcontrib (BC, H, P, N),
// ddecay (BC, H) float32 or null; dx, dB, dC in x's dtype; ddt (BC, C, H)
// and dA (H,) float32.  Returns cudaGetLastError() after the launches (or
// the error that refused one).
extern "C" int ssd_intra_chunk_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* Cm, const void* dy, const void* dcontrib,
                                   const void* ddecay, void* dx, void* ddt, void* dA, void* dB,
                                   void* dC, void* scratch, long long BC, int C, int H, int P,
                                   int N, int dtype, void* stream) {
  if (BC <= 0 || BC > 65535 || C <= 0 || H <= 0 || H > 65535 || P <= 0 || N <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* dyf = static_cast<const float*>(dy);
  const float* dcf = static_cast<const float*>(dcontrib);
  const float* ddf = static_cast<const float*>(ddecay);
  float* sf = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch<float>(x, dtf, af, Bm, Cm, dyf, dcf, ddf, dx, static_cast<float*>(ddt),
                         static_cast<float*>(dA), dB, dC, sf, BC, C, H, P, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, Bm, Cm, dyf, dcf, ddf, dx,
                                 static_cast<float*>(ddt), static_cast<float*>(dA), dB, dC, sf,
                                 BC, C, H, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
