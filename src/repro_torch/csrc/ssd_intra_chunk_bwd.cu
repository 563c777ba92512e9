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
// Bound on this card: bytes.  At mamba2-2.7b's train shape (8 sequences of
// one chunk of 128, 80 heads of 64, state 128, bf16, dy alone) the call
// reads x, B, C, dt (11 MB) and the float32 dy (21 MB) and writes dx, dB,
// dC and ddt (11.5 MB): 43.6 MB, 0.013 ms at 3.35 TB/s, against ~1.4 GFLOP
// of products (~1.5 us at the bf16 tensor-core rate).
//
// Two designs; the wrapper's plan (`ssd_bwd_plan` in kernels/ssd.py) picks
// one from dtype, shape and the given gradients alone, and `design` there
// names either:
//
// * bfloat16, P >= 8 ("mma"; at P = 128 only without dcontrib, whose G
//   product and dx's 64 accumulators a thread would not fit the registers):
//   three launches on mma.sync (bf16 in, float32 accumulate), no atomics.
//   1. `ssd_bwd_main_mma_kernel<P, MINB, CONTRIB>`: one block of 8 warps
//      (two an SM where they fit and dcontrib is not given) per (chunk, head
//      group, band).  A band is up to 8 of the chunk's 16-row s-tiles, dealt
//      0, nt-1, 1, nt-2, ... so that bands carry equal causal work; the two
//      warps of a scheduler share a long and a short s-tile and split their
//      nt + 1 tile pairs evenly (`unit_segment`).  The warps form their
//      tiles CB^T[s, t] = B_s . C_t once (exact: bf16 products) from B and C
//      rows staged by cp.async, and keep them, and the group's dCB^T, in
//      shared memory in fragment order.  Per head: dy's rows (float32, read
//      in place once) are rounded to bf16 into shared memory, x's rows of
//      the segment's s-tile are A fragments, acum is a warp-parallel float64
//      scan rounded once; then per (s, t) tile, in two halves of 8 t, dW^T =
//      x dy^T on the tensor cores, one exp(acum_t - acum_s) per entry giving
//      W^T, q and the dCB^T term, and dx += W^T dy (m16n8k8) with W^T split
//      bf16 hi + lo (the accumulator's layout is the A operand's).  q's sums
//      over t finish in the warp (shuffles in a fixed order), the long
//      tile's second warp handing its part of dx and of those sums over in
//      shared memory; q's sums over s meet in shared memory and add in
//      segment order.  With dcontrib, G = B dcontrib^T (the head's dcontrib
//      staged in bf16) starts dx as coef G and gives dcoef = x . G.  The
//      group's dCB^T goes out once, after its last head.
//   2. `ssd_bwd_sum_mma_kernel`: the groups' dCB summed in group order, one
//      element a thread; the finish, one warp per (chunk, head): dacum, its
//      reverse cumulative sum (a shuffle scan in a fixed order), ddt and the
//      chunk's term of dA; and with dcontrib, dB's contrib term (a product of
//      depth H P) as a GEMM split over KS ranges of that depth.
//   3. `ssd_bwd_dbc_mma_kernel`: dC = dCB B and dB = dCB^T C (dCB split hi +
//      lo) per (chunk, 16 rows), dB adding the contrib ranges in order; dA
//      summed over batch and chunks in order.
//   dy, dcontrib and coef x are rounded once to bf16; W^T and dCB hi + lo.
//   Every gradient stays within 2e-2 of its largest entry of the plain
//   version (tests/test_torch_bwd_ssm_designs.py emulates these roundings).
// * float32 (the card-vs-CPU cross-check), P < 8, P = 128 with dcontrib, or
//   `design` "fma": the
//   first design, on the CUDA cores in float32 through `bwd::tile_product`
//   (64 x 64 tiles), in eight launches, each reducing inside one block in a
//   fixed order:
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
// There are no atomics in either design: a resumed step repeats bit for bit.
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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kBandTiles = kMmaWarps;   // s-tiles per band: one per warp
constexpr int kTileFloats = 256;        // one 16 x 16 float32 tile in fragment order
constexpr int kDbcThreads = 128;        // second kernel: 4 warps a block
constexpr int kDbcCols = 128;           // its output columns per warp (and per contrib block)
constexpr int kCbRows = 64;             // contrib term: rows s a block (4 warps x 16)
constexpr int kCbK = 64;                // its depth (h, p) a slab
constexpr int kCbPitch = kDbcCols + 8;  // bf16 pitch of the staged dcontrib slab
constexpr int kCbBlocks = 264;          // contrib blocks aimed for: the depth is split to reach them
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kMaxC = 256;
constexpr int kMaxN = 256;

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
// dy's row pitch in shared memory (bf16): at least 16 columns (one k16
// step), padded by 16 bytes so that ldmatrix is conflict-free
__host__ __device__ inline int dy_pitch(int P) { return (P < 16 ? 16 : P) + 8; }
// the s-tile of band slot k: 0, nt - 1, 1, nt - 2, ...
__host__ __device__ inline int slot_tile(int k, int nt) {
  return (k & 1) ? nt - 1 - (k >> 1) : (k >> 1);
}
// a band's (s, t >= s) tile pairs
__host__ __device__ inline int band_pairs(int band, int nt) {
  int n = 0;
  const int k1 = (band + 1) * kBandTiles < nt ? (band + 1) * kBandTiles : nt;
  for (int k = band * kBandTiles; k < k1; ++k) n += nt - slot_tile(k, nt);
  return n;
}
__host__ __device__ inline int max_band_pairs(int nt) {
  int m = 0;
  for (int b = 0; b * kBandTiles < nt; ++b) {
    const int n = band_pairs(b, nt);
    m = n > m ? n : m;
  }
  return m;
}
// band slot of warp w: warps w and w + 4 share a scheduler and take slots
// 2 (w % 4) and 2 (w % 4) + 1, a long and a short s-tile
__device__ __forceinline__ int warp_slot(int w) { return 2 * (w & 3) + (w >> 2); }
__device__ __forceinline__ int slot_warp(int k) { return (k >> 1) + 4 * (k & 1); }

// The main block's shared memory: the C.B^T tiles, then a region that first
// stages C's rows (and B's where both fit) for the prologue and then holds
// dy's rows (the units' hand-over after the pairs), the dCB^T tiles, the
// per-segment sums over s and acum, dt, coef (and with dcontrib, its head).
__host__ __device__ inline int stage_pitch(int N) { return (N + 15) / 16 * 16 + 8; }  // bf16
inline size_t cbt_bytes(int C) {
  return sizeof(float) * kTileFloats * max_band_pairs(round16(C) / 16);
}
// dy's rows in bf16, and after a head's pairs the units' hand-over of dx and
// q's sums (4 units of P / 8 n8 tiles a lane, two sums a lane)
__host__ __device__ inline size_t dy_region_bytes(int C, int P) {
  const size_t rows = sizeof(bf16) * static_cast<size_t>(round16(C)) * dy_pitch(P);
  const size_t merge = sizeof(float) * 4 * (static_cast<size_t>(P / 8) * 128 + 64);
  return rows > merge ? rows : merge;
}
inline size_t head_bytes(int C, int P) {
  const size_t cp = static_cast<size_t>(round16(C));
  return dy_region_bytes(C, P) + cbt_bytes(C) + sizeof(float) * (2 * kMmaWarps + 3) * cp;
}
inline size_t stage_bytes(int C, int N, bool both) {
  return (both ? 2 : 1) * sizeof(bf16) * static_cast<size_t>(round16(C)) * stage_pitch(N);
}
inline bool stage_b(int C, int P, int N) {
  const size_t h = head_bytes(C, P), st = stage_bytes(C, N, true);
  return cbt_bytes(C) + (h > st ? h : st) <= kSmemMax;
}
// a head's dcontrib (P x N) in bf16, pitch stage_pitch(N)
inline size_t g_bytes(int P, int N) { return sizeof(bf16) * static_cast<size_t>(P) * stage_pitch(N); }
size_t mma_smem_bytes(int C, int P, int N, bool contrib) {
  const size_t h = head_bytes(C, P) + (contrib ? g_bytes(P, N) : 0);
  const size_t st = stage_bytes(C, N, stage_b(C, P, N));
  return cbt_bytes(C) + (h > st ? h : st);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes global -> shared; the bytes past `bytes` are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldmatrix_x1_trans(uint32_t& r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(smem_u32(ptr)));
}
// c (16x8, f32) += a (16x8, bf16, row) . b (8x8, bf16, col)
__device__ __forceinline__ void mma_bf16_k8(float* c, const uint32_t* a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}
// c (16x8, f32) += a (16x16, bf16, row) . b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (v0, v1) as bf16 pairs hi = bf16(v), lo = bf16(v - hi), v0 in the low half
__device__ __forceinline__ void split_hi_lo(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = unpack(w[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
// Two bf16 of a row, row[n] in the low half, 0 past N (or for a null row);
// one 4-byte load where `pair` says the row's pairs are 4-byte aligned
__device__ __forceinline__ uint32_t ld_pair(const bf16* row, int n, int N, bool pair) {
  if (row == nullptr) return 0u;
  if (pair && n + 1 < N) return *reinterpret_cast<const uint32_t*>(row + n);
  const bf16 z = __float2bfloat16(0.f);
  __nv_bfloat162 v;
  v.x = n < N ? row[n] : z;
  v.y = n + 1 < N ? row[n + 1] : z;
  return *reinterpret_cast<const uint32_t*>(&v);
}
// a 16 x 16 float32 tile in fragment order: [n8 half][lane][4]
__device__ __forceinline__ void tile_load(const float* t, int lane, float (&v)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float4 f = *reinterpret_cast<const float4*>(t + (j * 32 + lane) * 4);
    v[j][0] = f.x;
    v[j][1] = f.y;
    v[j][2] = f.z;
    v[j][3] = f.w;
  }
}
__device__ __forceinline__ void tile_store(float* t, int lane, const float (&v)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    *reinterpret_cast<float4*>(t + (j * 32 + lane) * 4) = make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
}

// Rows [r_lo, r_hi) of a chunk's B or C (bf16) into shared memory at their
// own row index, pitch `pitch`, rows past C and columns past N zero: 16-byte
// cp.async where `vec` says the rows allow it, else element by element.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long tok0,
                                           long long rs, int C, int N, int r_lo, int r_hi,
                                           int pitch, bool vec) {
  const int cpr = (pitch - 8) / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < (r_hi - r_lo) * cpr; i += blockDim.x) {
    const int r = r_lo + i / cpr;
    const int n = (i - (r - r_lo) * cpr) * 8;
    if (vec) {
      const bool in = r < C && n < N;
      cp_async16(dst + r * pitch + n, src + (tok0 + (in ? r : 0)) * rs + (in ? n : 0), in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[r * pitch + n + e] =
            r < C && n + e < N ? src[(tok0 + r) * rs + n + e] : __float2bfloat16(0.f);
    }
  }
}

// 1. One block per (head group, band) x chunk; 8 warps, warp w owning the
// s-tile of band slot warp_slot(w) and every t-tile at or below it.  Lane
// A segment's rows sa, sb of dx (bf16) and of q's sums over t (the row's
// four lanes added in order), for head h
template <int P>
__device__ __forceinline__ void store_rows(const float (&acc)[P / 8][4], float cq_a, float cq_b,
                                           int sa, int sb, int C, int H, int h,
                                           long long tok0, long long head, bf16* dx,
                                           float* colq, int q) {
  cq_a += __shfl_xor_sync(0xffffffffu, cq_a, 1);
  cq_a += __shfl_xor_sync(0xffffffffu, cq_a, 2);
  cq_b += __shfl_xor_sync(0xffffffffu, cq_b, 1);
  cq_b += __shfl_xor_sync(0xffffffffu, cq_b, 2);
  if (q == 0) {
    if (sa < C) colq[head * C + sa] = cq_a;
    if (sb < C) colq[head * C + sb] = cq_b;
  }
#pragma unroll
  for (int j = 0; j < P / 8; ++j) {
    const int p = j * 8 + 2 * q;
    if (sa < C)
      *reinterpret_cast<uint32_t*>(dx + ((tok0 + sa) * H + h) * P + p) =
          pack_bf16(acc[j][0], acc[j][1]);
    if (sb < C)
      *reinterpret_cast<uint32_t*>(dx + ((tok0 + sb) * H + h) * P + p) =
          pack_bf16(acc[j][2], acc[j][3]);
  }
}

// roles in every m16n8k16 fragment: g = lane / 4 (row), q = lane % 4
// (column pair).
//
// The warps of a scheduler (w and w + 4) share a unit of the band: its long
// s-tile (slot 2u) and its short one (slot 2u + 1), nt + 1 tile pairs between
// them.  Warp u takes the long tile's first ceil((nt + 1) / 2) pairs (its
// segment 0); warp u + 4 the short tile whole (segment 0), then the long
// tile's last pairs (segment 1), whose part of dx and of q's sums over t it
// hands to warp u through shared memory after the head's pairs.
__device__ __forceinline__ void unit_segment(int band, int nt, int warp, int k, int& slot,
                                             int& i0, int& cnt) {
  const int u = warp & 3;
  const int sl = band * kBandTiles + 2 * u;
  const int nl = sl < nt ? nt - slot_tile(sl, nt) : 0;
  const int ns = sl + 1 < nt ? nt - slot_tile(sl + 1, nt) : 0;
  const int al = min(nl, (nl + ns + 1) / 2);
  slot = sl;
  i0 = 0;
  cnt = 0;
  if (warp < 4) {
    if (k == 0) cnt = al;
  } else if (k == 0) {
    slot = sl + 1;
    cnt = ns;
  } else {
    i0 = al;
    cnt = nl - al;
  }
  if (cnt > 0) i0 += slot_tile(slot, nt);
}

template <int P, int MINB, bool CONTRIB>
__global__ void __launch_bounds__(kMmaThreads, MINB)
ssd_bwd_main_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm, const float* __restrict__ dy,
                        const float* __restrict__ dcon, bf16* __restrict__ dx,
                        float* __restrict__ ack_out, float* __restrict__ coef_out,
                        float* __restrict__ colq, float* __restrict__ dcoef,
                        float* __restrict__ rowqd, float* __restrict__ dcb_part, int C, int H,
                        int N, int HG, int NB, int mp, long long x_rs, long long b_rs,
                        long long c_rs, int b_pair, int b_vec, int c_vec, int both) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPp = P < 16 ? 16 : P;
  constexpr int kDs = kPp + 8;   // == dy_pitch(P)
  constexpr int kKP = kPp / 16;  // k16 steps over p
  constexpr int kN8 = P / 8;     // n8 tiles over p
  constexpr int kMerge = kN8 * 128 + 64;  // floats a unit hands over: dx's part, q's sums
  const int Cp = round16(C);
  const int nt = Cp / 16;
  const int n16 = (N + 15) / 16;
  const int grp = blockIdx.x / NB;
  const int band = blockIdx.x - grp * NB;
  const long long BC = gridDim.y;
  const long long bc = blockIdx.y;
  const long long tok0 = bc * C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;

  float* cbt = reinterpret_cast<float*>(smem_raw);                // [mp] tiles
  bf16* Dy = reinterpret_cast<bf16*>(cbt + mp * kTileFloats);     // [Cp][kDs]
  float* mbuf = reinterpret_cast<float*>(Dy);                     // [4][kMerge] after the pairs
  float* dcbt = reinterpret_cast<float*>(
      Dy + dy_region_bytes(C, P) / sizeof(bf16));                 // [mp] tiles
  float* rowpart = dcbt + mp * kTileFloats;                       // [16][Cp]
  float* ack = rowpart + 2 * kMmaWarps * Cp;                      // [Cp]
  float* dts = ack + Cp;                                          // [Cp]
  float* coef = dts + Cp;                                         // [Cp]
  bf16* Gs = reinterpret_cast<bf16*>(coef + Cp);                  // [P][stage_pitch(N)]

  // the warp's two segments: (slot, first t-tile, pairs) and the slot's
  // first pair in the block's tile stores, held as scalars (a runtime index
  // into an array would put them in local memory)
  int slot0, i00, n0, slot1, i01, n1;
  unit_segment(band, nt, warp, 0, slot0, i00, n0);
  unit_segment(band, nt, warp, 1, slot1, i01, n1);
  auto pbase_of = [&](int slot) {
    int pb = 0;
    for (int s = band * kBandTiles; s < slot && s < nt; ++s) pb += nt - slot_tile(s, nt);
    return pb;
  };
  const int pb0 = pbase_of(slot0);
  const int pb1 = pbase_of(slot1);
#define SEG_SLOT(k) ((k) == 0 ? slot0 : slot1)
#define SEG_I0(k) ((k) == 0 ? i00 : i01)
#define SEG_N(k) ((k) == 0 ? n0 : n1)
#define SEG_PB(k) ((k) == 0 ? pb0 : pb1)
  // warp u's long-tile part waits for warp u + 4's
  const bool takes_merge = warp < 4 && [&] {
    int sl, i0, n;
    unit_segment(band, nt, warp + 4, 1, sl, i0, n);
    return n > 0;
  }();
  const bool gives_merge = warp >= 4 && n1 > 0;

  // ---- CB^T[s, t] = B_s . C_t of the warp's tiles (exact), dCB^T = 0 ------
  {
    // C's rows (and B's) staged over the head region, which is free until then
    const int ps = stage_pitch(N);
    bf16* Cst = Dy;
    bf16* Bst = Dy + Cp * ps;
    stage_rows(Cst, Cm, tok0, c_rs, C, N, 0, Cp, ps, c_vec);
    if (both) stage_rows(Bst, Bm, tok0, b_rs, C, N, 0, Cp, ps, b_vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int k = 0; k < 2; ++k) {
      if (SEG_N(k) == 0) continue;
      const int sj = slot_tile(SEG_SLOT(k), nt);
      const int s0 = sj * 16;
      const bf16* ba = s0 + g < C ? Bm + (tok0 + s0 + g) * b_rs : nullptr;
      const bf16* bb = s0 + g + 8 < C ? Bm + (tok0 + s0 + g + 8) * b_rs : nullptr;
      for (int i = SEG_I0(k); i < SEG_I0(k) + SEG_N(k); ++i) {
        const int t0 = i * 16;
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kk = 0; kk < n16; ++kk) {
          uint32_t a[4], b[4];
          if (both) {
            ldmatrix_x4(a, Bst + (s0 + (lane & 15)) * ps + kk * 16 + (lane >> 4) * 8);
          } else {
            const int n = kk * 16 + 2 * q;
            a[0] = ld_pair(ba, n, N, b_pair);
            a[1] = ld_pair(bb, n, N, b_pair);
            a[2] = ld_pair(ba, n + 8, N, b_pair);
            a[3] = ld_pair(bb, n + 8, N, b_pair);
          }
          ldmatrix_x4(b, Cst + (t0 + (lane & 7) + ((lane >> 4) << 3)) * ps + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(acc[0], a, b);
          mma_bf16(acc[1], a, b + 2);
        }
        tile_store(cbt + (SEG_PB(k) + i - sj) * kTileFloats, lane, acc);
      }
    }
    __syncthreads();  // the staging is consumed: the dCB^T tiles may be zeroed
    for (int k = 0; k < 2; ++k) {
      const int sj = slot_tile(SEG_SLOT(k), nt);
      const float z[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int i = SEG_I0(k); i < SEG_I0(k) + SEG_N(k); ++i)
        tile_store(dcbt + (SEG_PB(k) + i - sj) * kTileFloats, lane, z);
    }
  }

  const int h_lo = static_cast<int>(static_cast<long long>(grp) * H / HG);
  const int h_hi = static_cast<int>(static_cast<long long>(grp + 1) * H / HG);
  for (int h = h_lo; h < h_hi; ++h) {
    const long long head = bc * H + h;
    __syncthreads();  // the previous head's readers of Dy, rowpart, ack are done
    // ---- dy's rows of head h, rounded once to bf16 (0 past C and P) ------
    {
      constexpr int kQ = kPp / 4;  // float4 per row
      const int items = Cp * kQ;
      // float4 in flight a thread (fewer where registers are scarce)
      constexpr int kFly = MINB == 2 || (CONTRIB && P == 128) ? 4 : 8;
      for (int it0 = tid; it0 < items; it0 += kFly * kMmaThreads) {
        float4 v[kFly];
#pragma unroll
        for (int u = 0; u < kFly; ++u) {
          const int it = it0 + u * kMmaThreads;
          const int t = it / kQ;
          const int p = (it - t * kQ) * 4;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (dy != nullptr && it < items && t < C && p < P)
            v[u] = *reinterpret_cast<const float4*>(dy + ((tok0 + t) * H + h) * P + p);
        }
#pragma unroll
        for (int u = 0; u < kFly; ++u) {
          const int it = it0 + u * kMmaThreads;
          if (it < items) {
            const int t = it / kQ;
            const int p = (it - t * kQ) * 4;
            *reinterpret_cast<uint2*>(Dy + t * kDs + p) =
                make_uint2(pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
          }
        }
      }
    }
    if constexpr (CONTRIB) {
      // the head's dcontrib (P x N) rounded once to bf16, 0 past N
      const int gp = stage_pitch(N);
      const int q4 = (gp - 8) / 4;  // float4 a row
      const float* dch = dcon + head * static_cast<long long>(P) * N;
      const bool v4 = N % 4 == 0;
      constexpr int kGFly = P == 128 ? 4 : 8;  // float4 in flight a thread
      for (int it0 = tid; it0 < P * q4; it0 += kGFly * kMmaThreads) {
        float4 v[kGFly];
#pragma unroll
        for (int u = 0; u < kGFly; ++u) {
          const int it = it0 + u * kMmaThreads;
          const int pr = it / q4;
          const int n = (it - pr * q4) * 4;
          const float* src = dch + static_cast<long long>(pr) * N + n;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (it < P * q4 && n < N) {
            if (v4) {
              v[u] = *reinterpret_cast<const float4*>(src);
            } else {
              v[u].x = src[0];
              v[u].y = n + 1 < N ? src[1] : 0.f;
              v[u].z = n + 2 < N ? src[2] : 0.f;
              v[u].w = n + 3 < N ? src[3] : 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kGFly; ++u) {
          const int it = it0 + u * kMmaThreads;
          if (it < P * q4) {
            const int pr = it / q4;
            const int n = (it - pr * q4) * 4;
            *reinterpret_cast<uint2*>(Gs + pr * gp + n) =
                make_uint2(pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
          }
        }
      }
    }
    for (int s = tid; s < Cp; s += kMmaThreads) dts[s] = s < C ? dt[(tok0 + s) * H + h] : 0.f;
    __syncthreads();
    // ---- acum: float64 prefix sum of dt * A, each value rounded once; coef --
    if (warp == 0) {
      const double a = A[h];
      const int per = (C + 31) / 32;
      const int t0 = min(C, lane * per);
      const int t1 = min(C, t0 + per);
      double own = 0.0;
      for (int s = t0; s < t1; ++s) own += static_cast<double>(dts[s]) * a;
      double incl = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      double run = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) run = 0.0;
      for (int s = t0; s < t1; ++s) {
        run += static_cast<double>(dts[s]) * a;
        ack[s] = static_cast<float>(run);
      }
      __syncwarp();
      const float alast = ack[C - 1];
      for (int s = lane; s < Cp; s += 32) {
        if (s >= C) ack[s] = alast;  // padded rows: finite exponents, never stored
        const float cf = s < C ? dts[s] * expf(alast - ack[s]) : 0.f;
        coef[s] = cf;
        if (band == 0 && s < C) {
          ack_out[(tok0 + s) * H + h] = ack[s];
          coef_out[(tok0 + s) * H + h] = cf;
        }
      }
    }
    __syncthreads();

    // ---- the warp's segments ------------------------------------------------
    float acc[kN8][4];  // dx[s, p] of the segment's rows
    float cq_a = 0.f, cq_b = 0.f;  // sum over t of q[t, s], rows sa and sb
    int sa = 0, sb = 0;
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      if (SEG_N(k) == 0) continue;
      const int sj = slot_tile(SEG_SLOT(k), nt);
      const int s0 = sj * 16;
      sa = s0 + g;
      sb = sa + 8;
      // x's rows sa, sb of head h as A fragments over p: held through the
      // segment, or at P = 128 (where they and dx's accumulators would not
      // fit the registers together) read again, from L1, where they are used
      const bf16* xra = sa < C ? x + (tok0 + sa) * x_rs + h * P : nullptr;
      const bf16* xrb = sb < C ? x + (tok0 + sb) * x_rs + h * P : nullptr;
      auto load_x = [&](uint32_t (&f)[kKP][4]) {
#pragma unroll
        for (int kk = 0; kk < kKP; ++kk) {
          const int p = kk * 16 + 2 * q;
          f[kk][0] = ld_pair(xra, p, P, true);
          f[kk][1] = ld_pair(xrb, p, P, true);
          f[kk][2] = ld_pair(xra, p + 8, P, true);
          f[kk][3] = ld_pair(xrb, p + 8, P, true);
        }
      };
      constexpr bool kHoldX = P < 128;
      uint32_t xa[kHoldX ? kKP : 1][4];
      if constexpr (kHoldX) load_x(xa);
#pragma unroll
      for (int j = 0; j < kN8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      cq_a = cq_b = 0.f;
      if constexpr (CONTRIB) {
        if (k == 0) {  // the segment that stores its rows' dx: G's term
          // G = B dcontrib^T into acc, dcoef = x . G, then dx starts at coef G
          const bf16* ba = sa < C ? Bm + (tok0 + sa) * b_rs : nullptr;
          const bf16* bb = sb < C ? Bm + (tok0 + sb) * b_rs : nullptr;
          const int gp = stage_pitch(N);
#pragma unroll 1
          for (int kk = 0; kk < n16; ++kk) {  // one k16 step's operands live at a time
            const int n = kk * 16 + 2 * q;
            const uint32_t a[4] = {ld_pair(ba, n, N, b_pair), ld_pair(bb, n, N, b_pair),
                                   ld_pair(ba, n + 8, N, b_pair), ld_pair(bb, n + 8, N, b_pair)};
            // B operand (k = n, n = p): the head's dcontrib rows p by ldmatrix
            if constexpr (P == 8) {
              uint32_t b[2];
              ldmatrix_x2(b, Gs + (lane & 7) * gp + kk * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(acc[0], a, b);
            } else {
#pragma unroll
              for (int j = 0; j < kN8; j += 2) {
                uint32_t b[4];
                ldmatrix_x4(b, Gs + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * gp + kk * 16 +
                                   ((lane >> 3) & 1) * 8);
                mma_bf16(acc[j], a, b);
                mma_bf16(acc[j + 1], a, b + 2);
              }
            }
          }
          float da_ = 0.f, db_ = 0.f;
          uint32_t xg[kKP][4];
          if constexpr (kHoldX) {
#pragma unroll
            for (int kk = 0; kk < kKP; ++kk)
#pragma unroll
              for (int r = 0; r < 4; ++r) xg[kk][r] = xa[kk][r];
          } else {
            load_x(xg);
          }
#pragma unroll
          for (int j = 0; j < kN8; ++j) {
            const float2 xr = unpack(xg[j >> 1][(j & 1) * 2]);
            const float2 xs = unpack(xg[j >> 1][(j & 1) * 2 + 1]);
            da_ = fmaf(xr.x, acc[j][0], da_);
            da_ = fmaf(xr.y, acc[j][1], da_);
            db_ = fmaf(xs.x, acc[j][2], db_);
            db_ = fmaf(xs.y, acc[j][3], db_);
          }
          da_ += __shfl_xor_sync(0xffffffffu, da_, 1);
          da_ += __shfl_xor_sync(0xffffffffu, da_, 2);
          db_ += __shfl_xor_sync(0xffffffffu, db_, 1);
          db_ += __shfl_xor_sync(0xffffffffu, db_, 2);
          if (q == 0) {
            if (sa < C) dcoef[head * C + sa] = da_;
            if (sb < C) dcoef[head * C + sb] = db_;
          }
          const float ca = coef[sa];
          const float cb = coef[sb];
#pragma unroll
          for (int j = 0; j < kN8; ++j) {
            acc[j][0] *= ca;
            acc[j][1] *= ca;
            acc[j][2] *= cb;
            acc[j][3] *= cb;
          }
        }
      }

      // ---- per (s, t) tile: dW^T, W^T, q, the dCB^T term, dx += W^T dy ----
      const float asa = ack[sa];
      const float asb = ack[sb];
      const float dta = dts[sa];
      const float dtb = dts[sb];
      float* rowp = rowpart + (warp + kMmaWarps * k) * Cp;
      for (int i = SEG_I0(k); i < SEG_I0(k) + SEG_N(k); ++i) {
        const int t0 = i * 16;
        float* cbp = cbt + (SEG_PB(k) + i - sj) * kTileFloats;
        float* dcp = dcbt + (SEG_PB(k) + i - sj) * kTileFloats;
        // only the diagonal tile and the tiles past C mask
        const bool edge = i == sj || t0 + 16 > C || s0 + 16 > C;
        // the tile's two halves of 8 t each, one at a time (its state alone
        // held in registers): dW^T's n8 half, the half of the C.B^T and
        // dCB^T tiles, and dx += W^T dy over this k8 half (m16n8k8)
#pragma unroll 1
        for (int j = 0; j < 2; ++j) {
          const int th = t0 + j * 8;
          float dw[4] = {0.f, 0.f, 0.f, 0.f};
          {
            uint32_t xh[kKP][4];
            if constexpr (kHoldX) {
#pragma unroll
              for (int kk = 0; kk < kKP; ++kk)
#pragma unroll
                for (int r = 0; r < 4; ++r) xh[kk][r] = xa[kk][r];
            } else {
              load_x(xh);
            }
#pragma unroll
            for (int kk = 0; kk < kKP; ++kk) {
              uint32_t b[2];
              ldmatrix_x2(b, Dy + (th + (lane & 7)) * kDs + kk * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(dw, xh[kk], b);
            }
          }
          const float4 cv = *reinterpret_cast<const float4*>(cbp + (j * 32 + lane) * 4);
          float4 dv = *reinterpret_cast<const float4*>(dcp + (j * 32 + lane) * 4);
          const float cbv[4] = {cv.x, cv.y, cv.z, cv.w};
          float dcb[4] = {dv.x, dv.y, dv.z, dv.w};
          const int t = th + 2 * q;
          const float2 at = *reinterpret_cast<const float2*>(ack + t);
          float w[4], qv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = c < 2 ? sa : sb;
            const int tt = t + (c & 1);
            float ww = 0.f, qq = 0.f;
            if (!edge || (tt >= s && tt < C && s < C)) {
              const float l = expf(((c & 1) ? at.y : at.x) - (c < 2 ? asa : asb));
              const float ds = c < 2 ? dta : dtb;
              const float cl = cbv[c] * l;
              ww = cl * ds;
              qq = dw[c] * cl;
              dcb[c] = fmaf(dw[c] * l, ds, dcb[c]);
            }
            w[c] = ww;
            qv[c] = qq;
          }
          *reinterpret_cast<float4*>(dcp + (j * 32 + lane) * 4) =
              make_float4(dcb[0], dcb[1], dcb[2], dcb[3]);
          cq_a += qv[0] + qv[1];
          cq_b += qv[2] + qv[3];
          // q dt_s summed over the tile's 16 rows (lanes of one q), in order
          float c0 = fmaf(qv[0], dta, qv[2] * dtb);
          float c1 = fmaf(qv[1], dta, qv[3] * dtb);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            c0 += __shfl_xor_sync(0xffffffffu, c0, o);
            c1 += __shfl_xor_sync(0xffffffffu, c1, o);
          }
          if (g == 0) *reinterpret_cast<float2*>(rowp + t) = make_float2(c0, c1);
          // dx += W^T dy over t in [th, th + 8): A = W^T (hi + lo, rows g and
          // g + 8), B = dy's rows by ldmatrix.trans, one n8 tile of p each
          uint32_t wh[2], wl[2];
          split_hi_lo(w[0], w[1], wh[0], wl[0]);
          split_hi_lo(w[2], w[3], wh[1], wl[1]);
          if constexpr (P >= 32) {
#pragma unroll
            for (int p0 = 0; p0 < P; p0 += 32) {
              uint32_t yb[4];
              ldmatrix_x4_trans(yb, Dy + (th + (lane & 7)) * kDs + p0 + (lane >> 3) * 8);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                mma_bf16_k8(acc[p0 / 8 + e], wh, yb[e]);
                mma_bf16_k8(acc[p0 / 8 + e], wl, yb[e]);
              }
            }
          } else if constexpr (P == 16) {
            uint32_t yb[2];
            ldmatrix_x2_trans(yb, Dy + (th + (lane & 7)) * kDs + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              mma_bf16_k8(acc[e], wh, yb[e]);
              mma_bf16_k8(acc[e], wl, yb[e]);
            }
          } else {
            uint32_t yb;
            ldmatrix_x1_trans(yb, Dy + (th + (lane & 7)) * kDs);
            mma_bf16_k8(acc[0], wh, yb);
            mma_bf16_k8(acc[0], wl, yb);
          }
        }
      }
      const bool whole = (warp >= 4 && k == 0) || (warp < 4 && !takes_merge);
      if (whole) store_rows<P>(acc, cq_a, cq_b, sa, sb, C, H, h, tok0, head, dx, colq, q);
    }
    __syncthreads();  // every pair done: Dy is free for the hand-over
    if (gives_merge) {  // the long tile's last pairs, to warp u
      float* m = mbuf + (warp & 3) * kMerge;
#pragma unroll
      for (int j = 0; j < kN8; ++j)
        *reinterpret_cast<float4*>(m + (j * 32 + lane) * 4) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      *reinterpret_cast<float2*>(m + kN8 * 128 + 2 * lane) = make_float2(cq_a, cq_b);
    }
    __syncthreads();
    if (takes_merge) {  // this warp's pairs first, then warp u + 4's
      const float* m = mbuf + warp * kMerge;
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(m + (j * 32 + lane) * 4);
        acc[j][0] += v.x;
        acc[j][1] += v.y;
        acc[j][2] += v.z;
        acc[j][3] += v.w;
      }
      const float2 cv = *reinterpret_cast<const float2*>(m + kN8 * 128 + 2 * lane);
      store_rows<P>(acc, cq_a + cv.x, cq_b + cv.y, sa, sb, C, H, h, tok0, head, dx, colq, q);
    }
    // ---- q dt_s summed over the band's s, in segment order -----------------
    for (int t = tid; t < C; t += kMmaThreads) {
      float v = 0.f;
      const int ti = t >> 4;
      for (int r = 0; r < 2 * kMmaWarps; ++r) {
        int sl, i0, n;
        unit_segment(band, nt, r & 7, r >> 3, sl, i0, n);
        if (n > 0 && ti >= i0 && ti < i0 + n) v += rowpart[r * Cp + t];
      }
      rowqd[((band * BC + bc) * H + h) * C + t] = v;
    }
  }

  // ---- the group's dCB^T of the warp's tiles, stored [s][t] ---------------
  float* part = dcb_part + (static_cast<long long>(grp) * BC + bc) * C * C;
  for (int k = 0; k < 2; ++k) {
    const int sj = slot_tile(SEG_SLOT(k), nt);
    const int sa_ = sj * 16 + g;
    const int sb_ = sa_ + 8;
    for (int i = SEG_I0(k); i < SEG_I0(k) + SEG_N(k); ++i) {
      float v[2][4];
      tile_load(dcbt + (SEG_PB(k) + i - sj) * kTileFloats, lane, v);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = c < 2 ? sa_ : sb_;
          const int t = i * 16 + j * 8 + 2 * q + (c & 1);
          if (s < C && t < C) part[static_cast<long long>(s) * C + t] = v[j][c];
        }
    }
  }
#undef SEG_SLOT
#undef SEG_I0
#undef SEG_N
#undef SEG_PB
}

// the contrib term's split of its depth H P: enough blocks of 64 rows x 128
// columns to reach kCbBlocks, each range a multiple of kCbK
__host__ __device__ inline int contrib_splits(long long BC, int C, int HP, int N) {
  const long long base = BC * ((C + kCbRows - 1) / kCbRows) * ((N + kDbcCols - 1) / kDbcCols);
  long long ks = (kCbBlocks + base - 1) / base;
  const long long slabs = (HP + kCbK - 1) / kCbK;
  return static_cast<int>(ks < 1 ? 1 : ks > slabs ? slabs : ks);
}

// 2. With dcontrib, first the contrib term of dB, sum_{h, p} coef x
// dcontrib, as a GEMM of 64 x 128 blocks over KS ranges of its depth H P
// (dcontrib staged in shared memory as bf16 32 rows at a time, the next slab's
// loads in flight during this one's products), each range's partial to
// scratch; then the groups' dCB^T summed in group order, one element a
// thread; then the per-(chunk, head) finish, one warp each (lanes over t,
// the reverse cumulative sum a shuffle scan in a fixed order).
__global__ void __launch_bounds__(kDbcThreads, 1)
ssd_bwd_sum_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm, const float* __restrict__ dt,
                       const float* __restrict__ A, const float* __restrict__ dcon,
                       const float* __restrict__ ddecay, const float* __restrict__ ack,
                       const float* __restrict__ coef, const float* __restrict__ colq,
                       const float* __restrict__ dcoef, const float* __restrict__ rowqd,
                       const float* __restrict__ dcb_part, float* __restrict__ dcb,
                       float* __restrict__ ddt, float* __restrict__ da_part,
                       float* __restrict__ db_part, long long BC, int C, int H, int P, int N,
                       int HG, int NB, int KS, long long x_rs, int x_vec) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int nt = (C + 15) / 16;
  const int nh = (N + kDbcCols - 1) / kDbcCols;
  const int HP = H * P;
  const int nmb = (C + kCbRows - 1) / kCbRows;
  const long long n_cb = dcon != nullptr ? BC * nmb * nh * KS : 0;

  if (blockIdx.x < n_cb) {
    __shared__ __align__(16) bf16 Bs[kCbK][kCbPitch];
    __shared__ __align__(16) bf16 As[kCbRows][kCbK + 8];
    long long idx = blockIdx.x;
    const int ks = static_cast<int>(idx % KS);
    idx /= KS;
    const int hh = static_cast<int>(idx % nh);
    idx /= nh;
    const int mb = static_cast<int>(idx % nmb);
    const long long bc = idx / nmb;
    const long long tok0 = bc * C;
    const int n0 = hh * kDbcCols;
    const int per = ((HP + KS - 1) / KS + kCbK - 1) / kCbK * kCbK;
    const int k_lo = ks * per;
    const int k_hi = min(HP, k_lo + per);
    const int ra = mb * kCbRows + (threadIdx.x >> 5) * 16 + g;
    const int rb = ra + 8;
    const float* dc0 = dcon + bc * static_cast<long long>(HP) * N;
    const bool vec = N % 4 == 0;
    // the A tile: (coef x)[s, hp .. hp + 8), rounded once to bf16, 8 a chunk
    constexpr int kAPer = kCbRows * kCbK / 8 / kDbcThreads;  // chunks a thread a slab
    uint4 xpre[kAPer];
    float cpre[kAPer];
    auto fetch_a = [&](int k0) {
#pragma unroll
      for (int u = 0; u < kAPer; ++u) {
        const int c = threadIdx.x + u * kDbcThreads;
        const int r = c / (kCbK / 8);
        const int hp = k0 + (c - r * (kCbK / 8)) * 8;
        const int s_ = mb * kCbRows + r;
        xpre[u] = make_uint4(0u, 0u, 0u, 0u);
        cpre[u] = 0.f;
        if (s_ < C && hp < k_hi) {
          const bf16* src = x + (tok0 + s_) * x_rs + hp;
          if (x_vec) {
            xpre[u] = *reinterpret_cast<const uint4*>(src);
          } else {
            uint32_t* w = reinterpret_cast<uint32_t*>(&xpre[u]);
#pragma unroll
            for (int e = 0; e < 4; ++e) w[e] = *reinterpret_cast<const uint32_t*>(src + 2 * e);
          }
          cpre[u] = coef[(tok0 + s_) * H + hp / P];
        }
      }
    };
    constexpr int kPer = kCbK * kDbcCols / 4 / kDbcThreads;  // float4 a thread a slab
    float4 pre[kPer];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int it = threadIdx.x + u * kDbcThreads;
        const int r = it / (kDbcCols / 4);
        const int n = n0 + (it - r * (kDbcCols / 4)) * 4;
        const int hp = k0 + r;
        const float* src = dc0 + static_cast<long long>(hp) * N + n;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (hp < k_hi) {
          if (vec && n < N) {
            v = *reinterpret_cast<const float4*>(src);
          } else {
            v.x = n < N ? src[0] : 0.f;
            v.y = n + 1 < N ? src[1] : 0.f;
            v.z = n + 2 < N ? src[2] : 0.f;
            v.w = n + 3 < N ? src[3] : 0.f;
          }
        }
        pre[u] = v;
      }
    };
    float acc[kDbcCols / 8][4];
#pragma unroll
    for (int j = 0; j < kDbcCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (k_lo < k_hi) {
      fetch(k_lo);
      fetch_a(k_lo);
    }
    for (int k0 = k_lo; k0 < k_hi; k0 += kCbK) {
      __syncthreads();  // the slab before is consumed
#pragma unroll
      for (int u = 0; u < kAPer; ++u) {
        const int c = threadIdx.x + u * kDbcThreads;
        const int r = c / (kCbK / 8);
        const int cc = (c - r * (kCbK / 8)) * 8;
        float xv[8];
        unpack8(xpre[u], xv);
        *reinterpret_cast<uint4*>(&As[r][cc]) =
            make_uint4(pack_bf16(cpre[u] * xv[0], cpre[u] * xv[1]),
                       pack_bf16(cpre[u] * xv[2], cpre[u] * xv[3]),
                       pack_bf16(cpre[u] * xv[4], cpre[u] * xv[5]),
                       pack_bf16(cpre[u] * xv[6], cpre[u] * xv[7]));
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int it = threadIdx.x + u * kDbcThreads;
        const int r = it / (kDbcCols / 4);
        const int c = (it - r * (kDbcCols / 4)) * 4;
        *reinterpret_cast<uint2*>(&Bs[r][c]) =
            make_uint2(pack_bf16(pre[u].x, pre[u].y), pack_bf16(pre[u].z, pre[u].w));
      }
      __syncthreads();
      if (k0 + kCbK < k_hi) {
        fetch(k0 + kCbK);
        fetch_a(k0 + kCbK);
      }
#pragma unroll
      for (int kk = 0; kk < kCbK / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, &As[(threadIdx.x >> 5) * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int j = 0; j < kDbcCols / 8; j += 2) {
          uint32_t yb[4];
          ldmatrix_x4_trans(yb, &Bs[kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][j * 8 + (lane >> 4) * 8]);
          mma_bf16(acc[j], a, yb);
          mma_bf16(acc[j + 1], a, yb + 2);
        }
      }
    }
    float* out = db_part + (static_cast<long long>(ks) * BC + bc) * C * N;
#pragma unroll
    for (int j = 0; j < kDbcCols / 8; ++j) {
      const int n = n0 + j * 8 + 2 * q;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c < 2 ? ra : rb;
        const int nn = n + (c & 1);
        if (r < C && nn < N) out[static_cast<long long>(r) * N + nn] = acc[j][c];
      }
    }
    return;
  }

  // ---- dCB^T summed over the groups in order, one element a thread ------
  const long long n_el = BC * C * C;
  const long long n_sum = (n_el + kDbcThreads - 1) / kDbcThreads;
  if (blockIdx.x < n_cb + n_sum) {
    const long long e = (blockIdx.x - n_cb) * kDbcThreads + threadIdx.x;
    if (e >= n_el) return;
    const long long st = e % (static_cast<long long>(C) * C);
    const int s_ = static_cast<int>(st / C);
    const int t_ = static_cast<int>(st - static_cast<long long>(s_) * C);
    float v = 0.f;
    if (t_ >= s_) {
      const float* p = dcb_part + e;
      for (int g0 = 0; g0 < HG; g0 += 8) {  // 8 loads in flight, added in order
        float u[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) u[k] = g0 + k < HG ? p[(g0 + k) * n_el] : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) v += u[k];
      }
    }
    dcb[e] = v;
    return;
  }

  // ---- the finish: one warp per (chunk, head), lanes over t ---------------
  const long long head = (blockIdx.x - n_cb - n_sum) * (kDbcThreads / 32) + (threadIdx.x >> 5);
  if (head >= BC * H) return;
  const long long bc = head / H;
  const int h = static_cast<int>(head - bc * H);
  const float* cq = colq + head * C;
  const float* dco = dcon != nullptr ? dcoef + head * C : nullptr;
  const float last = ack[(bc * C + C - 1) * H + h];
  const float a = A[h];
  constexpr int kPer = kMaxC / 32;  // t a lane at most
  const int per = (C + 31) / 32;
  const int t_lo = lane * per;
  // sum_s dcoef coef: the lanes' sums, then a butterfly in a fixed order
  float ex = 0.f;
  if (dco != nullptr)
    for (int k = 0; k < per; ++k) {
      const int t = t_lo + k;
      if (t < C) ex = fmaf(dco[t], coef[(bc * C + t) * H + h], ex);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ex += __shfl_xor_sync(0xffffffffu, ex, o);
  const float extra = (ddecay != nullptr ? ddecay[head] * expf(last) : 0.f) + ex;
  float dac[kPer];
  float own = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int t = t_lo + k;
    dac[k] = 0.f;
    if (k < per && t < C) {
      float rq = 0.f;
      for (int b = 0; b < NB; ++b) rq += rowqd[((b * BC + bc) * H + h) * C + t];
      const long long o = (bc * C + t) * H + h;
      const float dc = dco != nullptr ? dco[t] : 0.f;
      float d_ack = rq - dt[o] * cq[t] - dc * coef[o];
      if (t == C - 1) d_ack += extra;
      dac[k] = d_ack;
      own += d_ack;
    }
  }
  // the later lanes' sums: an inclusive suffix scan, shifted by one lane
  float suf = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, suf, o);
    if (lane + o < 32) suf += v;
  }
  float dz = __shfl_down_sync(0xffffffffu, suf, 1);
  if (lane == 31) dz = 0.f;
  float da = 0.f;
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k) {
    const int t = t_lo + k;
    if (k < per && t < C) {
      const long long o = (bc * C + t) * H + h;
      const float dc = dco != nullptr ? dco[t] : 0.f;
      dz += dac[k];
      ddt[o] = cq[t] + dc * expf(last - ack[o]) + dz * a;
      da = fmaf(dz, dt[o], da);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  if (lane == 0) da_part[head] = da;
}

// 3. dB and dC: one block per (chunk, 16 rows) of each, dCB^T's tile rows
// in shared memory (split hi + lo for the products, the 4 warps taking every
// 4th n8 column tile), dB adding the contrib ranges in order; and one more
// block for dA[h], summed over (batch, chunk) in order.
__global__ void __launch_bounds__(kDbcThreads, 1)
ssd_bwd_dbc_mma_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                       const float* __restrict__ dcb, const float* __restrict__ db_part,
                       const float* __restrict__ da_part, bf16* __restrict__ dB,
                       bf16* __restrict__ dC, float* __restrict__ dA, long long BC, int C, int H,
                       int N, int KS, long long b_rs, long long c_rs, int b_vec, int c_vec) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int nt = (C + 15) / 16;
  const long long n_tiles = 2 * BC * nt;  // dB then dC, per (chunk, 16 rows)
  if (blockIdx.x < n_tiles) {
    // dCB^T's rows (dB) or columns (dC) of this tile into shared memory:
    // S[r][k] = A[m = r][k] of the product
    __shared__ __align__(16) float S[16][kMaxC + 8];
    const long long idx = blockIdx.x;
    const bool is_b = idx < BC * nt;
    const long long id2 = is_b ? idx : idx - BC * nt;
    const int ti = static_cast<int>(id2 % nt);
    const long long bc = id2 / nt;
    const long long tok0 = bc * C;
    const int m0 = ti * 16;
    const float* part = dcb + bc * C * C;
    // dB: rows s = m0 + r over t in [m0, C); dC: rows t = m0 + r over s in [0, m0 + 16)
    const int k_lo = is_b ? m0 : 0;
    const int k_hi = is_b ? round16(C) : m0 + 16;
    const int kw = k_hi - k_lo;
    // the B operand's rows [k_lo, k_hi) (C's for dB, B's for dC), by cp.async
    extern __shared__ __align__(16) unsigned char dbc_raw[];
    bf16* Ms = reinterpret_cast<bf16*>(dbc_raw);
    const int ps = stage_pitch(N);
    stage_rows(Ms, is_b ? Cm : Bm, tok0, is_b ? c_rs : b_rs, C, N, k_lo, k_hi, ps,
               is_b ? c_vec : b_vec);
    cp_async_commit();
    for (int e = threadIdx.x; e < 16 * kw; e += kDbcThreads) {
      int r, k;
      if (is_b) {
        r = e / kw;
        k = k_lo + (e - r * kw);
      } else {
        k = e / 16;
        r = e - k * 16;
      }
      const int s_ = is_b ? m0 + r : k;
      const int t_ = is_b ? k : m0 + r;
      S[r][k] = s_ < C && t_ < C ? part[static_cast<long long>(s_) * C + t_] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    const int n8 = (N + 7) / 8;
    constexpr int kJ = kMaxN / 8 / (kDbcThreads / 32);  // n8 tiles a warp at most
    float acc[kJ][4];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
    for (int k0 = k_lo; k0 < k_hi; k0 += 16) {
      const int kq = k0 + 2 * q;
      uint32_t ahi[4], alo[4];
      {
        const float2 v0 = *reinterpret_cast<const float2*>(&S[g][kq]);
        const float2 v1 = *reinterpret_cast<const float2*>(&S[g + 8][kq]);
        const float2 v2 = *reinterpret_cast<const float2*>(&S[g][kq + 8]);
        const float2 v3 = *reinterpret_cast<const float2*>(&S[g + 8][kq + 8]);
        split_hi_lo(v0.x, v0.y, ahi[0], alo[0]);
        split_hi_lo(v1.x, v1.y, ahi[1], alo[1]);
        split_hi_lo(v2.x, v2.y, ahi[2], alo[2]);
        split_hi_lo(v3.x, v3.y, ahi[3], alo[3]);
      }
      // n8 tiles 2 jp and 2 jp + 1 of warp's pairs jp = warp, warp + 4, ...
#pragma unroll
      for (int m = 0; m < kJ / 2; ++m) {
        const int jp = warp + m * (kDbcThreads / 32);
        if (2 * jp < n8) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Ms + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ps + jp * 16 +
                                   (lane >> 4) * 8);
          mma_bf16(acc[2 * m], ahi, b);
          mma_bf16(acc[2 * m], alo, b);
          mma_bf16(acc[2 * m + 1], ahi, b + 2);
          mma_bf16(acc[2 * m + 1], alo, b + 2);
        }
      }
    }
    // dB adds the contrib term's ranges, in order
    bf16* out = (is_b ? dB : dC) + tok0 * N;
    const float* cpart = is_b && KS > 0 ? db_part + tok0 * N : nullptr;
    const long long n_db = BC * C * N;
    const int ra = m0 + g;
    const int rb = ra + 8;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int j = 2 * (warp + (jj >> 1) * (kDbcThreads / 32)) + (jj & 1);
      if (j < n8) {
        const int n = j * 8 + 2 * q;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c < 2 ? ra : rb;
          const int nn = n + (c & 1);
          if (r < C && nn < N) {
            const long long o = static_cast<long long>(r) * N + nn;
            float v = acc[jj][c];
            if (cpart != nullptr)
              for (int k = 0; k < KS; ++k) v += cpart[k * n_db + o];
            out[o] = __float2bfloat16(v);
          }
        }
      }
    }
    return;
  }

  for (int h = threadIdx.x; h < H; h += kDbcThreads) {
    float v = 0.f;
    for (long long bc = 0; bc < BC; ++bc) v += da_part[bc * H + h];
    dA[h] = v;
  }
}

// Offsets (floats) of the tensor-core design's scratch.
struct MmaScratch {
  long long ack, coef, colq, dcoef, rowqd, dcb_part, dcb, da_part, db_part, total;
};

// KS: the contrib term's depth ranges, 0 without dcontrib
__host__ __device__ inline MmaScratch mma_scratch_layout(long long BC, int C, int H, int N,
                                                         int HG, int KS) {
  const int NB = (round16(C) / 16 + kBandTiles - 1) / kBandTiles;
  MmaScratch s;
  s.ack = 0;
  s.coef = s.ack + BC * C * H;
  s.colq = s.coef + BC * C * H;
  s.dcoef = s.colq + BC * H * C;
  s.rowqd = s.dcoef + BC * H * C;
  s.dcb_part = s.rowqd + NB * BC * H * C;
  s.dcb = s.dcb_part + HG * BC * C * C;
  s.da_part = s.dcb + BC * C * C;
  s.db_part = s.da_part + BC * H;
  s.total = s.db_part + KS * BC * C * N;
  return s;
}

template <int P, int MINB, bool CONTRIB>
int launch_main(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
                const float* dy, const float* dcon, bf16* dx, float* scratch, const MmaScratch& o,
                long long BC, int C, int H, int N, int HG, int NB, int mp, size_t smem,
                long long x_rs, long long b_rs, long long c_rs, int b_pair, int b_vec,
                int c_vec, int both, cudaStream_t s) {
  static bool opted_in[64] = {};  // the 227 KB opt-in, once per device and instance
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= 64 || !opted_in[dev])) {
    const cudaError_t e = cudaFuncSetAttribute(ssd_bwd_main_mma_kernel<P, MINB, CONTRIB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kSmemMax));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) opted_in[dev] = true;
  }
  ssd_bwd_main_mma_kernel<P, MINB, CONTRIB>
      <<<dim3(HG * NB, static_cast<unsigned>(BC)), kMmaThreads, smem, s>>>(
      x, dt, A, Bm, Cm, dy, dcon, dx, scratch + o.ack, scratch + o.coef, scratch + o.colq,
      scratch + o.dcoef, scratch + o.rowqd, scratch + o.dcb_part, C, H, N, HG, NB, mp, x_rs,
      b_rs, c_rs, b_pair, b_vec, c_vec, both);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* xv, const float* dt, const float* A, const void* Bv, const void* Cv,
               const float* dy, const float* dcon, const float* ddec, void* dxv, float* ddt,
               float* dA, void* dBv, void* dCv, float* scratch, long long BC, int C, int H,
               int P, int N, int HG, size_t smem, long long x_rs, long long b_rs,
               long long c_rs, cudaStream_t s) {
  const bf16* x = static_cast<const bf16*>(xv);
  const bf16* Bm = static_cast<const bf16*>(Bv);
  const bf16* Cm = static_cast<const bf16*>(Cv);
  bf16* dx = static_cast<bf16*>(dxv);
  const int nt = round16(C) / 16;
  const int NB = (nt + kBandTiles - 1) / kBandTiles;
  const int mp = max_band_pairs(nt);
  const int KS = dcon != nullptr ? contrib_splits(BC, C, H * P, N) : 0;
  const MmaScratch o = mma_scratch_layout(BC, C, H, N, HG, KS);
  const int b_pair = b_rs % 2 == 0 && reinterpret_cast<uintptr_t>(Bm) % 4 == 0;
  const int b_vec = N % 8 == 0 && b_rs % 8 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0;
  const int c_vec = N % 8 == 0 && c_rs % 8 == 0 && reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  const int both = stage_b(C, P, N);
  // two blocks an SM (registers capped at 128) where two fit and dcontrib's
  // product is not in the kernel
  const bool contrib = dcon != nullptr;
  const bool two = !contrib && P <= 64 && 2 * (smem + 1024) <= 228 * 1024;
  int err;
#define SSD_MAIN(PP, MB, CT)                                                              \
  launch_main<PP, MB, CT>(x, dt, A, Bm, Cm, dy, dcon, dx, scratch, o, BC, C, H, N, HG, NB, \
                          mp, smem, x_rs, b_rs, c_rs, b_pair, b_vec, c_vec, both, s)
#define SSD_MAIN3(PP) \
  (contrib ? SSD_MAIN(PP, 1, true) : two ? SSD_MAIN(PP, 2, false) : SSD_MAIN(PP, 1, false))
  switch (P) {
    case 8: err = SSD_MAIN3(8); break;
    case 16: err = SSD_MAIN3(16); break;
    case 32: err = SSD_MAIN3(32); break;
    case 64: err = SSD_MAIN3(64); break;
    default: err = SSD_MAIN(128, 1, false); break;  // with dcontrib refused above
  }
#undef SSD_MAIN3
#undef SSD_MAIN
  if (err != 0) return err;
  const int nh = (N + kDbcCols - 1) / kDbcCols;
  const long long n_cb = KS > 0 ? BC * ((C + kCbRows - 1) / kCbRows) * nh * KS : 0;
  const long long n_sum = (BC * C * C + kDbcThreads - 1) / kDbcThreads;
  const long long n_fin = (BC * H + kDbcThreads / 32 - 1) / (kDbcThreads / 32);
  ssd_bwd_sum_mma_kernel<<<static_cast<unsigned>(n_cb + n_sum + n_fin), kDbcThreads, 0, s>>>(
      x, Bm, Cm, dt, A, dcon, ddec, scratch + o.ack, scratch + o.coef, scratch + o.colq,
      scratch + o.dcoef, scratch + o.rowqd, scratch + o.dcb_part, scratch + o.dcb, ddt,
      scratch + o.da_part, scratch + o.db_part, BC, C, H, P, N, HG, NB, KS, x_rs,
      x_rs % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the B operand's rows: at most all of the chunk's, pitch stage_pitch(N)
  const size_t smem3 = sizeof(bf16) * static_cast<size_t>(round16(C)) * stage_pitch(N);
  {
    static bool opted3[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (smem3 > 32 * 1024 && (dev >= 64 || !opted3[dev])) {
      const cudaError_t e3 = cudaFuncSetAttribute(
          ssd_bwd_dbc_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 160 * 1024);
      if (e3 != cudaSuccess) return static_cast<int>(e3);
      if (dev < 64) opted3[dev] = true;
    }
  }
  ssd_bwd_dbc_mma_kernel<<<static_cast<unsigned>(2 * BC * nt + 1), kDbcThreads, smem3, s>>>(
      Bm, Cm, scratch + o.dcb, scratch + o.db_part, scratch + o.da_part,
      static_cast<bf16*>(dBv), static_cast<bf16*>(dCv), dA, BC, C, H, N, KS, b_rs, c_rs, b_vec,
      c_vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the CUDA cores
// ---------------------------------------------------------------------------
template <typename T>
int launch_fma(const void* xv, const float* dt, const float* A, const void* Bv, const void* Cv,
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

// Floats of float32 scratch that `ssd_intra_chunk_bwd` needs for this shape
// and design (path 0 the CUDA cores, 1 the tensor cores with HG head groups,
// its contrib buffers only with dcontrib).
extern "C" long long ssd_intra_chunk_bwd_scratch(long long BC, int C, int H, int P, int N,
                                                 int path, int HG, int has_dcontrib) {
  if (path == 1)
    return mma_scratch_layout(BC, C, H, N, HG,
                              has_dcontrib ? contrib_splits(BC, C, H * P, N) : 0).total;
  return scratch_layout(BC, C, H, P, head_groups(BC, C, H)).total;
}

// Shared memory of one tensor-core main block (the launcher refuses any
// other count).
extern "C" long long ssd_intra_chunk_bwd_smem(int C, int P, int N, int contrib) {
  return static_cast<long long>(mma_smem_bytes(C, P, N, contrib != 0));
}

// x (BC, C, H, P), Bm / Cm (BC, C, N) as token rows with row strides x_rs,
// b_rs, c_rs (elements); dtype 0 = float32, 1 = bfloat16; dt (BC, C, H), A
// (H,) float32; dy (BC, C, H, P), dcontrib (BC, H, P, N), ddecay (BC, H)
// float32 or null; dx (BC, C, H, P), dB, dC (BC, C, N) contiguous in x's
// dtype; ddt (BC, C, H) and dA (H,) float32.  path 0 = the CUDA cores (x,
// Bm, Cm contiguous), 1 = the tensor cores (bfloat16, P >= 8, no dcontrib
// at P = 128, HG head groups
// in [1, H], `smem` = ssd_intra_chunk_bwd_smem(C, P, N, dcontrib != null); x rows 4-byte aligned,
// dy 16-byte aligned).  Returns cudaGetLastError() after the launches (or
// the error that refused one).
extern "C" int ssd_intra_chunk_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* Cm, const void* dy, const void* dcontrib,
                                   const void* ddecay, void* dx, void* ddt, void* dA, void* dB,
                                   void* dC, void* scratch, long long BC, int C, int H, int P,
                                   int N, int dtype, int path, int HG, long long smem,
                                   long long x_rs, long long b_rs, long long c_rs, void* stream) {
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
  if (path == 1) {
    const size_t need = mma_smem_bytes(C, P, N, dcontrib != nullptr);
    if (dtype != 1 || C > 256 || P < 8 || P > 128 || (P & (P - 1)) != 0 || HG < 1 || HG > H ||
        (P == 128 && dcontrib != nullptr) ||
        need > kSmemMax || static_cast<long long>(need) != smem || x_rs % 2 != 0 ||
        x_rs < static_cast<long long>(H) * P || b_rs < N || c_rs < N ||
        reinterpret_cast<uintptr_t>(x) % 4 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_mma(x, dtf, af, Bm, Cm, dyf, dcf, ddf, dx, static_cast<float*>(ddt),
                      static_cast<float*>(dA), dB, dC, sf, BC, C, H, P, N, HG, need, x_rs, b_rs,
                      c_rs, s);
  }
  if (path != 0 || x_rs != static_cast<long long>(H) * P || b_rs != N || c_rs != N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0)
    return launch_fma<float>(x, dtf, af, Bm, Cm, dyf, dcf, ddf, dx, static_cast<float*>(ddt),
                             static_cast<float*>(dA), dB, dC, sf, BC, C, H, P, N, s);
  if (dtype == 1)
    return launch_fma<__nv_bfloat16>(x, dtf, af, Bm, Cm, dyf, dcf, ddf, dx,
                                     static_cast<float*>(ddt), static_cast<float*>(dA), dB, dC,
                                     sf, BC, C, H, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
