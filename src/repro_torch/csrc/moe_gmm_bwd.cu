// Backward of the MoE grouped matmul (csrc/moe_gmm.cu) for Hopper (sm_90a).
//
// Replaces the gradient that the reference takes by differentiating its
// expert FFN (`_expert_compute` in src/repro/models/moe.py, whose einsums
// compute what the TPU kernel `moe_gmm` in src/repro/kernels/moe_gmm.py
// computes; the Pallas kernel itself has no VJP).  For every expert e, with
// dy the gradient of out[e]:
//
//   h = x wg,  u = x wu,  g = dy wd^T                  (recomputed, float32)
//   a = cast(silu(h) u, wd.dtype)                      (as the forward forms it)
//   dh = g u silu'(h),  du = g silu(h)
//   dx = dh wg^T + du wu^T,  dwg = x^T dh,  dwu = x^T du,  dwd = a^T dy
//
// x, dy: (E, C, D); wg, wu: (E, D, F); wd: (E, F, D); one dtype (float32
// or bfloat16), contiguous; the gradients in that dtype.  Scratch: a, dh
// and du, (E, C, F) float32 each, from the caller.
//
// Bound on this card: at granite-moe-1b's train shape (E 32, C 320, D 1024,
// F 512, bf16) the nine products are 86 GFLOP and the bytes ~0.25 GB, so
// the work bounds it (0.087 ms at the bf16 tensor-core rate).  This first
// design runs every product on the CUDA cores in float32 through
// `bwd::tile_product` (64 x 64 output tiles, 256 threads): three launches,
// (1) h, u and g per (bucket rows, F columns) tile with the elementwise
// part in the epilogue, (2) dx per (bucket rows, D columns) tile, the two
// products summed in one register tile, (3) the three weight gradients per
// weight tile, each summed over all C bucket rows inside one block.  No
// output is reduced across blocks, so there are no atomics and no partial
// sums: every gradient is a fixed-order float32 sum and a resumed step
// repeats bit for bit.  Shared memory is one tile's slabs (8.3 KB),
// whatever D and F are, so deepseek-v2's experts (D 5120, F 1536) launch as
// granite's do.  Moving the products onto mma.sync / wgmma is ROADMAP
// queue B.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_tile.cuh"

namespace {

using bwd::kBM;
using bwd::kBN;
using bwd::kT;
using bwd::tile_col;
using bwd::tile_row;
using bwd::to_f;

// (1) per (F tile, C tile, expert): h, u, g; then a, dh, du (float32).
template <typename T>
__global__ void __launch_bounds__(kT)
moe_bwd_hidden_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                      const T* __restrict__ wu, const T* __restrict__ wd,
                      const T* __restrict__ dy, float* __restrict__ a_out,
                      float* __restrict__ dh_out, float* __restrict__ du_out, int C, int D,
                      int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const long long e = blockIdx.z;
  const int c0 = blockIdx.y * kBM;
  const int f0 = blockIdx.x * kBN;
  const T* xe = x + e * C * D;
  const T* dye = dy + e * C * D;
  const T* wge = wg + e * D * F;
  const T* wue = wu + e * D * F;
  const T* wde = wd + e * F * D;

  auto rows = [&](const T* m) {
    return [=](int c, int d) { return c < C ? to_f(m[static_cast<long long>(c) * D + d]) : 0.f; };
  };
  auto cols = [&](const T* w) {  // w[d][f] as B(k = d, n = f)
    return [=](int d, int f) { return f < F ? to_f(w[static_cast<long long>(d) * F + f]) : 0.f; };
  };
  auto wd_t = [=](int d, int f) {  // wd[f][d] as B(k = d, n = f)
    return f < F ? to_f(wde[static_cast<long long>(f) * D + d]) : 0.f;
  };
  float h[4][4], u[4][4], g[4][4];
  bwd::zero(h);
  bwd::zero(u);
  bwd::zero(g);
  bwd::tile_product<true, true>(h, sm, c0, f0, D, rows(xe), cols(wge));
  bwd::tile_product<true, true>(u, sm, c0, f0, D, rows(xe), cols(wue));
  bwd::tile_product<true, false>(g, sm, c0, f0, D, rows(dye), wd_t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tile_row(i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tile_col(j);
      if (c >= C || f >= F) continue;
      const float hv = h[i][j];
      const float sig = 1.f / (1.f + expf(-hv));
      const float sh = hv / (1.f + expf(-hv));          // silu(h), as the forward forms it
      const long long o = (e * C + c) * F + f;
      a_out[o] = to_f(bwd::from_f<T>(__fmul_rn(sh, u[i][j])));  // a.astype(wd.dtype)
      dh_out[o] = g[i][j] * u[i][j] * (sig * (1.f + hv * (1.f - sig)));
      du_out[o] = g[i][j] * sh;
    }
  }
}

// (2) per (D tile, C tile, expert): dx = dh wg^T + du wu^T.
template <typename T>
__global__ void __launch_bounds__(kT)
moe_bwd_dx_kernel(const float* __restrict__ dh, const float* __restrict__ du,
                  const T* __restrict__ wg, const T* __restrict__ wu, T* __restrict__ dx,
                  int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const long long e = blockIdx.z;
  const int c0 = blockIdx.y * kBM;
  const int d0 = blockIdx.x * kBN;
  auto hid = [&](const float* m) {  // (C, F) rows as A(m = c, k = f)
    const float* me = m + e * C * F;
    return [=](int c, int f) { return c < C ? me[static_cast<long long>(c) * F + f] : 0.f; };
  };
  auto w_t = [&](const T* w) {  // w[d][f] as B(k = f, n = d)
    const T* we = w + e * D * F;
    return [=](int f, int d) { return d < D ? to_f(we[static_cast<long long>(d) * F + f]) : 0.f; };
  };
  float acc[4][4];
  bwd::zero(acc);
  bwd::tile_product<true, false>(acc, sm, c0, d0, F, hid(dh), w_t(wg));
  bwd::tile_product<true, false>(acc, sm, c0, d0, F, hid(du), w_t(wu));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tile_row(i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tile_col(j);
      if (c < C && d < D) dx[(e * C + c) * D + d] = bwd::from_f<T>(acc[i][j]);
    }
  }
}

// (3) per (weight tile, which, expert): dwg = x^T dh and dwu = x^T du
// (which 0, 1: rows d, columns f), dwd = a^T dy (which 2: rows f, columns
// d); the sum over the C bucket rows stays inside the block.
template <typename T>
__global__ void __launch_bounds__(kT)
moe_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ a, const float* __restrict__ dh,
                  const float* __restrict__ du, T* __restrict__ dwg, T* __restrict__ dwu,
                  T* __restrict__ dwd, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const long long e = blockIdx.z;
  const int which = blockIdx.y;
  const int M = which < 2 ? D : F;   // rows of this weight
  const int N = which < 2 ? F : D;   // its columns
  const int nt = (N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / nt) * kBM;
  const int n0 = (blockIdx.x % nt) * kBN;
  // A(m, k = c) = left[c][m] (m contiguous), B(k = c, n) = right[c][n]
  auto lf = [&](int m, int c) -> float {
    if (m >= M) return 0.f;
    return which < 2 ? to_f(x[(e * C + c) * D + m]) : a[(e * C + c) * F + m];
  };
  auto rt = [&](int c, int n) -> float {
    if (n >= N) return 0.f;
    if (which == 2) return to_f(dy[(e * C + c) * D + n]);
    return (which == 0 ? dh : du)[(e * C + c) * F + n];
  };
  float acc[4][4];
  bwd::zero(acc);
  bwd::tile_product<false, true>(acc, sm, m0, n0, C, lf, rt);
  T* out = (which == 0 ? dwg : which == 1 ? dwu : dwd) + e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tile_row(i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tile_col(j);
      if (m < M && n < N) out[static_cast<long long>(m) * N + n] = bwd::from_f<T>(acc[i][j]);
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, const void* dy,
           void* dx, void* dwg, void* dwu, void* dwd, float* a, float* dh, float* du, int E,
           int C, int D, int F, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wgt = static_cast<const T*>(wg);
  const T* wut = static_cast<const T*>(wu);
  const size_t smem = sizeof(float) * bwd::kTileSmem;
  const dim3 g1(cdiv(F, kBN), cdiv(C, kBM), E);
  moe_bwd_hidden_kernel<T><<<g1, kT, smem, s>>>(xt, wgt, wut, static_cast<const T*>(wd),
                                                static_cast<const T*>(dy), a, dh, du, C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2(cdiv(D, kBN), cdiv(C, kBM), E);
  moe_bwd_dx_kernel<T><<<g2, kT, smem, s>>>(dh, du, wgt, wut, static_cast<T*>(dx), C, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g3(cdiv(D, kBM) * cdiv(F, kBN), 3, E);
  moe_bwd_dw_kernel<T><<<g3, kT, smem, s>>>(xt, static_cast<const T*>(dy), a, dh, du,
                                            static_cast<T*>(dwg), static_cast<T*>(dwu),
                                            static_cast<T*>(dwd), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  a, dh, du: (E, C, F) float32 scratch.
// Returns cudaGetLastError() after the launches (or the error that refused
// one).
extern "C" int moe_gmm_bwd(const void* x, const void* wg, const void* wu, const void* wd,
                           const void* dy, void* dx, void* dwg, void* dwu, void* dwd,
                           void* a, void* dh, void* du, int E, int C, int D, int F, int dtype,
                           void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0 ||
      static_cast<long long>(cdiv(D, kBM)) * cdiv(F, kBN) > 0x7fffffffLL ||
      cdiv(C, kBM) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* af = static_cast<float*>(a);
  float* dhf = static_cast<float*>(dh);
  float* duf = static_cast<float*>(du);
  if (dtype == 0)
    return launch<float>(x, wg, wu, wd, dy, dx, dwg, dwu, dwd, af, dhf, duf, E, C, D, F, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wg, wu, wd, dy, dx, dwg, dwu, dwd, af, dhf, duf, E, C, D,
                                 F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
