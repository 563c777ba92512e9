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
// and du, (E, C, F) each, from the caller.
//
// Bound on this card: at granite-moe-1b's train shape (E 32, C 320, D 1024,
// F 512, bf16) the nine products are 86 GFLOP and the bytes ~0.25 GB, so
// the work bounds it (0.087 ms at the bf16 tensor-core rate); at deepseek-
// v2's experts with a serve-sized bucket (D 5120, F 1536, C 8) the weights
// and their gradients are the bytes, 3 GB over 32 experts (0.90 ms).
//
// bf16, D and F multiples of 8, 16-byte aligned (every model path; path 1):
// the nine products on the tensor cores, mma.sync.m16n8k16 (bf16 in,
// float32 accumulate), 8 warps, operands moved by 16-byte cp.async through
// 3-stage rings (64-deep k slabs along the weights' rows in (1), and in (2)
// up to 16 bucket rows, so each weight row is read 128 bytes at a time;
// 32-deep in (2) above, where the products bound it and a smaller ring
// leaves room for two blocks an SM), transposed operands read by
// ldmatrix.trans.  Three launches:
//   (1) `moe_bwd_hidden_mma_kernel<NB>`: per 128 columns of F by NB bucket
//       rows, h^T = wg^T x^T, u^T = wu^T x^T and g^T = wd dy^T over D, with
//       the weight tile as the M operand (16 columns a warp) and the bucket
//       rows as N, 8 per n8 tile (the forward's trick: NB = 8 at C <= 8, so
//       deepseek's C = 8 wastes no tile rows; 16, 32, else 64); then a, dh,
//       du;
//   (2) `moe_bwd_dx_mma_kernel<NB>`: per 128 columns of D by NB rows, dx^T
//       = wg dh^T + wu du^T over F, the two products in one register tile;
//   (3) `moe_bwd_dw_mma_kernel`: per 128 rows of a weight by `per` tiles
//       of 64 columns (8 at C <= 32, else 1), dwg and dwu (x the shared A
//       operand) or dwd, each tile summed over all C bucket rows inside the
//       block and written through shared memory in 16-byte rows while the
//       ring loads the next tile's operands, so at C = 8 (one k stage a
//       tile) the weights' gradients stream out at the write rate rather
//       than the tile rate.
//   The scratch a, dh and du is bf16 on this path.  a is bf16 already (the
//   forward rounds it so); dh and du are rounded once to bf16 where this
//   file's float32 path keeps them float32: the tensor cores take them as
//   bf16 operands, and the reference's bf16 VJP of `_expert_compute` forms
//   them as bf16 arrays too (its einsums give bf16 h, u and cotangents), so
//   this follows the reference's rounding.
// float32, and bf16 shapes the tensor cores do not take (path 0): every
// product on the CUDA cores in float32 through `bwd::tile_product` (64 x 64
// output tiles, 256 threads), three launches of the same split, a, dh and
// du float32 scratch.  Shared memory is one tile's slabs (8.3 KB) whatever
// D and F are.
// No output is reduced across blocks on either path, so there are no
// atomics and no partial sums: every gradient is a fixed-order float32 sum
// and a resumed step repeats bit for bit.
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kMT = 256;        // threads: 8 warps
constexpr int kWM = 128;        // weight rows per block (the M operand)
constexpr int kKW = 64;         // k per ring stage of the hidden and dx kernels
constexpr int kKC = 32;         // k (bucket rows) per ring stage of the dW kernel
constexpr int kStages = 3;      // cp.async ring
constexpr int kLdK = kKW + 8;   // padded row of a [rows][k] tile: 144 bytes
constexpr int kLdW = kWM + 8;   // padded row of a [k][128] tile: 272 bytes
constexpr int kDwN = 64;        // dW kernel: columns per output tile
constexpr int kLdN = kDwN + 8;  // padded row of a [k][64] tile: 144 bytes

// The forward's fragment helpers (moe_gmm.cu), and ldmatrix_x4.
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
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
// c (16x8, f32) += a (16x16, bf16, row) . b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage the ROWS x COLS tile at (r0, c0) of a row-major bf16 matrix of nr
// rows and nc columns (row stride nc, nc % 8 == 0) into [ROWS][lds] by
// 16-byte cp.async; what lies outside the matrix is zeros.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(bf16* dst, int lds, const bf16* __restrict__ src,
                                           int r0, int c0, int nr, int nc) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMT) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool in = r0 + r < nr && c0 + c < nc;
    cp_async16(dst + r * lds + c, in ? src + static_cast<long long>(r0 + r) * nc + c0 + c : src,
               in ? 16 : 0);
  }
}

// The A fragment (16 x 16) of a weight tile stored [m][k] or [k][m]
// (trans), row stride ld, rows m0.., k from k0.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* t, int ld, int m0, int k0,
                                       int lane) {
  ldmatrix_x4(a, t + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
__device__ __forceinline__ void frag_a_trans(uint32_t* a, const bf16* t, int ld, int m0, int k0,
                                             int lane) {
  ldmatrix_x4_trans(a, t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                           ((lane >> 3) & 1) * 8);
}
// The B fragments (16 x 8 each) of kNT n8 tiles of bucket rows stored
// [n][k] (row stride LD): b[n] for n8 tile n.
template <int kNT, int LD>
__device__ __forceinline__ void frag_b_rows(uint32_t (*b)[2], const bf16* t, int k0, int lane) {
  if constexpr (kNT == 1) {
    ldmatrix_x2(b[0], t + (lane & 7) * LD + k0 + ((lane >> 3) & 1) * 8);
  } else {
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, t + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                         ((lane >> 3) & 1) * 8);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
  }
}

// (1) per (128 columns f, NB bucket rows, expert): h^T = wg^T x^T, u^T =
// wu^T x^T and g^T = wd dy^T over k = D, the weights as the M operand (8
// warps x 16 columns f) and the bucket rows as N, 8 per n8 tile; then a =
// bf16(silu(h) u) as the forward forms it, dh = g u silu'(h) and du = g
// silu(h), stored bf16.
template <int NB>
__global__ void __launch_bounds__(kMT)
moe_bwd_hidden_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                          const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                          const bf16* __restrict__ dy, bf16* __restrict__ a_out,
                          bf16* __restrict__ dh_out, bf16* __restrict__ du_out, int C, int D,
                          int F) {
  constexpr int kNT = NB / 8;
  // a stage: wg and wu [kKW][kLdW] (rows d, columns f), wd [kWM][kLdK]
  // (rows f, columns d), x and dy [NB][kLdK] (rows c, columns d)
  constexpr int kStage = 2 * kKW * kLdW + kWM * kLdK + 2 * NB * kLdK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const long long e = blockIdx.z;
  const int f0 = blockIdx.x * kWM;
  const int c0 = blockIdx.y * NB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* xe = x + e * C * D;
  const bf16* dye = dy + e * C * D;
  const bf16* wge = wg + e * D * F;
  const bf16* wue = wu + e * D * F;
  const bf16* wde = wd + e * F * D;
  const int nk = (D + kKW - 1) / kKW;

  auto load_stage = [&](int kt, int st) {
    bf16* s = ring + st * kStage;
    const int d0 = kt * kKW;
    stage_tile<kKW, kWM>(s, kLdW, wge, d0, f0, D, F);
    stage_tile<kKW, kWM>(s + kKW * kLdW, kLdW, wue, d0, f0, D, F);
    stage_tile<kWM, kKW>(s + 2 * kKW * kLdW, kLdK, wde, f0, d0, F, D);
    stage_tile<NB, kKW>(s + 2 * kKW * kLdW + kWM * kLdK, kLdK, xe, c0, d0, C, D);
    stage_tile<NB, kKW>(s + 2 * kKW * kLdW + kWM * kLdK + NB * kLdK, kLdK, dye, c0, d0, C, D);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  float h[kNT][4], u[kNT][4], g[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) h[n][c] = u[n][c] = g[n][c] = 0.f;
  const int m0 = warp * 16;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is consumed
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* s = ring + (kt % kStages) * kStage;
    const bf16* xs = s + 2 * kKW * kLdW + kWM * kLdK;
#pragma unroll
    for (int ks = 0; ks < kKW / 16; ++ks) {
      if (kt * kKW + ks * 16 >= D) break;  // block-uniform
      uint32_t ga[4], ua[4], da[4], xb[kNT][2], db[kNT][2];
      frag_a_trans(ga, s, kLdW, m0, ks * 16, lane);
      frag_a_trans(ua, s + kKW * kLdW, kLdW, m0, ks * 16, lane);
      frag_a(da, s + 2 * kKW * kLdW, kLdK, m0, ks * 16, lane);
      frag_b_rows<kNT, kLdK>(xb, xs, ks * 16, lane);
      frag_b_rows<kNT, kLdK>(db, xs + NB * kLdK, ks * 16, lane);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        mma_bf16(h[n], ga, xb[n]);
        mma_bf16(u[n], ua, xb[n]);
        mma_bf16(g[n], da, db[n]);
      }
    }
  }
  cp_async_wait<0>();
  // element (n, c): column f0 + m0 + lane / 4 + 8 (c >> 1), bucket row
  // c0 + 8 n + 2 (lane % 4) + (c & 1)
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = f0 + m0 + (lane >> 2) + 8 * (c >> 1);
      const int r = c0 + n * 8 + ((lane & 3) << 1) + (c & 1);
      if (f >= F || r >= C) continue;
      const float hv = h[n][c];
      const float sig = 1.f / (1.f + expf(-hv));
      const float sh = hv / (1.f + expf(-hv));  // silu(h), as the forward forms it
      const long long o = (e * C + r) * F + f;
      a_out[o] = __float2bfloat16_rn(__fmul_rn(sh, u[n][c]));  // a.astype(wd.dtype)
      dh_out[o] = __float2bfloat16_rn(g[n][c] * u[n][c] * (sig * (1.f + hv * (1.f - sig))));
      du_out[o] = __float2bfloat16_rn(g[n][c] * sh);
    }
  }
}

// k per ring stage of the dx kernel: 64 for small buckets (the weights'
// bytes bound it: 128-byte reads along their rows), 32 above 16 rows (the
// products bound it: a smaller ring leaves room for two blocks an SM)
template <int NB>
__host__ __device__ constexpr int dx_kw() { return NB > 16 ? 32 : kKW; }

// (2) per (128 columns d, NB bucket rows, expert): dx^T = wg dh^T + wu du^T
// over k = F, the weights as the M operand and the bucket rows as N; both
// products add into one register tile.
template <int NB>
__global__ void __launch_bounds__(kMT)
moe_bwd_dx_mma_kernel(const bf16* __restrict__ dh, const bf16* __restrict__ du,
                      const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                      bf16* __restrict__ dx, int C, int D, int F) {
  constexpr int kNT = NB / 8;
  constexpr int KW = dx_kw<NB>();
  constexpr int LD = KW + 8;
  // a stage: wg and wu [kWM][LD] (rows d, columns f), dh and du [NB][LD]
  // (rows c, columns f)
  constexpr int kStage = 2 * kWM * LD + 2 * NB * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const long long e = blockIdx.z;
  const int d0 = blockIdx.x * kWM;
  const int c0 = blockIdx.y * NB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* dhe = dh + e * C * F;
  const bf16* due = du + e * C * F;
  const bf16* wge = wg + e * D * F;
  const bf16* wue = wu + e * D * F;
  const int nk = (F + KW - 1) / KW;

  auto load_stage = [&](int kt, int st) {
    bf16* s = ring + st * kStage;
    const int k0 = kt * KW;
    stage_tile<kWM, KW>(s, LD, wge, d0, k0, D, F);
    stage_tile<kWM, KW>(s + kWM * LD, LD, wue, d0, k0, D, F);
    stage_tile<NB, KW>(s + 2 * kWM * LD, LD, dhe, c0, k0, C, F);
    stage_tile<NB, KW>(s + 2 * kWM * LD + NB * LD, LD, due, c0, k0, C, F);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  const int m0 = warp * 16;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* s = ring + (kt % kStages) * kStage;
    const bf16* hs = s + 2 * kWM * LD;
#pragma unroll
    for (int ks = 0; ks < KW / 16; ++ks) {
      if (kt * KW + ks * 16 >= F) break;  // block-uniform
      uint32_t ga[4], ua[4], hb[kNT][2], ub[kNT][2];
      frag_a(ga, s, LD, m0, ks * 16, lane);
      frag_a(ua, s + kWM * LD, LD, m0, ks * 16, lane);
      frag_b_rows<kNT, LD>(hb, hs, ks * 16, lane);
      frag_b_rows<kNT, LD>(ub, hs + NB * LD, ks * 16, lane);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        mma_bf16(acc[n], ga, hb[n]);
        mma_bf16(acc[n], ua, ub[n]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + m0 + (lane >> 2) + 8 * (c >> 1);
      const int r = c0 + n * 8 + ((lane & 3) << 1) + (c & 1);
      if (d < D && r < C) dx[(e * C + r) * D + d] = __float2bfloat16_rn(acc[n][c]);
    }
  }
}

// (3) per (128 rows of a weight, `per` tiles of 64 of its columns, which,
// expert): which 0: dwg = x^T dh and dwu = x^T du (rows d, columns f; x the
// shared A operand), which 1: dwd = a^T dy (rows f, columns d); k = the C
// bucket rows, all summed inside the block.  Warps 4 x 2, each 32 rows x 32
// columns; both operands read by ldmatrix.trans from their [c][...] rows.
// The ring runs over the (column tile, k stage) pairs, so the next tile's
// operands load while a finished tile goes out through shared memory in
// 16-byte rows: at C = 8 (one k stage a tile) the block streams its
// gradients out at the write rate rather than the tile rate.
__global__ void __launch_bounds__(kMT)
moe_bwd_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      const bf16* __restrict__ a, const bf16* __restrict__ dh,
                      const bf16* __restrict__ du, bf16* __restrict__ dwg,
                      bf16* __restrict__ dwu, bf16* __restrict__ dwd, int C, int D, int F,
                      int per) {
  // a stage: A [kKC][kLdW] (rows c), B0 and B1 [kKC][kLdN] (rows c)
  constexpr int kStage = kKC * kLdW + 2 * kKC * kLdN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* out_s = ring + kStages * kStage;  // [2][kWM][kLdN]: a finished tile
  const long long e = blockIdx.z;
  const int which = blockIdx.y;
  const int M = which == 0 ? D : F;  // rows of the weight
  const int N = which == 0 ? F : D;  // its columns
  const int ntn = (N + kDwN - 1) / kDwN;
  const int ngrp = (ntn + per - 1) / per;
  if (static_cast<int>(blockIdx.x) >= ((M + kWM - 1) / kWM) * ngrp) return;  // block-uniform
  const int m0 = (blockIdx.x / ngrp) * kWM;
  const int nt0 = (blockIdx.x % ngrp) * per;
  const int nts = min(per, ntn - nt0);  // column tiles of this block
  const int nb = which == 0 ? 2 : 1;    // products of this block
  const bf16* as = which == 0 ? x + e * C * D : a + e * C * F;    // [C][M]
  const bf16* b0 = which == 0 ? dh + e * C * F : dy + e * C * D;  // [C][N]
  const bf16* b1 = du + e * C * F;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;
  const int nk = (C + kKC - 1) / kKC;
  const int total = nts * nk;

  // chunk q: column tile nt0 + q / nk, k stage q % nk
  auto load_chunk = [&](int q, int st) {
    bf16* s = ring + st * kStage;
    const int k0 = (q % nk) * kKC;
    const int n0 = (nt0 + q / nk) * kDwN;
    stage_tile<kKC, kWM>(s, kLdW, as, k0, m0, C, M);
    stage_tile<kKC, kDwN>(s + kKC * kLdW, kLdN, b0, k0, n0, C, N);
    if (nb == 2) stage_tile<kKC, kDwN>(s + kKC * kLdW + kKC * kLdN, kLdN, b1, k0, n0, C, N);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < total) load_chunk(st, st);
    cp_async_commit();
  }
  float acc[2][2][4][4];  // [product][m16 tile][n8 tile]
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][i][j][c] = 0.f;
  for (int q = 0; q < total; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q has landed; chunk q - 1 and the last tile out are consumed
    if (q + kStages - 1 < total) load_chunk(q + kStages - 1, (q + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* s = ring + (q % kStages) * kStage;
    const int kt = q % nk;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      if (kt * kKC + ks * 16 >= C) break;  // block-uniform
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) frag_a_trans(af[i], s, kLdW, wm + 16 * i, ks * 16, lane);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p >= nb) break;
        const bf16* bs = s + kKC * kLdW + p * kKC * kLdN;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdN + wn +
                                   np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[p][i][2 * np], af[i], r);
            mma_bf16(acc[p][i][2 * np + 1], af[i], r + 2);
          }
        }
      }
    }
    if (kt != nk - 1) continue;
    // the column tile is summed over all C rows: out through shared memory
    const int n0 = (nt0 + q / nk) * kDwN;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p >= nb) break;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = wm + 16 * i + (lane >> 2) + 8 * hh;
            const int cc = wn + 8 * j + ((lane & 3) << 1);
            *reinterpret_cast<uint32_t*>(out_s + (p * kWM + r) * kLdN + cc) =
                pack_bf16(acc[p][i][j][2 * hh], acc[p][i][j][2 * hh + 1]);
            acc[p][i][j][2 * hh] = acc[p][i][j][2 * hh + 1] = 0.f;
          }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb * kWM * (kDwN / 8); i += kMT) {
      const int p = i / (kWM * (kDwN / 8));
      const int r = (i / (kDwN / 8)) % kWM;
      const int cc = (i % (kDwN / 8)) * 8;
      if (m0 + r >= M || n0 + cc >= N) continue;
      bf16* out = (which == 1 ? dwd : p == 0 ? dwg : dwu) + e * M * N;
      *reinterpret_cast<uint4*>(out + static_cast<long long>(m0 + r) * N + n0 + cc) =
          *reinterpret_cast<const uint4*>(out_s + (p * kWM + r) * kLdN + cc);
    }
  }
  cp_async_wait<0>();
}

template <int NB>
size_t hidden_smem() {
  return sizeof(bf16) * kStages * (2 * kKW * kLdW + kWM * kLdK + 2 * NB * kLdK);
}
template <int NB>
size_t dx_smem() {
  return sizeof(bf16) * kStages * (2 * kWM + 2 * NB) * (dx_kw<NB>() + 8);
}
size_t dw_smem() {
  return sizeof(bf16) * (kStages * (kKC * kLdW + 2 * kKC * kLdN) + 2 * kWM * kLdN);
}
// column tiles per block of the dW kernel: 8 when the C bucket rows fit one
// k stage (the kernel streams its gradients out), else 1
int dw_per(int C) { return C <= kKC ? 8 : 1; }

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int NB>
int launch_mma_nb(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd, const bf16* dy,
                  bf16* dx, bf16* dwg, bf16* dwu, bf16* dwd, bf16* a, bf16* dh, bf16* du, int E,
                  int C, int D, int F, cudaStream_t s) {
  int err = allow_smem(moe_bwd_hidden_mma_kernel<NB>, hidden_smem<NB>());
  if (err) return err;
  err = allow_smem(moe_bwd_dx_mma_kernel<NB>, dx_smem<NB>());
  if (err) return err;
  err = allow_smem(moe_bwd_dw_mma_kernel, dw_smem());
  if (err) return err;
  const dim3 g1(cdiv(F, kWM), cdiv(C, NB), E);
  moe_bwd_hidden_mma_kernel<NB><<<g1, kMT, hidden_smem<NB>(), s>>>(x, wg, wu, wd, dy, a, dh, du,
                                                                    C, D, F);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 g2(cdiv(D, kWM), cdiv(C, NB), E);
  moe_bwd_dx_mma_kernel<NB><<<g2, kMT, dx_smem<NB>(), s>>>(dh, du, wg, wu, dx, C, D, F);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int per = dw_per(C);
  const int t0 = cdiv(D, kWM) * cdiv(cdiv(F, kDwN), per);
  const int t1 = cdiv(F, kWM) * cdiv(cdiv(D, kDwN), per);
  const dim3 g3(t0 > t1 ? t0 : t1, 2, E);
  moe_bwd_dw_mma_kernel<<<g3, kMT, dw_smem(), s>>>(x, dy, a, dh, du, dwg, dwu, dwd, C, D, F,
                                                   per);
  return static_cast<int>(cudaGetLastError());
}

// NB bucket rows per block of the hidden and dx kernels: 8 (C <= 8, so a
// serve-sized or deepseek-sized bucket fills whole n8 tiles), 16, 32, else 64
int launch_mma(const void* x, const void* wg, const void* wu, const void* wd, const void* dy,
               void* dx, void* dwg, void* dwu, void* dwd, void* a, void* dh, void* du, int E,
               int C, int D, int F, cudaStream_t s) {
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wgt = static_cast<const bf16*>(wg);
  const bf16* wut = static_cast<const bf16*>(wu);
  const bf16* wdt = static_cast<const bf16*>(wd);
  const bf16* dyt = static_cast<const bf16*>(dy);
  bf16* o[7] = {static_cast<bf16*>(dx), static_cast<bf16*>(dwg), static_cast<bf16*>(dwu),
                static_cast<bf16*>(dwd), static_cast<bf16*>(a), static_cast<bf16*>(dh),
                static_cast<bf16*>(du)};
  if (C <= 8)
    return launch_mma_nb<8>(xt, wgt, wut, wdt, dyt, o[0], o[1], o[2], o[3], o[4], o[5], o[6], E,
                            C, D, F, s);
  if (C <= 16)
    return launch_mma_nb<16>(xt, wgt, wut, wdt, dyt, o[0], o[1], o[2], o[3], o[4], o[5], o[6], E,
                             C, D, F, s);
  if (C <= 32)
    return launch_mma_nb<32>(xt, wgt, wut, wdt, dyt, o[0], o[1], o[2], o[3], o[4], o[5], o[6], E,
                             C, D, F, s);
  return launch_mma_nb<64>(xt, wgt, wut, wdt, dyt, o[0], o[1], o[2], o[3], o[4], o[5], o[6], E, C,
                           D, F, s);
}

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

// dtype 0 = float32, 1 = bfloat16.  path 1 = tensor cores (bf16, D and F
// multiples of 8, every operand and scratch 16-byte aligned): a, dh, du are
// (E, C, F) bf16 scratch; path 0 = CUDA cores: a, dh, du are (E, C, F)
// float32 scratch.  Returns cudaGetLastError() after the launches (or the
// error that refused one).
extern "C" int moe_gmm_bwd(const void* x, const void* wg, const void* wu, const void* wd,
                           const void* dy, void* dx, void* dwg, void* dwu, void* dwd,
                           void* a, void* dh, void* du, int E, int C, int D, int F, int dtype,
                           int path, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0 ||
      static_cast<long long>(cdiv(D, kBM)) * cdiv(F, kBN) > 0x7fffffffLL ||
      cdiv(C, kBM) > 65535 || (path != 0 && path != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const void* ptrs[12] = {x, wg, wu, wd, dy, dx, dwg, dwu, dwd, a, dh, du};
    bool aligned = true;
    for (const void* ptr : ptrs) aligned = aligned && (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0 || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(x, wg, wu, wd, dy, dx, dwg, dwu, dwd, a, dh, du, E, C, D, F, s);
  }
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
