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
// positive) is never taken: masked weights are 0.
//
// Layouts: dt (B, nb, C, H) and A (H,) contiguous; y (B, nb, C, H, P),
// contrib (B, nb, H, P, N), chunk_decay (B, nb, H) contiguous; x
// (B, nb, C, H, P) and Bm / Cm (B, nb, C, N) as rows of one token each with
// a row stride (x_rs, b_rs, c_rs elements; the model hands slices of one
// projection), contiguous on the CUDA-core path.
//
// Bound on this card: at mamba2-2.7b's full width with L = 1024 (C = 256,
// nb = 4, H = 80, P = 64, N = 128, bfloat16 inputs) the call reads 10.5 MB
// of x and 0.5 MB of B/C and writes 21 MB of y and 10.5 MB of contrib
// (43 MB, 0.013 ms at 3.35 TB/s) against 2.7 GFLOP of products (0.003 ms
// on the tensor cores): bound by bytes.  At the serve prefill (C = 16) it is
// bound by launch latency.
//
// Two designs; the wrapper's plan (`ssd_plan` in kernels/ssd.py) picks one
// and the launcher refuses a plan that does not fit:
//
// * bfloat16, P >= 8 (every model path): `ssd_mma_kernel<P, KC>`, one
//   launch, one block of 8 warps per (batch * chunk, head).  B and the
//   head's x are loaded by 16-byte cp.async into shared memory (bf16, rows
//   padded by 16 bytes so that ldmatrix is conflict-free; rows past C
//   zero-filled); warp 0 forms acum by a warp-parallel float64 scan (a
//   sequential sum per lane, then a shuffle scan of the lane sums).  Every
//   product runs on mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//   - y: a warp owns 16 query rows (tiles dealt so that each warp's causal
//     work is equal) and holds those rows of C in registers, in the A
//     operand's layout (KC k-steps of 16).  For each 16-key tile at or
//     below its rows it forms the C.B^T tile on the tensor cores (C and B
//     are exact bf16, so the products are exact), turns it in registers
//     into the weights W[t, s] = CB exp(acum_t - acum_s) dt_s (the
//     accumulator's layout is the A operand's), splits W into bf16 hi + lo
//     (hi = bf16(W), lo = bf16(W - hi): W to ~2^-17 relative, where one
//     bf16 rounding of W, 2^-9, over 256 terms of ~10 would move y past the
//     tolerance) and issues two MMAs against the exact bf16 x tile.  Tiles
//     above the diagonal are skipped.
//   - contrib = (coef o X)^T . B, coef_s = dt_s exp(acum_last - acum_s): a
//     warp owns 16 rows p and up to 64 columns n; the A operand is x read
//     by ldmatrix.trans, scaled by coef in float32 and split hi + lo the
//     same way, B the exact bf16 B tile.
//   With C in registers a block holds 110 KB at mamba2's shapes, so two
//   blocks share an SM (N <= 128, P <= 64: <= 128 registers a thread) and
//   one block's loads overlap the other's products.  scripts/ssm_variants.py
//   times the phases (NVIDIA H100 80GB HBM3, 700 W, L = 1024: 0.075 ms; the
//   loads and prefix sum alone 0.014, without y 0.038, without contrib
//   0.050): the y phase is the next target (wgmma on 64-row tiles; its
//   exps and hi/lo splits share the issue slots with the MMAs, which is why
//   only the diagonal tile and the tile past C take the mask).
//   The C.B^T tile is
//   recomputed per head (C^2 N / 2 products, as many as y's): sharing it
//   across a group of heads would halve the blocks (160 at L = 1024) and
//   add a head's accumulators to every thread.  Neither a second launch nor
//   a (C, C) scratch remains.
// * float32 (the card-vs-CPU cross-check) or P < 8: the CUDA cores, in two
//   launches.
//   1. `ssd_cb_kernel`: CB[t, s] = C_t . B_s for each (batch, chunk), in
//      32 x 32 tiles on and below the diagonal, into a (B, nb, C, C)
//      scratch, shared by every head of the chunk.
//   2. `ssd_chunk_kernel`: one block of 256 threads per (batch * chunk,
//      head).  The chunk's x[:, h, :] (C x P, float32) stays in shared
//      memory; thread 0 forms the cumulative sum.  y is built 32 query rows
//      at a time from 32 x 32 weight tiles formed in shared memory (one exp
//      per (t, s) pair); contrib is an outer-product sum over s in 16 x 16
//      thread micro-tiles (p by n), B streamed in 32-row tiles.
//
// Nothing is allocated here; the caller owns every buffer.  No
// synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTile = 32;      // query rows / keys per tile (CUDA cores)
constexpr int kMaxC = 256;
constexpr int kMaxP = 128;     // a power of two
constexpr int kMaxN = 256;
constexpr int kMicro = 16;     // contrib: 16 x 16 threads
constexpr int kNPer = 8;                // n columns per thread per pass
constexpr int kNPass = kMicro * kNPer;  // n columns per pass
constexpr int kWarps = kThreads / 32;   // tensor-core kernel
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }
// x row pitch (bf16): at least 16 columns (the contrib A tile reads 16),
// padded by 16 bytes
__host__ __device__ constexpr int mma_xs(int P) { return (P < 16 ? 16 : P) + 8; }
// B / C row pitch (bf16), padded by 16 bytes
__host__ __device__ constexpr int mma_bs(int N) { return round16(N) + 8; }

size_t mma_smem_bytes(int C, int P, int N) {
  const size_t cp = static_cast<size_t>(round16(C));
  return sizeof(bf16) * cp * (mma_bs(N) + mma_xs(P)) + sizeof(float) * 3 * cp;
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
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
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
// (v0, v1) as bf16 pairs hi = bf16(v), lo = bf16(v - hi), v0 in the low half
__device__ __forceinline__ void split_hi_lo(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// One block per (head, batch * chunk): 8 warps; KC >= N / 16 k-steps of the
// C.B^T product, whose C rows a warp holds in registers (KC = 8: N <= 128,
// and P <= 64: two blocks an SM).  Lane roles in every m16n8k16 fragment: g = lane / 4
// (row), q = lane % 4 (column pair).
template <int P, int KC>
__global__ void __launch_bounds__(kThreads, KC <= 8 && P <= 64 ? 2 : 1)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ contrib, float* __restrict__ decay, int C, int H, int N,
               long long x_rs, long long b_rs, long long c_rs, int b_vec, int c_pair) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kXs = mma_xs(P);
  const int Cp = round16(C);
  const int Np = round16(N);
  const int bs = mma_bs(N);
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);  // [Cp][bs]
  bf16* Xs = Bs + Cp * bs;                       // [Cp][kXs]
  float* ack = reinterpret_cast<float*>(Xs + Cp * kXs);  // [Cp]
  float* dts = ack + Cp;                                 // [Cp]
  float* coef = dts + Cp;                                // [Cp]

  const int h = blockIdx.x;
  const long long bc = blockIdx.y;
  const long long tok0 = bc * C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;

  // ---- loads: B rows (zero past C and N), the head's x rows --------------
  if (b_vec) {
    const int cpr = Np / 8;
    for (int i = tid; i < Cp * cpr; i += kThreads) {
      const int s = i / cpr;
      const int n = (i - s * cpr) * 8;
      const bool in = s < C && n < N;
      cp_async16(Bs + s * bs + n, Bm + (tok0 + (in ? s : 0)) * b_rs + (in ? n : 0), in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < Cp * Np; i += kThreads) {
      const int s = i / Np;
      const int n = i - s * Np;
      Bs[s * bs + n] = s < C && n < N ? Bm[(tok0 + s) * b_rs + n] : __float2bfloat16(0.f);
    }
  }
  {
    constexpr int cpr = P / 8;
    for (int i = tid; i < Cp * cpr; i += kThreads) {
      const int s = i / cpr;
      const int p = (i - s * cpr) * 8;
      const bool in = s < C;
      cp_async16(Xs + s * kXs + p, x + (tok0 + (in ? s : 0)) * x_rs + h * P + p, in ? 16 : 0);
    }
  }
  cp_async_commit();
  for (int s = tid; s < Cp; s += kThreads) dts[s] = s < C ? dt[(tok0 + s) * H + h] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  // ---- acum: float64 prefix sum of dt * A, each value rounded once -------
  if (warp == 0) {
    const double a = A[h];
    const int per = (C + 31) / 32;
    const int s0 = min(C, lane * per);
    const int s1 = min(C, s0 + per);
    double own = 0.0;
    for (int s = s0; s < s1; ++s) own += static_cast<double>(dts[s]) * a;
    double incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    double run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) run = 0.0;
    for (int s = s0; s < s1; ++s) {
      run += static_cast<double>(dts[s]) * a;
      ack[s] = static_cast<float>(run);
    }
  }
  __syncthreads();
  const float alast = ack[C - 1];
  for (int s = tid; s < Cp; s += kThreads) {
    if (s >= C) ack[s] = alast;  // padded rows: finite exponents, never stored
    coef[s] = s < C ? dts[s] * expf(alast - ack[s]) : 0.f;
  }
  if (tid == 0) decay[bc * H + h] = expf(alast);
  __syncthreads();

  // ---- y_intra: 16 query rows per warp, tiles dealt in a snake ------------
  const int nt = Cp / 16;
  for (int r0 = 0; r0 < nt; r0 += kWarps) {
    const int tt = r0 + (((r0 / kWarps) & 1) ? kWarps - 1 - warp : warp);
    if (tt >= nt) continue;
    const int t0 = tt * 16;
    const int ta = t0 + g;
    const int tb = ta + 8;
    const float acta = ack[ta];
    const float actb = ack[tb];
    // the A operand of C.B^T: rows ta, tb of C, read once per t-tile
    uint32_t cf[KC][4];
    {
      const bf16* ra = ta < C ? Cm + (tok0 + ta) * c_rs : nullptr;
      const bf16* rb = tb < C ? Cm + (tok0 + tb) * c_rs : nullptr;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const int n = kk * 16 + 2 * q;
        cf[kk][0] = ld_pair(ra, n, N, c_pair);
        cf[kk][1] = ld_pair(rb, n, N, c_pair);
        cf[kk][2] = ld_pair(ra, n + 8, N, c_pair);
        cf[kk][3] = ld_pair(rb, n + 8, N, c_pair);
      }
    }
    float yacc[P / 8][4];
#pragma unroll
    for (int j = 0; j < P / 8; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
    for (int s0 = 0; s0 <= t0; s0 += 16) {
      // CB tile: C[t0 : t0 + 16] . B[s0 : s0 + 16]^T
      float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (kk * 16 < Np) {
          uint32_t b[4];
          ldmatrix_x4(b, Bs + (s0 + (lane & 7) + ((lane >> 4) << 3)) * bs + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(cb[0], cf[kk], b);
          mma_bf16(cb[1], cf[kk], b + 2);
        }
      }
      // W in the A operand's layout: register 2j + (row g + 8); only the
      // diagonal tile and the tile past C mask
      uint32_t whi[4], wlo[4];
      const bool edge = s0 == t0 || s0 + 16 > C;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = s0 + 8 * j + 2 * q;
        const float2 as = *reinterpret_cast<const float2*>(ack + s);
        const float2 d = *reinterpret_cast<const float2*>(dts + s);
        float wa0, wa1, wb0, wb1;
        if (edge) {
          wa0 = s <= ta && s < C ? cb[j][0] * expf(acta - as.x) * d.x : 0.f;
          wa1 = s + 1 <= ta && s + 1 < C ? cb[j][1] * expf(acta - as.y) * d.y : 0.f;
          wb0 = s <= tb && s < C ? cb[j][2] * expf(actb - as.x) * d.x : 0.f;
          wb1 = s + 1 <= tb && s + 1 < C ? cb[j][3] * expf(actb - as.y) * d.y : 0.f;
        } else {
          wa0 = cb[j][0] * expf(acta - as.x) * d.x;
          wa1 = cb[j][1] * expf(acta - as.y) * d.y;
          wb0 = cb[j][2] * expf(actb - as.x) * d.x;
          wb1 = cb[j][3] * expf(actb - as.y) * d.y;
        }
        split_hi_lo(wa0, wa1, whi[2 * j], wlo[2 * j]);
        split_hi_lo(wb0, wb1, whi[2 * j + 1], wlo[2 * j + 1]);
      }
      // y += W . x[s0 : s0 + 16], x by ldmatrix.trans
      if constexpr (P == 8) {
        uint32_t xb[2];
        ldmatrix_x2_trans(xb, Xs + (s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kXs);
        mma_bf16(yacc[0], whi, xb);
        mma_bf16(yacc[0], wlo, xb);
      } else {
#pragma unroll
        for (int j = 0; j < P / 8; j += 2) {
          uint32_t xb[4];
          ldmatrix_x4_trans(xb, Xs + (s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kXs + j * 8 +
                                    (lane >> 4) * 8);
          mma_bf16(yacc[j], whi, xb);
          mma_bf16(yacc[j], wlo, xb);
          mma_bf16(yacc[j + 1], whi, xb + 2);
          mma_bf16(yacc[j + 1], wlo, xb + 2);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const int p = 8 * j + 2 * q;
      if (ta < C) {
        *reinterpret_cast<float2*>(y + ((tok0 + ta) * H + h) * P + p) =
            make_float2(yacc[j][0], yacc[j][1]);
      }
      if (tb < C) {
        *reinterpret_cast<float2*>(y + ((tok0 + tb) * H + h) * P + p) =
            make_float2(yacc[j][2], yacc[j][3]);
      }
    }
  }

  // ---- contrib = (coef o x)^T . B: 16 rows p x up to 64 columns n per item
  constexpr int kMT = P < 16 ? 1 : P / 16;
  const int n8 = (N + 7) / 8;
  const int groups = (n8 + 7) / 8;
  float* cout = contrib + (bc * H + h) * static_cast<long long>(P) * N;
  for (int item = warp; item < kMT * groups; item += kWarps) {
    const int p0 = (item % kMT) * 16;
    const int j0 = (item / kMT) * 8;
    const int jn = min(8, n8 - j0);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int s0 = 0; s0 < Cp; s0 += 16) {
      // A: x^T rows p0..p0+15, k = s0..s0+15; register r holds rows
      // g + 8 (r & 1) at keys 2q + 8 (r >> 1)
      uint32_t xa[4], ahi[4], alo[4];
      ldmatrix_x4_trans(xa, Xs + (s0 + (lane & 7) + ((lane >> 4) << 3)) * kXs + p0 +
                                ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = s0 + 2 * q + 8 * (r >> 1);
        const float2 f = unpack(xa[r]);
        const float2 cs = *reinterpret_cast<const float2*>(coef + s);
        float v0 = f.x * cs.x, v1 = f.y * cs.y;
        if (P < 16 && (r & 1)) v0 = v1 = 0.f;  // rows p >= P
        split_hi_lo(v0, v1, ahi[r], alo[r]);
      }
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        if (j < jn) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, Bs + (s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * bs +
                                    (j0 + j) * 8 + (lane >> 4) * 8);
          mma_bf16(acc[j], ahi, bb);
          mma_bf16(acc[j], alo, bb);
          if (j + 1 < jn) {
            mma_bf16(acc[j + 1], ahi, bb + 2);
            mma_bf16(acc[j + 1], alo, bb + 2);
          }
        }
      }
    }
    const int pa = p0 + g;
    const int pb = pa + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < jn) {
        const int n = (j0 + j) * 8 + 2 * q;
        if (pa < P) {
          if (n < N) cout[pa * N + n] = acc[j][0];
          if (n + 1 < N) cout[pa * N + n + 1] = acc[j][1];
        }
        if (pb < P) {
          if (n < N) cout[pb * N + n] = acc[j][2];
          if (n + 1 < N) cout[pb * N + n + 1] = acc[j][3];
        }
      }
    }
  }
}

template <int P, int KC>
int launch_mma(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
               float* y, float* contrib, float* decay, int BC, int C, int H, int N,
               long long x_rs, long long b_rs, long long c_rs, int b_vec, int c_pair,
               size_t smem, cudaStream_t stream) {
  static bool opted_in[64] = {};  // the 227 KB opt-in, once per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= 64 || !opted_in[dev])) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_mma_kernel<P, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemMax));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) opted_in[dev] = true;
  }
  ssd_mma_kernel<P, KC><<<dim3(H, BC), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), y, contrib, decay, C, H, N, x_rs, b_rs, c_rs, b_vec, c_pair);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_mma(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
               float* y, float* contrib, float* decay, int BC, int C, int H, int N,
               long long x_rs, long long b_rs, long long c_rs, int b_vec, int c_pair,
               size_t smem, cudaStream_t stream) {
  if (N <= 128) {
    return launch_mma<P, 8>(x, dt, A, Bm, Cm, y, contrib, decay, BC, C, H, N, x_rs, b_rs, c_rs,
                            b_vec, c_pair, smem, stream);
  }
  return launch_mma<P, 16>(x, dt, A, Bm, Cm, y, contrib, decay, BC, C, H, N, x_rs, b_rs, c_rs,
                           b_vec, c_pair, smem, stream);
}

// ---------------------------------------------------------------------------
// the CUDA cores
// ---------------------------------------------------------------------------
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
int launch_fma(const void* x, const float* dt, const float* A, const void* Bm,
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
// dtype 0 = float32, 1 = bfloat16 (x, Bm, Cm).  path 1 = the tensor cores
// (bfloat16, 8 <= P, `smem` = mma_smem_bytes(C, P, N) <= 227 KB; x rows
// 16-byte aligned: x_rs % 8 == 0), path 0 = the CUDA cores (x, Bm, Cm
// contiguous, `cb` a (BC, C, C) float32 scratch).  Returns
// cudaGetLastError() after the launches, or the error that refused one.
extern "C" int ssd_intra_chunk(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* cb,
                               void* y, void* contrib, void* decay, int BC,
                               int C, int H, int P, int N, long long x_rs,
                               long long b_rs, long long c_rs, int dtype, int path,
                               long long smem, void* stream) {
  if (BC <= 0 || BC > 65535 || C <= 0 || C > kMaxC || H <= 0 || P <= 0 ||
      P > kMaxP || (P & (P - 1)) != 0 || N <= 0 || N > kMaxN || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* cf = static_cast<float*>(contrib);
  float* df = static_cast<float*>(decay);
  if (path == 1) {
    const size_t need = mma_smem_bytes(C, P, N);
    if (dtype != 1 || P < 8 || need > kSmemMax || static_cast<long long>(need) != smem ||
        x_rs % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || b_rs < N || c_rs < N ||
        x_rs < static_cast<long long>(H) * P) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int b_vec = N % 8 == 0 && b_rs % 8 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0;
    const int c_pair = c_rs % 2 == 0 && reinterpret_cast<uintptr_t>(Cm) % 4 == 0;
    switch (P) {
      case 8: return launch_mma<8>(x, dtf, Af, Bm, Cm, yf, cf, df, BC, C, H, N, x_rs, b_rs, c_rs, b_vec, c_pair, need, s);
      case 16: return launch_mma<16>(x, dtf, Af, Bm, Cm, yf, cf, df, BC, C, H, N, x_rs, b_rs, c_rs, b_vec, c_pair, need, s);
      case 32: return launch_mma<32>(x, dtf, Af, Bm, Cm, yf, cf, df, BC, C, H, N, x_rs, b_rs, c_rs, b_vec, c_pair, need, s);
      case 64: return launch_mma<64>(x, dtf, Af, Bm, Cm, yf, cf, df, BC, C, H, N, x_rs, b_rs, c_rs, b_vec, c_pair, need, s);
      default: return launch_mma<128>(x, dtf, Af, Bm, Cm, yf, cf, df, BC, C, H, N, x_rs, b_rs, c_rs, b_vec, c_pair, need, s);
    }
  }
  if (path != 0 || x_rs != static_cast<long long>(H) * P || b_rs != N || c_rs != N ||
      cb == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* cbf = static_cast<float*>(cb);
  if (dtype == 0) {
    return launch_fma<float>(x, dtf, Af, Bm, Cm, cbf, yf, cf, df, BC, C, H, P, N, s);
  }
  return launch_fma<bf16>(x, dtf, Af, Bm, Cm, cbf, yf, cf, df, BC, C, H, P, N, s);
}
