// GQA flash attention, backward, for Hopper (sm_90a).
//
// Replaces the reference's blockwise attention backward: `_flash_bwd`, the
// custom_vjp backward of `_flash_core` in src/repro/models/common.py (the
// gradient of `chunked_attention`, which the Pallas forward `flash_attention`
// of src/repro/kernels/flash_attention.py computes).  Given q (B, Hq, Lq, D),
// k, v (B, Hkv, Lk, D), the forward's out and its rows' log-sum-exp lse
// (B, Hq, Lq) float32 (flash_attention.cu writes it), and dout:
//
//   delta[i] = sum_d dout[i, d] * out[i, d]
//   raw      = scale * q[i] . k[j]
//   s        = softcap * tanh(raw / softcap), dcap = 1 - tanh^2  (softcap > 0)
//   p[i, j]  = exp(s - lse[i]) for a visible key, else 0
//   dv[j]   += p[i, j] dout[i]            dp[i, j] = dout[i] . v[j]
//   ds[i, j] = p[i, j] (dp[i, j] - delta[i]) dcap scale
//   dq[i]   += ds[i, j] k[j]              dk[j]   += ds[i, j] q[i]
//
// with the forward's visibility (j < kv_valid_len, kv_offset + j <= q_offset
// + i when causal, kv_offset + j > q_offset + i - window when window > 0),
// float32 arithmetic throughout, the G = Hq / Hkv query heads of a KV head
// summed into its dk, dv, and every gradient written in the input dtype
// (float32 or bfloat16).  No kv_positions (ring caches are not trained).
//
// No atomics (so a run repeats bit for bit): a delta pass
// (`flash_bwd_delta_kernel`, one warp per row), then a dK/dV kernel whose
// block owns a key tile of one (batch, KV head) and walks the query rows of
// its query heads that can see it (the causal start and the window's end
// bound the walk), then a dQ kernel whose block owns a query tile of one head
// and walks the key tiles its rows can see.  p and dp are recomputed in both
// (the price of no atomics on dq).  Two designs of the pair:
//
// * bf16, D % 8 == 0, D <= 256, 16-byte aligned (the train path; path 1):
//   tensor cores, mma.sync.m16n8k16 (bf16 in, float32 accumulate), 8 warps,
//   tiles moved by 16-byte cp.async into rows padded by 16 bytes (ldmatrix
//   conflict-free) through 2-stage rings, so a tile loads while the previous
//   one computes.  dK/dV (`flash_bwd_dkdv_ring_mma_kernel<kD, kQT>`): 64
//   keys a block, K and V staged once; per ring tile of kQT query rows (64 at
//   D <= 128, 32 at D = 256: shared memory) warp w forms S^T = K Q^T and dP^T
//   = V dO^T for keys 16 (w % 4) by half the rows, p^T and ds^T in its
//   accumulators' registers, and writes them to shared memory rounded to bf16
//   (as the forward rounds p before its PV product); then dV += P^T dO and
//   dK += dS^T Q for the same 16 keys by half of D, P^T and dS^T by ldmatrix,
//   dO and Q by ldmatrix.trans.  Splitting D between the warp pair is what
//   fits D = 256: 16 keys x 128 columns of dK and dV are 128 float32
//   accumulators a thread.  dQ (`flash_bwd_dq_ring_mma_kernel<kD, kKT>`): 64
//   rows a block, Q and dO staged once, key tiles of kKT (64, or 32 at D =
//   256) through the ring; warp w forms S = Q K^T and dP = dO V^T for rows
//   16 (w % 4) by half the keys, dS to shared memory in bf16, then dQ += dS
//   K for its 16 rows by half of D.  A padded width (96, 160, 192) runs the
//   next instance up with zero columns, whose products are skipped.
//   GQA and MQA: the G query heads of a KV head are cut into `groups` head
//   groups, one dK/dV block per (key tile, group); each group writes float32
//   partials of dk and dv to the caller's scratch and
//   `flash_bwd_reduce_kernel` sums them in group order and rounds once to
//   bf16.  The caller sets `groups` from the shape alone
//   (kernels/flash_attention.py `flash_bwd_plan`), so the sums are the same
//   on every card: recurrentgemma's MQA train shape (8 x 16 heads on one KV
//   head, 128 keys) has 16 key tiles of (batch, KV head) and runs 8 groups,
//   128 blocks, where one group would leave 116 of 132 SMs idle.
// * float32 (the card-vs-CPU check), and bf16 at other widths: CUDA cores
//   (`flash_bwd_dkdv_kernel`, `flash_bwd_dq_kernel`), 8 warps, tiles of 32
//   keys x 32 rows: p and ds formed with one key per lane and four rows per
//   warp, then dk, dv (one key, kD / 8 columns per thread) or dq (one row,
//   kD / 8 columns) accumulated in registers; rows padded to kD + 1 floats,
//   operands converted to float32 as they are staged, never TF32.
//
// Bound on this card: phi4-mini's train shape (8 x 24 heads x 128 rows, D =
// 128, causal) does 10 D operations per visible (row, key) pair, 2 GFLOP a
// layer, against 33.7 MB of operands: bytes-bound at 0.010 ms; at 2048
// tokens, 64 GFLOP, operations-bound at 0.065 ms.  The CUDA-core design is
// bound by shared-memory issue (~1.25 loads per FMA); the tensor-core
// designs by the recomputed products and the ldmatrix traffic of mma.sync
// tiles (about one ldmatrix per two products).
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; the caller owns every buffer (delta is scratch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 256;
constexpr int kThreads = 256;  // 8 warps
constexpr int kBQ = 32;        // query rows per tile
constexpr int kBK = 32;        // keys per tile: one per lane
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);  // 4
constexpr int kLdP = kBK + 1;

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

struct Problem {
  int Hq, Hkv, Lq, Lk, D;
  int q_offset, kv_offset, kv_valid, causal, window;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(const Problem& p, int qi, int j) {
  const int qpos = p.q_offset + qi;
  const int kpos = p.kv_offset + j;
  bool ok = j < p.kv_valid;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Stage `n` rows of width D from `src` (row stride D) into `dst` (row stride
// ld, kD columns): rows past `n` and columns past D are zeros.
template <typename T, int kD>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int n,
                                           int rows, int D) {
  constexpr int ld = kD + 1;
  for (int i = threadIdx.x; i < rows * kD; i += kThreads) {
    const int r = i / kD;
    const int d = i - r * kD;
    dst[r * ld + d] = (r < n && d < D) ? to_f(src[static_cast<long long>(r) * D + d]) : 0.f;
  }
}

// p and ds of one (query tile, key tile) pair into shared memory.  Thread:
// key `lane`, rows warp * 4 .. + 3.  qi0 / j0: the tiles' first query index
// and key; nq / nk: their live rows and keys.
template <int kD>
__device__ __forceinline__ void tile_p_ds(const Problem& p, const float* qs, const float* dos,
                                          const float* ks, const float* vs, const float* lse_s,
                                          const float* delta_s, float* ps, float* dss, int qi0,
                                          int nq, int j0, int nk) {
  constexpr int ld = kD + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
  const float* kr = ks + lane * ld;
  const float* vr = vs + lane * ld;
  const float* qr = qs + warp * kRowsPerWarp * ld;
  const float* dr = dos + warp * kRowsPerWarp * ld;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    const float kd = kr[d];
    const float vd = vr[d];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r] = fmaf(qr[r * ld + d], kd, s[r]);
      dp[r] = fmaf(dr[r * ld + d], vd, dp[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = warp * kRowsPerWarp + r;
    float pr = 0.f, ds = 0.f;
    if (i < nq && lane < nk && visible(p, qi0 + i, j0 + lane)) {
      const float raw = s[r] * p.scale;
      float sv = raw, dcap = 1.f;
      if (p.softcap > 0.f) {
        const float t = tanhf(raw / p.softcap);
        sv = p.softcap * t;
        dcap = 1.f - t * t;
      }
      pr = expf(sv - lse_s[i]);
      ds = pr * (dp[r] - delta_s[i]);
      ds = ds * dcap;
      ds = ds * p.scale;
    }
    ps[i * kLdP + lane] = pr;
    dss[i * kLdP + lane] = ds;
  }
}

template <int kD>
size_t smem_bytes() {
  return sizeof(float) * (4 * 32 * (kD + 1) + 2 * kBQ * kLdP + 2 * kBQ);
}

// delta[row] = sum_d dout[row, d] * out[row, d]: one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(g[d]), to_f(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, Problem p) {
  constexpr int ld = kD + 1;
  constexpr int kCols = kD / 8;
  extern __shared__ float smem[];
  float* ks = smem;             // [kBK][ld]
  float* vs = ks + kBK * ld;    // [kBK][ld]
  float* qs = vs + kBK * ld;    // [kBQ][ld]
  float* dos = qs + kBQ * ld;   // [kBQ][ld]
  float* ps = dos + kBQ * ld;   // [kBQ][kLdP]
  float* dss = ps + kBQ * kLdP;
  float* lse_s = dss + kBQ * kLdP;
  float* delta_s = lse_s + kBQ;

  const int j0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = p.Hq / p.Hkv;
  const int D = p.D;
  const int nk = min(kBK, p.Lk - j0);
  const long long kv_off = ((static_cast<long long>(b) * p.Hkv + hk) * p.Lk + j0) * D;
  stage_rows<T, kD>(ks, k + kv_off, nk, kBK, D);
  stage_rows<T, kD>(vs, v + kv_off, nk, kBK, D);

  // the query rows that can see any of this tile's valid keys
  const int j_last = min(j0 + nk, p.kv_valid) - 1;
  int qlo = 0, qhi = p.Lq;
  if (j_last < j0) qhi = 0;  // no valid key here: dk = dv = 0
  if (p.causal) qlo = max(qlo, p.kv_offset + j0 - p.q_offset);
  if (p.window > 0) qhi = min(qhi, p.kv_offset + j_last + p.window - p.q_offset);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int jj = warp * 4 + (lane >> 3);  // this thread's key in the tile
  const int c0 = lane & 7;                // and its columns c0 + 8 c
  float acc_k[kCols], acc_v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc_k[c] = acc_v[c] = 0.f;

  for (int h = 0; h < g; ++h) {
    const long long row0 = (static_cast<long long>(b) * p.Hq + hk * g + h) * p.Lq;
    for (int qi0 = qlo; qi0 < qhi; qi0 += kBQ) {
      const int nq = min(kBQ, qhi - qi0);
      __syncthreads();  // the previous tile's p, ds, Q and dout are consumed
      stage_rows<T, kD>(qs, q + (row0 + qi0) * D, nq, kBQ, D);
      stage_rows<T, kD>(dos, dout + (row0 + qi0) * D, nq, kBQ, D);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        lse_s[i] = i < nq ? lse[row0 + qi0 + i] : 0.f;
        delta_s[i] = i < nq ? delta[row0 + qi0 + i] : 0.f;
      }
      __syncthreads();
      tile_p_ds<kD>(p, qs, dos, ks, vs, lse_s, delta_s, ps, dss, qi0, nq, j0, nk);
      __syncthreads();
      for (int i = 0; i < nq; ++i) {
        const float pr = ps[i * kLdP + jj];
        const float ds = dss[i * kLdP + jj];
        const float* dor = dos + i * ld + c0;
        const float* qr = qs + i * ld + c0;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_v[c] = fmaf(pr, dor[8 * c], acc_v[c]);
          acc_k[c] = fmaf(ds, qr[8 * c], acc_k[c]);
        }
      }
    }
  }
  if (jj < nk) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c0 + 8 * c;
      if (d < D) {
        dk[kv_off + static_cast<long long>(jj) * D + d] = from_f<T>(acc_k[c]);
        dv[kv_off + static_cast<long long>(jj) * D + d] = from_f<T>(acc_v[c]);
      }
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, Problem p) {
  constexpr int ld = kD + 1;
  constexpr int kCols = kD / 8;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBK * ld;
  float* qs = vs + kBK * ld;
  float* dos = qs + kBQ * ld;
  float* ps = dos + kBQ * ld;
  float* dss = ps + kBQ * kLdP;
  float* lse_s = dss + kBQ * kLdP;
  float* delta_s = lse_s + kBQ;

  const int qi0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int g = p.Hq / p.Hkv;
  const int hk = hq / g;
  const int D = p.D;
  const int nq = min(kBQ, p.Lq - qi0);
  const long long row0 = (static_cast<long long>(b) * p.Hq + hq) * p.Lq + qi0;
  stage_rows<T, kD>(qs, q + row0 * D, nq, kBQ, D);
  stage_rows<T, kD>(dos, dout + row0 * D, nq, kBQ, D);
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    lse_s[i] = i < nq ? lse[row0 + i] : 0.f;
    delta_s[i] = i < nq ? delta[row0 + i] : 0.f;
  }

  // the keys these rows can see
  int kb = 0;
  int ke = min(p.Lk, p.kv_valid);
  if (p.causal) ke = min(ke, p.q_offset + qi0 + nq - 1 - p.kv_offset + 1);
  if (p.window > 0) kb = max(kb, p.q_offset + qi0 - p.window + 1 - p.kv_offset);
  kb = (kb / kBK) * kBK;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ii = warp * 4 + (lane >> 3);  // this thread's row in the tile
  const int c0 = lane & 7;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  const long long kv_base = (static_cast<long long>(b) * p.Hkv + hk) * p.Lk * D;

  for (int j0 = kb; j0 < ke; j0 += kBK) {
    const int nk = min(kBK, p.Lk - j0);
    __syncthreads();  // the previous key tile, p and ds are consumed
    stage_rows<T, kD>(ks, k + kv_base + static_cast<long long>(j0) * D, nk, kBK, D);
    stage_rows<T, kD>(vs, v + kv_base + static_cast<long long>(j0) * D, nk, kBK, D);
    __syncthreads();
    tile_p_ds<kD>(p, qs, dos, ks, vs, lse_s, delta_s, ps, dss, qi0, nq, j0, nk);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float ds = dss[ii * kLdP + j];
      const float* kr = ks + j * ld + c0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(ds, kr[8 * c], acc[c]);
    }
  }
  if (ii < nq) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c0 + 8 * c;
      if (d < D) dq[(row0 + ii) * D + d] = from_f<T>(acc[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: every width up to 256
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing.
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

// c (16x8, f32) += a (16x16, bf16, row) . b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p and ds of one accumulator element from its logit and dp
__device__ __forceinline__ void p_ds(const Problem& p, float sdot, float dp, float lse,
                                     float delta, float* pr, float* ds) {
  const float raw = sdot * p.scale;
  float sv = raw, dcap = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(raw / p.softcap);
    sv = p.softcap * t;
    dcap = 1.f - t * t;
  }
  *pr = expf(sv - lse);
  float d = *pr * (dp - delta);
  d = d * dcap;
  *ds = d * p.scale;
}

constexpr int kRingThreads = 256;  // 8 warps
constexpr int kRingKeys = 64;      // dK/dV kernel: keys per block, 16 a warp pair
constexpr int kRingRows = 64;      // dQ kernel: query rows per block, 16 a warp pair

// 4 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}

// Stage `n` rows of width D (row stride D, D % 8 == 0) into [kRows][kD + 8]
// by 16-byte cp.async from every thread of the block; rows past `n` and
// columns past D are zeros.
template <int kD, int kRows>
__device__ __forceinline__ void ring_rows(bf16* dst, const bf16* __restrict__ src, int n, int D) {
  constexpr int kS = kD + 8;
  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kRingThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool in = r < n && c * 8 < D;
    cp_async16(dst + r * kS + c * 8, in ? src + static_cast<long long>(r) * D + c * 8 : src,
               in ? 16 : 0);
  }
}

// Stage `n` floats (zeros up to kRows) by 4-byte cp.async.
template <int kRows>
__device__ __forceinline__ void ring_vec(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < kRows; i += kRingThreads)
    cp_async4(dst + i, i < n ? src + i : src, i < n ? 4 : 0);
}

// acc (16 x kN8 * 8) += A . B^T over k < D: A 16 rows at `a`, B kN8 * 8 rows
// at `b`, both [row][k] with row stride kS.
template <int kS, int kN8>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const bf16* a, const bf16* b, int D,
                                         int lane) {
#pragma unroll
  for (int d0 = 0; d0 < kS - 8; d0 += 16) {
    if (d0 >= D) break;  // block-uniform: the zero columns a padded width adds
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * kS + d0 + (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < kN8 / 2; ++nb) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS + d0 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * nb], af, bf[0], bf[1]);
      mma_bf16(acc[2 * nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x kC, kC / 8 n8 accumulators) += A (16 x 16 fragment) . Z where Z
// is 16 rows (the product's k) at `z`, row stride kS, columns [0, kC) from
// `z`; column tiles at or past `live` are skipped (zeros of a padded width).
template <int kS, int kC>
__device__ __forceinline__ void mma_frag_rows(float (*acc)[4], const uint32_t* af, const bf16* z,
                                              int live, int lane) {
#pragma unroll
  for (int c0 = 0; c0 < kC; c0 += 16) {
    if (c0 >= live) break;
    uint32_t zf[4];
    ldmatrix_x4_trans(zf, z + ((lane & 7) + ((lane >> 3) & 1) * 8) * kS + c0 + (lane >> 4) * 8);
    mma_bf16(acc[c0 / 8], af, zf[0], zf[1]);
    mma_bf16(acc[c0 / 8 + 1], af, zf[2], zf[3]);
  }
}

template <int kD, int kQT>
size_t ring_dkdv_smem_bytes() {
  return sizeof(bf16) * ((2 * kRingKeys + 4 * kQT) * (kD + 8) + 2 * kRingKeys * (kQT + 8)) +
         sizeof(float) * 4 * kQT;
}
template <int kD, int kKT>
size_t ring_dq_smem_bytes() {
  return sizeof(bf16) * ((2 * kRingRows + 4 * kKT) * (kD + 8) + kRingRows * (kKT + 8)) +
         sizeof(float) * 2 * kRingRows;
}

// dK/dV: a block owns 64 keys of one (batch, KV head) and one group of
// `groups` over the KV head's G query heads, and walks the (head, tile of kQT
// rows) pairs of its group that can see its keys; Q, dO, lse and delta move
// through a 2-stage cp.async ring.  Warp w: S^T and dP^T for keys 16 (w % 4)
// by rows (w / 4) kQT / 2 of the tile; P^T and dS^T go to shared memory as
// bf16; then dV += P^T dO and dK += dS^T Q for the same 16 keys by columns
// (w / 4) kD / 2.  One group: dk, dv in bf16; more: float32 partials at
// part[gi] (dk) and part[groups + gi] (dv), each (B, Hkv, Lk, D).
template <int kD, int kQT>
__global__ void __launch_bounds__(kRingThreads, 1)
flash_bwd_dkdv_ring_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               float* __restrict__ part, int groups, Problem p) {
  constexpr int kS = kD + 8;
  constexpr int kSP = kQT + 8;       // a row of P^T / dS^T
  constexpr int kHalf = kD / 2;      // dV, dK columns per warp
  constexpr int kRN8 = kQT / 16;     // n8 tiles of a warp's kQT / 2 rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kRingKeys][kS]
  bf16* vs = ks + kRingKeys * kS;                // [kRingKeys][kS]
  bf16* qs = vs + kRingKeys * kS;                // [2][kQT][kS]
  bf16* dos = qs + 2 * kQT * kS;                 // [2][kQT][kS]
  bf16* ps = dos + 2 * kQT * kS;                 // [kRingKeys][kSP]  P^T
  bf16* dss = ps + kRingKeys * kSP;              // [kRingKeys][kSP]  dS^T
  float* lse_s = reinterpret_cast<float*>(dss + kRingKeys * kSP);  // [2][kQT]
  float* delta_s = lse_s + 2 * kQT;                                // [2][kQT]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // key tiles on the grid's slowest axis: under a causal mask the first
  // tiles see the most rows, so the heaviest blocks are dispatched first
  const int j0 = blockIdx.z * kRingKeys;
  const int hk = blockIdx.x / groups;
  const int gi = blockIdx.x - hk * groups;
  const int b = blockIdx.y;
  const int g = p.Hq / p.Hkv;
  const int hpg = g / groups;  // heads of this group
  const int D = p.D;
  const int nk = min(kRingKeys, p.Lk - j0);
  const long long kv_off = ((static_cast<long long>(b) * p.Hkv + hk) * p.Lk + j0) * D;
  ring_rows<kD, kRingKeys>(ks, k + kv_off, nk, D);
  ring_rows<kD, kRingKeys>(vs, v + kv_off, nk, D);

  // the query rows that can see any of this tile's valid keys
  const int j_last = min(j0 + nk, p.kv_valid) - 1;
  int qlo = 0, qhi = p.Lq;
  if (j_last < j0) qhi = 0;  // no valid key here: dk = dv = 0
  if (p.causal) qlo = max(qlo, p.kv_offset + j0 - p.q_offset);
  if (p.window > 0) qhi = min(qhi, p.kv_offset + j_last + p.window - p.q_offset);
  const int nqt = qhi > qlo ? (qhi - qlo + kQT - 1) / kQT : 0;
  const int ntiles = hpg * nqt;

  // tile t: head t / nqt of the group, rows qlo + (t % nqt) kQT
  auto load_tile = [&](int t, int st) {
    const int h = t / nqt;
    const int qi0 = qlo + (t - h * nqt) * kQT;
    const int nq = min(kQT, qhi - qi0);
    const long long row0 = (static_cast<long long>(b) * p.Hq + hk * g + gi * hpg + h) * p.Lq + qi0;
    ring_rows<kD, kQT>(qs + st * kQT * kS, q + row0 * D, nq, D);
    ring_rows<kD, kQT>(dos + st * kQT * kS, dout + row0 * D, nq, D);
    ring_vec<kQT>(lse_s + st * kQT, lse + row0, nq);
    ring_vec<kQT>(delta_s + st * kQT, delta + row0, nq);
  };
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();  // K, V and the first tile

  const int kw = (warp & 3) * 16;          // this warp's keys
  const int rw = (warp >> 2) * (kQT / 2);  // its rows of S^T
  const int cw = (warp >> 2) * kHalf;      // its columns of dV, dK
  float dk_acc[kHalf / 8][4], dv_acc[kHalf / 8][4];
#pragma unroll
  for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; tile t - 1, P^T and dS^T are consumed
    if (t + 1 < ntiles) load_tile(t + 1, st ^ 1);
    cp_async_commit();
    const int h = t / nqt;
    const int qi0 = qlo + (t - h * nqt) * kQT;
    const int nq = min(kQT, qhi - qi0);
    const bf16* qt = qs + st * kQT * kS;
    const bf16* dot = dos + st * kQT * kS;
    const float* lt = lse_s + st * kQT;
    const float* dlt = delta_s + st * kQT;
    float sa[kRN8][4], da[kRN8][4];
#pragma unroll
    for (int n = 0; n < kRN8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) sa[n][c] = da[n][c] = 0.f;
    mma_rows<kS, kRN8>(sa, ks + kw * kS, qt + rw * kS, D, lane);
    mma_rows<kS, kRN8>(da, vs + kw * kS, dot + rw * kS, D, lane);
    // element (n, c): key kw + lane / 4 + 8 (c >> 1), row rw + 8 n + 2 (lane % 4) + (c & 1)
#pragma unroll
    for (int n = 0; n < kRN8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = kw + (lane >> 2) + 8 * (c >> 1);
        const int il = rw + n * 8 + ((lane & 3) << 1) + (c & 1);
        float pr = 0.f, ds = 0.f;
        if (il < nq && jl < nk && visible(p, qi0 + il, j0 + jl))
          p_ds(p, sa[n][c], da[n][c], lt[il], dlt[il], &pr, &ds);
        sa[n][c] = pr;
        da[n][c] = ds;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int off = (kw + (lane >> 2) + 8 * hh) * kSP + rw + n * 8 + ((lane & 3) << 1);
        *reinterpret_cast<uint32_t*>(ps + off) = pack_bf16(sa[n][2 * hh], sa[n][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dss + off) = pack_bf16(da[n][2 * hh], da[n][2 * hh + 1]);
      }
    }
    __syncthreads();  // P^T and dS^T of the whole tile are in
#pragma unroll
    for (int kk = 0; kk < kQT / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      ldmatrix_x4(pa, ps + (kw + (lane & 15)) * kSP + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(dsa, dss + (kw + (lane & 15)) * kSP + kk * 16 + (lane >> 4) * 8);
      mma_frag_rows<kS, kHalf>(dv_acc, pa, dot + kk * 16 * kS + cw, D - cw, lane);
      mma_frag_rows<kS, kHalf>(dk_acc, dsa, qt + kk * 16 * kS + cw, D - cw, lane);
    }
  }
  cp_async_wait_all();
  const long long nel = static_cast<long long>(gridDim.y) * p.Hkv * p.Lk * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int jl = kw + (lane >> 2) + 8 * hh;
    if (jl >= nk) continue;
#pragma unroll
    for (int n = 0; n < kHalf / 8; ++n) {
      const int d = cw + n * 8 + ((lane & 3) << 1);
      if (d >= D) continue;
      const long long o = kv_off + static_cast<long long>(jl) * D + d;
      if (groups == 1) {
        *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dk_acc[n][2 * hh], dk_acc[n][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dv_acc[n][2 * hh], dv_acc[n][2 * hh + 1]);
      } else {
        *reinterpret_cast<float2*>(part + gi * nel + o) =
            make_float2(dk_acc[n][2 * hh], dk_acc[n][2 * hh + 1]);
        *reinterpret_cast<float2*>(part + (groups + gi) * nel + o) =
            make_float2(dv_acc[n][2 * hh], dv_acc[n][2 * hh + 1]);
      }
    }
  }
}

// dQ: a block owns 64 query rows of one head and walks the tiles of kKT
// keys its rows can see; K and V move through a 2-stage cp.async ring.  Warp
// w: S and dP for rows 16 (w % 4) by keys (w / 4) kKT / 2 of the tile; dS
// goes to shared memory as bf16; then dQ += dS K for the same 16 rows by
// columns (w / 4) kD / 2.
template <int kD, int kKT>
__global__ void __launch_bounds__(kRingThreads, 1)
flash_bwd_dq_ring_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, Problem p) {
  constexpr int kS = kD + 8;
  constexpr int kSD = kKT + 8;    // a row of dS
  constexpr int kHalf = kD / 2;   // dQ columns per warp
  constexpr int kKN8 = kKT / 16;  // n8 tiles of a warp's kKT / 2 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRingRows][kS]
  bf16* dos = qs + kRingRows * kS;               // [kRingRows][kS]
  bf16* ks = dos + kRingRows * kS;               // [2][kKT][kS]
  bf16* vs = ks + 2 * kKT * kS;                  // [2][kKT][kS]
  bf16* dss = vs + 2 * kKT * kS;                 // [kRingRows][kSD]
  float* lse_s = reinterpret_cast<float*>(dss + kRingRows * kSD);
  float* delta_s = lse_s + kRingRows;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // row tiles on the grid's slowest axis, last first: under a causal mask
  // the last rows see the most keys, so the heaviest blocks go first
  const int qi0 = (gridDim.z - 1 - blockIdx.z) * kRingRows;
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int g = p.Hq / p.Hkv;
  const int hk = hq / g;
  const int D = p.D;
  const int nq = min(kRingRows, p.Lq - qi0);
  const long long row0 = (static_cast<long long>(b) * p.Hq + hq) * p.Lq + qi0;
  ring_rows<kD, kRingRows>(qs, q + row0 * D, nq, D);
  ring_rows<kD, kRingRows>(dos, dout + row0 * D, nq, D);
  ring_vec<kRingRows>(lse_s, lse + row0, nq);
  ring_vec<kRingRows>(delta_s, delta + row0, nq);

  int kb = 0;
  int ke = min(p.Lk, p.kv_valid);
  if (p.causal) ke = min(ke, p.q_offset + qi0 + nq - 1 - p.kv_offset + 1);
  if (p.window > 0) kb = max(kb, p.q_offset + qi0 - p.window + 1 - p.kv_offset);
  kb = (kb / kKT) * kKT;
  const int ntiles = ke > kb ? (ke - kb + kKT - 1) / kKT : 0;
  const long long kv_base = (static_cast<long long>(b) * p.Hkv + hk) * p.Lk * D;
  auto load_tile = [&](int t, int st) {
    const int j0 = kb + t * kKT;
    const int nk = min(kKT, p.Lk - j0);
    ring_rows<kD, kKT>(ks + st * kKT * kS, k + kv_base + static_cast<long long>(j0) * D, nk, D);
    ring_rows<kD, kKT>(vs + st * kKT * kS, v + kv_base + static_cast<long long>(j0) * D, nk, D);
  };
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();  // Q, dO, lse, delta and the first key tile

  const int rw = (warp & 3) * 16;          // this warp's rows
  const int kwq = (warp >> 2) * (kKT / 2);  // its keys of S
  const int cw = (warp >> 2) * kHalf;       // its columns of dQ
  float acc[kHalf / 8][4];
#pragma unroll
  for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // key tile t has landed; tile t - 1 and dS are consumed
    if (t + 1 < ntiles) load_tile(t + 1, st ^ 1);
    cp_async_commit();
    const int j0 = kb + t * kKT;
    const int nk = min(kKT, p.Lk - j0);
    const bf16* kt = ks + st * kKT * kS;
    const bf16* vt = vs + st * kKT * kS;
    float s[kKN8][4], dp[kKN8][4];
#pragma unroll
    for (int n = 0; n < kKN8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
    mma_rows<kS, kKN8>(s, qs + rw * kS, kt + kwq * kS, D, lane);
    mma_rows<kS, kKN8>(dp, dos + rw * kS, vt + kwq * kS, D, lane);
    // element (n, c): row rw + lane / 4 + 8 (c >> 1), key kwq + 8 n + 2 (lane % 4) + (c & 1)
#pragma unroll
    for (int n = 0; n < kKN8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int il = rw + (lane >> 2) + 8 * (c >> 1);
        const int jl = kwq + n * 8 + ((lane & 3) << 1) + (c & 1);
        float pr = 0.f, ds = 0.f;
        if (il < nq && jl < nk && visible(p, qi0 + il, j0 + jl))
          p_ds(p, s[n][c], dp[n][c], lse_s[il], delta_s[il], &pr, &ds);
        s[n][c] = ds;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int off = (rw + (lane >> 2) + 8 * hh) * kSD + kwq + n * 8 + ((lane & 3) << 1);
        *reinterpret_cast<uint32_t*>(dss + off) = pack_bf16(s[n][2 * hh], s[n][2 * hh + 1]);
      }
    }
    __syncthreads();  // dS of the whole tile is in
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      uint32_t da[4];
      ldmatrix_x4(da, dss + (rw + (lane & 15)) * kSD + kk * 16 + (lane >> 4) * 8);
      mma_frag_rows<kS, kHalf>(acc, da, kt + kk * 16 * kS + cw, D - cw, lane);
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int il = rw + (lane >> 2) + 8 * hh;
    if (il >= nq) continue;
#pragma unroll
    for (int n = 0; n < kHalf / 8; ++n) {
      const int d = cw + n * 8 + ((lane & 3) << 1);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dq + (row0 + il) * D + d) =
            pack_bf16(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
}

// dk, dv = the head groups' float32 partials summed in group order, rounded
// once to bf16; part holds [2][groups][n] (dk's, then dv's), 4 values a thread.
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ part, int groups, long long n,
                        bf16* __restrict__ dk, bf16* __restrict__ dv) {
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const int which = i >= n ? 1 : 0;
  const long long j = i - which * n;
  const float* src = part + which * groups * n + j;
  float4 s = *reinterpret_cast<const float4*>(src);
  for (int gi = 1; gi < groups; ++gi) {
    const float4 t = *reinterpret_cast<const float4*>(src + gi * n);
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
    s.w += t.w;
  }
  bf16* o = (which ? dv : dk) + j;
  reinterpret_cast<uint32_t*>(o)[0] = pack_bf16(s.x, s.y);
  reinterpret_cast<uint32_t*>(o)[1] = pack_bf16(s.z, s.w);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, void* dk, void* dv, const Problem& p, int B,
           cudaStream_t s) {
  const size_t smem = smem_bytes<kD>();
  int e = allow_smem(flash_bwd_dkdv_kernel<T, kD>, smem);
  if (e) return e;
  e = allow_smem(flash_bwd_dq_kernel<T, kD>, smem);
  if (e) return e;
  const dim3 grid_kv((p.Lk + kBK - 1) / kBK, p.Hkv, B);
  flash_bwd_dkdv_kernel<T, kD><<<grid_kv, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const dim3 grid_q((p.Lq + kBQ - 1) / kBQ, p.Hq, B);
  flash_bwd_dq_kernel<T, kD><<<grid_q, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, int kQT, int kKT>
int launch_ring(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dq, void* dk, void* dv, float* part, int groups,
                const Problem& p, int B, cudaStream_t s) {
  const size_t smem_kv = ring_dkdv_smem_bytes<kD, kQT>();
  const size_t smem_q = ring_dq_smem_bytes<kD, kKT>();
  int e = allow_smem(flash_bwd_dkdv_ring_mma_kernel<kD, kQT>, smem_kv);
  if (e) return e;
  e = allow_smem(flash_bwd_dq_ring_mma_kernel<kD, kKT>, smem_q);
  if (e) return e;
  const dim3 grid_kv(p.Hkv * groups, B, (p.Lk + kRingKeys - 1) / kRingKeys);
  flash_bwd_dkdv_ring_mma_kernel<kD, kQT><<<grid_kv, kRingThreads, smem_kv, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      part, groups, p);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const dim3 grid_q(p.Hq, B, (p.Lq + kRingRows - 1) / kRingRows);
  flash_bwd_dq_ring_mma_kernel<kD, kKT><<<grid_q, kRingThreads, smem_q, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), p);
  e = static_cast<int>(cudaGetLastError());
  if (e || groups == 1) return e;
  const long long n = static_cast<long long>(B) * p.Hkv * p.Lk * p.D;
  const long long blocks = (2 * n / 4 + 255) / 256;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      part, groups, n, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_all(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, float* part,
               int groups, const Problem& p, int B, int path, cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * p.Hq * p.Lq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows, p.D);
  const int e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  if (path == 1) {
    if (p.D <= 64)
      return launch_ring<64, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, part, groups, p, B, s);
    if (p.D <= 128)
      return launch_ring<128, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, part, groups, p, B,
                                      s);
    return launch_ring<256, 32, 32>(q, k, v, dout, lse, delta, dq, dk, dv, part, groups, p, B, s);
  }
  if (p.D <= 64) return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, p, B, s);
  if (p.D <= 128) return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, p, B, s);
  return launch<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, p, B, s);
}

}  // namespace

// q, out, dout, dq: (B, Hq, Lq, D); k, v, dk, dv: (B, Hkv, Lk, D); all
// contiguous, one dtype: 0 = float32, 1 = bfloat16.  lse: (B, Hq, Lq)
// float32, the forward's; delta: (B, Hq, Lq) float32 scratch.  path 1 =
// tensor cores (bf16, D % 8 == 0, D <= 256, 16-byte aligned q/k/v/dout), 0
// = CUDA cores.  groups: head groups per KV head in path 1's dK/dV kernel
// (it divides Hq / Hkv; 1 on path 0); above 1, part is float32 scratch
// of 2 * groups * B * Hkv * Lk * D, 16-byte aligned.  Returns
// cudaGetLastError() after the launches (or the error that refused one).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lk,
                                   int D, int q_offset, int kv_offset, int kv_valid_len,
                                   int causal, int window, float softcap, float scale, int dtype,
                                   int path, int groups, void* part, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0 || D <= 0 ||
      D > kMaxD || kv_valid_len <= 0 || Hq > 65535 || B > 65535 || (dtype != 0 && dtype != 1) ||
      path < 0 || path > 1 || groups < 1 || (Hq / Hkv) % groups != 0 ||
      (path == 1 && ((Lk + 63) / 64 > 65535 || (Lq + 63) / 64 > 65535))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned16 = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  if (path == 1 && (dtype != 1 || D % 8 != 0 || D > 256 || !aligned16(q) || !aligned16(k) ||
                    !aligned16(v) || !aligned16(dout)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups > 1 && (path != 1 || part == nullptr || !aligned16(part)))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.kv_valid = kv_valid_len < Lk ? kv_valid_len : Lk;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  if (dtype == 0)
    return launch_all<float>(q, k, v, out, dout, l, dl, dq, dk, dv, pt, groups, p, B, path, s);
  return launch_all<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, pt, groups, p, B, path,
                                   s);
}
