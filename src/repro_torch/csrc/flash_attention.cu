// GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (`_kernel`, called through
// `pl.pallas_call`).  It computes the forward function of the reference's
// `chunked_attention` (src/repro/models/common.py), which the model path
// calls, not the Pallas kernel's grid:
//
//   s[i, j] = scale * q[i] . k[j]             (float32)
//   s       = softcap * tanh(s / softcap)     (softcap > 0)
//   key j is valid iff j < kv_valid_len, and, with kpos = kv_offset + j and
//   qpos = q_offset + i, kpos <= qpos (causal) and kpos > qpos - window
//   (window > 0); an invalid entry's logit is -1e30
//   out[i]  = sum_j p[i, j] v[j] / max(sum_j p[i, j], 1e-30), online softmax,
//             p rounded to v's dtype before the PV product (as the reference
//             casts it), m / l / acc in float32, out in q's dtype.
//
// Layout (B, H, L, D), contiguous; the g = Hq / Hkv query heads of a KV head
// share its K/V tiles.
//
// Design: one block of 8 warps per (batch, KV head, 32 query rows); a query
// row is a (head in group, query index) pair and each warp owns 4 rows, with
// m, l and its D/32 accumulator columns in registers.  The block walks the
// keys in tiles of 32, staged in shared memory as float32 (rows padded to
// D + 1 so that lane j reads key j's row without bank conflicts).  Lane j
// computes key j's logit for each row; the warp reduces max and sum by
// shuffles; the PV product broadcasts p_j by shuffle while each lane adds
// its own columns of v_j.  Ragged Lq and Lk are masked in the kernel: no
// padding copies.  Tiles wholly past kv_valid_len, past the block's last
// causal position or before its first window position are skipped, so the
// decode step reads only the valid rows of the cache.
//
// Bound on this card: at the serve path's shapes (decode q (4, 16, 1, 64)
// against a (4, 8, 128, 64) cache; prefill q (1, 16, 16, 64)) the kernel
// moves well under a megabyte and does a few MFLOP, so one launch is bound
// by launch latency, and by bytes beyond that: skipping the invalid cache
// rows is what the design does about bytes.  The matrix products run on the
// CUDA cores in float32; tensor cores (mma / wgmma) and a TMA pipeline are
// later work for long prefills.
//
// Differs from the reference only for a row that has no valid key at all
// (every key masked): the reference then averages the masked values, this
// kernel writes 0.  The model never asks for such a row.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the caller owns `out`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                       // keys per tile: one per lane
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
                 int Lq, int Lk, int D, int q_offset, int kv_offset,
                 int kv_valid, int causal, int window, float softcap,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;               // [kBK][ld]
  float* vs = ks + kBK * ld;      // [kBK][ld]
  float* qs = vs + kBK * ld;      // [kRows][D]

  const int g = Hq / Hkv;
  const int bh = blockIdx.y;      // b * Hkv + kv head
  const int b = bh / Hkv;
  const int hk = bh - b * Hkv;
  const int rows = g * Lq;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the block's query rows, head-in-group major
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int rr = row0 + r;
    float val = 0.f;
    if (rr < rows) {
      const int hg = rr / Lq;
      const int qi = rr - hg * Lq;
      const long long off = ((static_cast<long long>(b) * Hq + hk * g + hg) * Lq + qi) * D + d;
      val = to_f(q[off]);
    }
    qs[i] = val;
  }

  // the keys any row of this block can see
  const int row_last = min(rows, row0 + kRows) - 1;
  const int hg0 = row0 / Lq;
  const int hg1 = row_last / Lq;
  const int qi_min = (hg0 == hg1) ? row0 - hg0 * Lq : 0;
  const int qi_max = (hg0 == hg1) ? row_last - hg1 * Lq : Lq - 1;
  int key_end = min(Lk, kv_valid);
  if (causal) key_end = min(key_end, q_offset + qi_max - kv_offset + 1);
  int key_begin = 0;
  if (window > 0) key_begin = max(0, q_offset + qi_min - window + 1 - kv_offset);
  key_begin = (key_begin / kBK) * kBK;

  float m_r[kRowsPerWarp];
  float l_r[kRowsPerWarp];
  float acc[kRowsPerWarp][kDPerLane];
  int qpos_r[kRowsPerWarp];
  bool live_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = row0 + warp * kRowsPerWarp + r;
    live_r[r] = rr < rows;
    qpos_r[r] = q_offset + (live_r[r] ? rr % Lq : 0);
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[r][c] = 0.f;
  }

  const long long kv_base = static_cast<long long>(bh) * Lk * D;
  for (int t0 = key_begin; t0 < key_end; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    const int tn = min(kBK, key_end - t0);
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      float kx = 0.f, vx = 0.f;
      if (j < tn) {
        const long long off = kv_base + static_cast<long long>(t0 + j) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[j * ld + d] = kx;
      vs[j * ld + d] = vx;
    }
    __syncthreads();

    const int kpos = kv_offset + t0 + lane;
    const bool in_tile = lane < tn;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (!live_r[r]) continue;  // warp-uniform
      const float* qrow = qs + (warp * kRowsPerWarp + r) * D;
      float s = kNegInf;
      if (in_tile) {
        const float* krow = ks + lane * ld;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], krow[d], dot);
        float sv = dot * scale;
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        bool ok = true;
        if (causal) ok = ok && (kpos <= qpos_r[r]);
        if (window > 0) ok = ok && (kpos > qpos_r[r] - window);
        if (ok) s = sv;
      }
      const float m_new = fmaxf(m_r[r], warp_max(s));
      const float p = in_tile ? expf(s - m_new) : 0.f;
      const float corr = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * corr + warp_sum(p);
      m_r[r] = m_new;
      const float pv = to_f(from_f<T>(p));  // p.astype(v.dtype)
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) acc[r][c] *= corr;
      for (int j = 0; j < tn; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
        const float* vrow = vs + j * ld;
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[r][c] = fmaf(pj, vrow[d], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!live_r[r]) continue;
    const int rr = row0 + warp * kRowsPerWarp + r;
    const int hg = rr / Lq;
    const int qi = rr - hg * Lq;
    const long long base = ((static_cast<long long>(b) * Hq + hk * g + hg) * Lq + qi) * D;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[base + d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Lq, int Lk, int D, int q_offset, int kv_offset,
           int kv_valid, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int rows = (Hq / Hkv) * Lq;
  const dim3 grid((rows + kRows - 1) / kRows, B * Hkv);
  const size_t smem = sizeof(float) * (2 * kBK * (D + 1) + kRows * D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Lq, Lk, D,
      q_offset, kv_offset, kv_valid, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D); all contiguous, one dtype:
// dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (or the error that refused it).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int Lq,
                               int Lk, int D, int q_offset, int kv_offset,
                               int kv_valid_len, int causal, int window,
                               float softcap, float scale, int dtype,
                               void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0 ||
      D <= 0 || D > kMaxD || kv_valid_len <= 0 ||
      static_cast<long long>(B) * Hkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, out, B, Hq, Hkv, Lq, Lk, D, q_offset,
                         kv_offset, kv_valid_len, causal, window, softcap,
                         scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Lq, Lk, D, q_offset,
                                 kv_offset, kv_valid_len, causal, window,
                                 softcap, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
