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
//   key j's position kpos is kv_offset + j, or kv_positions[j] for a ring
//   cache (a negative position marks an empty slot); with qpos = q_offset +
//   i, key j is valid iff j < kv_valid_len, kpos >= 0 (ring), kpos <= qpos
//   (causal) and kpos > qpos - window (window > 0); an invalid entry's logit
//   is -1e30
//   out[i]  = sum_j p[i, j] v[j] / max(sum_j p[i, j], 1e-30), online softmax,
//             p rounded to v's dtype before the PV product (as the reference
//             casts it), m / l / acc in float32, out in q's dtype.
//
// Layout (B, H, L, D), contiguous, D <= 256; the g = Hq / Hkv query heads of
// a KV head share its K/V tiles.  A query row of a KV head is a (head in
// group, query index) pair, head-major.
//
// Two block designs, both instantiated for D <= 64, <= 128 and <= 256 (the
// padded width kD is a template parameter, so the narrow heads keep their
// registers and every loop over D unrolls):
//
// * bf16, D % 8 == 0 (every model path): tensor cores.  A warp owns 16 query
//   rows, the M side of mma.sync.m16n8k16 (bf16 in, f32 accumulate); at
//   recurrentgemma's MQA decode the 16 heads of the group fill it exactly.
//   A block has WR row warps (the plan's block_rows / 16: the wrapper's
//   `flash_plan` owns the block design, and the launcher refuses a plan
//   that does not fit the instantiated tile) and WK key warps (WR * WK <=
//   4): the key warps
//   take alternate 16-key sub-tiles of each K/V tile with their own (m, l,
//   acc) and are merged in shared memory at the end, in a fixed order, so a
//   decode step's 16 rows still keep 4 warps busy.  Q is loaded once; K and
//   V tiles (64 keys, 32 at kD = 256) stay bf16 in shared memory, loaded by
//   16-byte cp.async into a 2-stage ring (tile t+1 loads while tile t
//   computes), rows padded by 16 bytes so that ldmatrix is conflict-free.
//   S = Q.K^T takes Q by ldmatrix and K by ldmatrix; P (the S accumulator,
//   rounded to bf16 in registers: p.astype(v.dtype)) is the A operand of
//   O += P.V, with V read by ldmatrix.trans.  bf16 products are exact in
//   the f32 accumulator, so against the reference only the summation order
//   changes.
// * float32 (the card-vs-CPU cross-check), or a bf16 width not a multiple of
//   8: CUDA-core FMAs, never TF32 (which keeps ~3 digits).  8 warps of 4
//   rows; lane j computes key j's logit (a kD-long unrolled dot product
//   against rows padded to kD + 1 floats: no bank conflicts); K/V loaded 16
//   bytes a thread where D % 4 == 0.
//
// Split-KV (flash-decoding): when B * Hkv * row tiles cannot fill the card
// the wrapper splits the key range into `splits` ranges of `keys_per_split`
// (a multiple of the tile) from `key_base`, blockIdx.z picks the range, and
// each block writes a partial (o unnormalised, m, l) in float32 to scratch
// the wrapper allocates; `flash_merge_kernel`, a second small kernel (one
// block per row), combines the partials of each row in split order
// (deterministic, no atomics) and writes out.  (Merging in the last block
// of each row tile behind an atomic counter instead saves the launch but
// serialises the merge on one block, which measured slower.)  A range with no valid key for a row writes m = -1e30, l = 0,
// o = 0, which the merge weighs by exp(-1e30 - M) = 0.  With one split the block writes out itself.
// Without kv_positions, tiles wholly past kv_valid_len, past the block's
// last causal position or before its first window position are skipped; a
// ring's positions are not monotone in j, so with kv_positions every tile
// is read and masked key by key.
//
// Bound on this card: the decode steps move K/V once (recurrentgemma's
// 128-slot ring: 0.5 MB; a 2048-slot ring: 8.4 MB, 0.0025 ms at 3.35 TB/s)
// and do 4 * D flops per (row, key): bytes-bound, so the design is about
// spreading the keys over enough SMs (split-KV) and keeping loads in flight
// (the cp.async ring).  A long causal prefill (L = 2048, D = 256, 16 heads:
// ~34 GFLOP) is operations-bound: there the tensor cores carry it; wgmma
// tiles of 64 rows are later work.
//
// A row with no valid key at all (every key masked) is written as 0; the
// reference then averages the masked values.  The model never asks for
// such a row.
//
// With a non-null `lse` each row's log-sum-exp m + log(max(l, 1e-30)) is
// written as float32 (B, Hq, Lq): by the block itself with one split, by
// the merge kernel from the merged (M, L) with several.  The backward
// (flash_attention_bwd.cu) recomputes the probabilities from it.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; the caller owns `out` and the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 256;
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

__device__ __forceinline__ bool no_key(float m) { return m <= 0.5f * kNegInf; }

// What one block of either design needs to know about its problem.
struct Problem {
  int Hq, Hkv, Lq, Lk, D;
  int q_offset, kv_offset, kv_valid, causal, window;
  float softcap, scale;
  const int* kv_positions;  // null, or (Lk,) ring positions
  int block_rows, block_keys;  // the plan's block: query rows, keys per tile
  int key_base, keys_per_split, splits;
  float* part_o;            // [splits][B*Hkv][rows][D] (splits > 1)
  float* part_m;            // [splits][B*Hkv][rows]
  float* part_l;
  float* lse;               // null, or (B, Hq, Lq) float32 log-sum-exp
};

// The key range [begin, end) that the block of rows [row0, row0 + nrows)
// of KV head bh must read in split `split`, rounded out to tiles of `bk`.
__device__ __forceinline__ void key_range(const Problem& p, int row0, int nrows,
                                          int split, int bk, int* begin, int* end) {
  const int rows = (p.Hq / p.Hkv) * p.Lq;
  const int row_last = min(rows, row0 + nrows) - 1;
  const int hg0 = row0 / p.Lq;
  const int hg1 = row_last / p.Lq;
  const int qi_min = (hg0 == hg1) ? row0 - hg0 * p.Lq : 0;
  const int qi_max = (hg0 == hg1) ? row_last - hg1 * p.Lq : p.Lq - 1;
  int e = min(p.Lk, p.kv_valid);
  int b = 0;
  if (p.kv_positions == nullptr) {
    if (p.causal) e = min(e, p.q_offset + qi_max - p.kv_offset + 1);
    if (p.window > 0) b = max(0, p.q_offset + qi_min - p.window + 1 - p.kv_offset);
  }
  const int s0 = p.key_base + split * p.keys_per_split;
  b = max(b, s0);
  e = min(e, s0 + p.keys_per_split);
  *begin = (b / bk) * bk;
  *end = e;
}

// Whether key `j` (position `kpos`) is visible from query position `qpos`.
__device__ __forceinline__ bool visible(const Problem& p, int j, int kpos, int qpos) {
  bool ok = (p.kv_positions != nullptr) ? kpos >= 0 : j < p.kv_valid;
  ok = ok && j < p.Lk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

__device__ __forceinline__ float logit(const Problem& p, float dot) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
  return s;
}

// Where row `rr` of KV head bh goes: the output row (one split, scaled by
// 1 / l) or the unnormalised partial row (several).  A row with no valid
// key writes zeros.
template <typename T>
struct RowOut {
  T* out;
  float* part;
  float scale;
  __device__ __forceinline__ RowOut(const Problem& p, T* o, int b, int bh, int rr, int split,
                                    float m, float l) {
    const int g = p.Hq / p.Hkv;
    const int rows = g * p.Lq;
    const bool none = no_key(m);
    out = nullptr;
    part = nullptr;
    if (p.splits == 1) {
      const int hk = bh - b * p.Hkv;
      const int hg = rr / p.Lq;
      const int qi = rr - hg * p.Lq;
      out = o + ((static_cast<long long>(b) * p.Hq + hk * g + hg) * p.Lq + qi) * p.D;
      scale = none ? 0.f : 1.f / fmaxf(l, 1e-30f);
    } else {
      part = p.part_o + ((static_cast<long long>(split) * gridDim.y + bh) * rows + rr) * p.D;
      scale = none ? 0.f : 1.f;
    }
  }
  __device__ __forceinline__ void put(int d, float acc) const {
    if (out != nullptr) {
      out[d] = from_f<T>(acc * scale);
    } else {
      part[d] = acc * scale;
    }
  }
};

__device__ __forceinline__ float row_lse(float m, float l) {
  return m + logf(fmaxf(l, 1e-30f));
}

// One split: the row's log-sum-exp (when asked for); several: the row's
// partial (m, l) for the merge.
__device__ __forceinline__ void store_ml(const Problem& p, int bh, int rr, int split,
                                         float m, float l) {
  if (p.splits == 1) {
    if (p.lse != nullptr) {
      const int g = p.Hq / p.Hkv;
      const int b = bh / p.Hkv;
      const int hk = bh - b * p.Hkv;
      const int hg = rr / p.Lq;
      const int qi = rr - hg * p.Lq;
      p.lse[(static_cast<long long>(b) * p.Hq + hk * g + hg) * p.Lq + qi] = row_lse(m, l);
    }
    return;
  }
  const int rows = (p.Hq / p.Hkv) * p.Lq;
  const long long r = (static_cast<long long>(split) * gridDim.y + bh) * rows + rr;
  const bool none = no_key(m);
  p.part_m[r] = none ? kNegInf : m;
  p.part_l[r] = none ? 0.f : l;
}

// ---------------------------------------------------------------------------
// PTX wrappers (sm_80+): cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing.
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// Key warps of the mma design beside `wr` row warps (the plan's
// block_rows / 16).
__host__ __device__ inline int mma_key_warps(int wr, int bn) {
  const int w = 4 / wr;
  return w < bn / 16 ? w : bn / 16;  // >= 1: 1 <= wr <= 4 and bn >= 32
}

template <int kD>
struct MmaTile {
  static constexpr int kBN = kD > 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int kS = kD + 8;               // padded row (bf16): 16 bytes
  static size_t smem_bytes(int wr) {
    return sizeof(bf16) * (4 * kBN * kS + wr * 16 * kS) + sizeof(int) * 2 * kBN;
  }
};

template <int kD>
__global__ void __launch_bounds__(128)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, Problem p) {
  constexpr int kBN = MmaTile<kD>::kBN;
  constexpr int kS = MmaTile<kD>::kS;
  constexpr int kChunks = kD / 8;  // 16-byte chunks per row
  constexpr int kNT = kD / 8;      // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [2][kBN][kS]
  bf16* vs = ks + 2 * kBN * kS;                  // [2][kBN][kS]
  bf16* qs = vs + 2 * kBN * kS;                  // [WR * 16][kS]

  const int g = p.Hq / p.Hkv;
  const int rows = g * p.Lq;
  const int WR = p.block_rows / 16;
  const int WK = mma_key_warps(WR, kBN);
  int* kp = reinterpret_cast<int*>(qs + WR * 16 * kS);  // [2][kBN]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp % WR;
  const int wk = warp / WR;
  const int bh = blockIdx.y;
  const int b = bh / p.Hkv;
  const int hk = bh - b * p.Hkv;
  const int nrows = WR * 16;
  const int row0 = blockIdx.x * nrows;
  const int split = blockIdx.z;
  int kb, ke;
  key_range(p, row0, nrows, split, kBN, &kb, &ke);
  const int nt = ke > kb ? (ke - kb + kBN - 1) / kBN : 0;

  // Q once: rows past `rows` and columns past D read as zeros
  for (int i = tid; i < nrows * kChunks; i += nthreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int rr = row0 + r;
    const bf16* src = q;
    int bytes = 0;
    if (rr < rows && c * 8 < p.D) {
      const int hg = rr / p.Lq;
      const int qi = rr - hg * p.Lq;
      src = q + ((static_cast<long long>(b) * p.Hq + hk * g + hg) * p.Lq + qi) * p.D + c * 8;
      bytes = 16;
    }
    cp_async16(qs + r * kS + c * 8, src, bytes);
  }
  const long long kv_base = static_cast<long long>(bh) * p.Lk * p.D;
  auto load_tile = [&](int t0, int st) {
    bf16* kd = ks + st * kBN * kS;
    bf16* vd = vs + st * kBN * kS;
    for (int i = tid; i < kBN * kChunks; i += nthreads) {
      const int j = i / kChunks;
      const int c = i - j * kChunks;
      const bool in = t0 + j < p.Lk && c * 8 < p.D;
      const long long off = in ? kv_base + static_cast<long long>(t0 + j) * p.D + c * 8 : 0;
      cp_async16(kd + j * kS + c * 8, k + off, in ? 16 : 0);
      cp_async16(vd + j * kS + c * 8, v + off, in ? 16 : 0);
    }
    if (p.kv_positions != nullptr) {
      for (int j = tid; j < kBN; j += nthreads)
        kp[st * kBN + j] = t0 + j < p.Lk ? p.kv_positions[t0 + j] : -1;
    }
  };

  // this thread's two rows of its warp's 16: lane / 4 and lane / 4 + 8
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = row0 + wr * 16 + (lane >> 2) + 8 * h;
    qpos[h] = p.q_offset + (rr < rows ? rr % p.Lq : 0);
  }
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (nt > 0) load_tile(kb, 0);
  cp_async_commit();
  const bf16* qw = qs + wr * 16 * kS;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt) {
      load_tile(kb + (t + 1) * kBN, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const int t0 = kb + t * kBN;
    for (int sub = wk; sub < kBN / 16; sub += WK) {
      const bf16* kt = ks + (st * kBN + sub * 16) * kS;
      const bf16* vt = vs + (st * kBN + sub * 16) * kS;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int d0 = 0; d0 < kD; d0 += 16) {
        uint32_t a[4], kb4[4];
        ldmatrix_x4(a, qw + (lane & 15) * kS + d0 + (lane >> 4) * 8);
        ldmatrix_x4(kb4, kt + ((lane & 7) + ((lane >> 4) << 3)) * kS + d0 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], a, kb4[0], kb4[1]);
        mma_bf16(s[1], a, kb4[2], kb4[3]);
      }
      // mask, running max and sum; element (t8, c) is row lane/4 + 8 (c >> 1),
      // key sub * 16 + t8 * 8 + 2 (lane % 4) + (c & 1) of the tile
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int t8 = 0; t8 < 2; ++t8) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jt = sub * 16 + t8 * 8 + ((lane & 3) << 1) + (c & 1);
          const int j = t0 + jt;
          const int kpos = p.kv_positions != nullptr ? kp[st * kBN + jt] : p.kv_offset + j;
          const bool ok = j < ke && visible(p, j, kpos, qpos[c >> 1]);
          const float sv = ok ? logit(p, s[t8][c]) : kNegInf;
          s[t8][c] = sv;
          mx[c >> 1] = fmaxf(mx[c >> 1], sv);
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = expf(m_r[h] - mx[h]);
      }
#pragma unroll
      for (int t8 = 0; t8 < 2; ++t8) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[t8][c] = expf(s[t8][c] - mx[c >> 1]);
          rs[c >> 1] += s[t8][c];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l_r[h] = l_r[h] * corr[h] + rs[h];
        m_r[h] = mx[h];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // P (rounded to bf16) as the A operand of P.V
      uint32_t pa[4];
      pa[0] = pack_bf16(s[0][0], s[0][1]);
      pa[1] = pack_bf16(s[0][2], s[0][3]);
      pa[2] = pack_bf16(s[1][0], s[1][1]);
      pa[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int d0 = 0; d0 < kD; d0 += 16) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kS + d0 + (lane >> 4) * 8);
        mma_bf16(acc[d0 / 8], pa, vb[0], vb[1]);
        mma_bf16(acc[d0 / 8 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage st is consumed before tile t + 2 overwrites it
  }
  cp_async_wait<0>();
  __syncthreads();

  // key warps 1.. hand (m, l, acc) to key warp 0 through the K/V ring's
  // memory, merged in key-warp order
  if (WK > 1) {
    float* red = reinterpret_cast<float*>(smem_raw);
    constexpr int kLd = kD + 4;  // padded row: the 8 rows of a store hit 8 banks
    const int slot_floats = 16 * kLd + 32;
    if (wk > 0) {
      float* sl = red + ((wk - 1) * WR + wr) * slot_floats;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sl[((lane >> 2) + 8 * (c >> 1)) * kLd + n * 8 + ((lane & 3) << 1) + (c & 1)] = acc[n][c];
      if ((lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sl[16 * kLd + (lane >> 2) + 8 * h] = m_r[h];
          sl[16 * kLd + 16 + (lane >> 2) + 8 * h] = l_r[h];
        }
      }
    }
    __syncthreads();
    if (wk == 0) {
      for (int w2 = 1; w2 < WK; ++w2) {
        const float* sl = red + ((w2 - 1) * WR + wr) * slot_floats;
        float c1[2], c2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m2 = sl[16 * kLd + (lane >> 2) + 8 * h];
          const float l2 = sl[16 * kLd + 16 + (lane >> 2) + 8 * h];
          const float M = fmaxf(m_r[h], m2);
          c1[h] = expf(m_r[h] - M);
          c2[h] = expf(m2 - M);
          l_r[h] = l_r[h] * c1[h] + l2 * c2[h];
          m_r[h] = M;
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[n][c] = acc[n][c] * c1[c >> 1] +
                        sl[((lane >> 2) + 8 * (c >> 1)) * kLd + n * 8 + ((lane & 3) << 1) + (c & 1)] *
                            c2[c >> 1];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = row0 + wr * 16 + (lane >> 2) + 8 * h;
    if (wk != 0 || rr >= rows) continue;
    if ((lane & 3) == 0) store_ml(p, bh, rr, split, m_r[h], l_r[h]);
    const RowOut<bf16> ro(p, out, b, bh, rr, split, m_r[h], l_r[h]);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + ((lane & 3) << 1) + e;
        if (d < p.D) ro.put(d, acc[n][2 * h + e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 (and bf16 widths that are not a multiple of 8) on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kFmaWarps = 8;
constexpr int kFmaThreads = kFmaWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kFmaRows = kFmaWarps * kRowsPerWarp;  // query rows per block
constexpr int kFmaBK = 32;                          // keys per tile: one per lane

template <int kD>
size_t fma_smem_bytes() {
  return sizeof(float) * (2 * kFmaBK * (kD + 1) + kFmaRows * kD);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, Problem p) {
  constexpr int kDPerLane = kD / 32;
  constexpr int ld = kD + 1;
  extern __shared__ float smem[];
  float* ks = smem;               // [kFmaBK][ld]
  float* vs = ks + kFmaBK * ld;   // [kFmaBK][ld]
  float* qs = vs + kFmaBK * ld;   // [kFmaRows][kD]

  const int g = p.Hq / p.Hkv;
  const int bh = blockIdx.y;
  const int b = bh / p.Hkv;
  const int hk = bh - b * p.Hkv;
  const int rows = g * p.Lq;
  const int row0 = blockIdx.x * kFmaRows;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int D = p.D;

  for (int i = tid; i < kFmaRows * kD; i += kFmaThreads) {
    const int r = i / kD;
    const int d = i - r * kD;
    const int rr = row0 + r;
    float val = 0.f;
    if (rr < rows && d < D) {
      const int hg = rr / p.Lq;
      const int qi = rr - hg * p.Lq;
      val = to_f(q[((static_cast<long long>(b) * p.Hq + hk * g + hg) * p.Lq + qi) * D + d]);
    }
    qs[i] = val;
  }
  int kb, ke;
  key_range(p, row0, kFmaRows, split, kFmaBK, &kb, &ke);

  float m_r[kRowsPerWarp];
  float l_r[kRowsPerWarp];
  float acc[kRowsPerWarp][kDPerLane];
  int qpos_r[kRowsPerWarp];
  bool live_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = row0 + warp * kRowsPerWarp + r;
    live_r[r] = rr < rows;
    qpos_r[r] = p.q_offset + (live_r[r] ? rr % p.Lq : 0);
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[r][c] = 0.f;
  }

  const long long kv_base = static_cast<long long>(bh) * p.Lk * D;
  const bool vec4 = sizeof(T) == 4 && (D & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  for (int t0 = kb; t0 < ke; t0 += kFmaBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    const int tn = min(kFmaBK, ke - t0);
    if (vec4) {  // 16-byte loads
      for (int i = tid; i < kFmaBK * (kD / 4); i += kFmaThreads) {
        const int j = i / (kD / 4);
        const int d = (i - j * (kD / 4)) * 4;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (j < tn && d < D) {
          const long long off = kv_base + static_cast<long long>(t0 + j) * D + d;
          kx = *reinterpret_cast<const float4*>(k + off);
          vx = *reinterpret_cast<const float4*>(v + off);
        }
        float* kr = ks + j * ld + d;
        float* vr = vs + j * ld + d;
        kr[0] = kx.x; kr[1] = kx.y; kr[2] = kx.z; kr[3] = kx.w;
        vr[0] = vx.x; vr[1] = vx.y; vr[2] = vx.z; vr[3] = vx.w;
      }
    } else {
      for (int i = tid; i < kFmaBK * kD; i += kFmaThreads) {
        const int j = i / kD;
        const int d = i - j * kD;
        float kx = 0.f, vx = 0.f;
        if (j < tn && d < D) {
          const long long off = kv_base + static_cast<long long>(t0 + j) * D + d;
          kx = to_f(k[off]);
          vx = to_f(v[off]);
        }
        ks[j * ld + d] = kx;
        vs[j * ld + d] = vx;
      }
    }
    __syncthreads();

    const bool in_tile = lane < tn;
    const int j = t0 + lane;
    int kpos = p.kv_offset + j;
    if (p.kv_positions != nullptr) kpos = in_tile ? p.kv_positions[j] : -1;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (!live_r[r]) continue;  // warp-uniform
      const float* qrow = qs + (warp * kRowsPerWarp + r) * kD;
      float s = kNegInf;
      if (in_tile) {
        const float* krow = ks + lane * ld;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) dot = fmaf(qrow[d], krow[d], dot);
        if (visible(p, j, kpos, qpos_r[r])) s = logit(p, dot);
      }
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[r], mx);
      const float pr = in_tile ? expf(s - m_new) : 0.f;
      const float corr = expf(m_r[r] - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_r[r] = l_r[r] * corr + sum;
      m_r[r] = m_new;
      const float pv = to_f(from_f<T>(pr));  // p.astype(v.dtype)
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) acc[r][c] *= corr;
      for (int jj = 0; jj < tn; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pv, jj);
        const float* vrow = vs + jj * ld;
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) acc[r][c] = fmaf(pj, vrow[lane + 32 * c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!live_r[r]) continue;
    const int rr = row0 + warp * kRowsPerWarp + r;
    if (lane == 0) store_ml(p, bh, rr, split, m_r[r], l_r[r]);
    const RowOut<T> ro(p, out, b, bh, rr, split, m_r[r], l_r[r]);
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ro.put(d, acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// split-KV merge: one block per (row, KV head), splits combined in order
// ---------------------------------------------------------------------------
constexpr int kMergeThreads = 128;
constexpr int kMaxSplits = 256;

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
flash_merge_kernel(T* __restrict__ out, const float* __restrict__ po,
                   const float* __restrict__ pm, const float* __restrict__ pl,
                   float* __restrict__ lse, int splits, int Hq, int Hkv, int Lq, int D) {
  __shared__ float w[kMaxSplits];
  __shared__ float tot[2];  // M, L
  const int rr = blockIdx.x;
  const int bh = blockIdx.y;
  const int BH = gridDim.y;
  const int rows = gridDim.x;
  if (threadIdx.x == 0) {
    float M = kNegInf;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, pm[(static_cast<long long>(s) * BH + bh) * rows + rr]);
    float L = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long long i = (static_cast<long long>(s) * BH + bh) * rows + rr;
      w[s] = expf(pm[i] - M);
      L += pl[i] * w[s];
    }
    tot[0] = M;
    tot[1] = L;
  }
  __syncthreads();
  const float scale = no_key(tot[0]) ? 0.f : 1.f / fmaxf(tot[1], 1e-30f);
  const int g = Hq / Hkv;
  const int b = bh / Hkv;
  const int hk = bh - b * Hkv;
  const int hg = rr / Lq;
  const int qi = rr - hg * Lq;
  const long long row = (static_cast<long long>(b) * Hq + hk * g + hg) * Lq + qi;
  if (lse != nullptr && threadIdx.x == 0) lse[row] = row_lse(tot[0], tot[1]);
  T* o = out + row * D;
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s)
      acc += w[s] * po[((static_cast<long long>(s) * BH + bh) * rows + rr) * D + d];
    o[d] = from_f<T>(acc * scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int kD>
int launch_mma(const void* q, const void* k, const void* v, void* out, const Problem& p,
               int B, cudaStream_t stream) {
  const int rows = (p.Hq / p.Hkv) * p.Lq;
  // the plan's block (kernels/flash_attention.py `flash_plan`) against
  // this instantiation's tile
  if (p.block_rows % 16 || p.block_rows < 16 || p.block_rows > 64 ||
      p.block_keys != MmaTile<kD>::kBN || p.key_base % p.block_keys ||
      p.keys_per_split % p.block_keys)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wr = p.block_rows / 16;
  const int wk = mma_key_warps(wr, MmaTile<kD>::kBN);
  const size_t smem = MmaTile<kD>::smem_bytes(wr);
  const int e = allow_smem(flash_fwd_mma_kernel<kD>, smem);
  if (e) return e;
  const dim3 grid((rows + 16 * wr - 1) / (16 * wr), B * p.Hkv, p.splits);
  flash_fwd_mma_kernel<kD><<<grid, 32 * wr * wk, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_fma(const void* q, const void* k, const void* v, void* out, const Problem& p,
               int B, cudaStream_t stream) {
  const int rows = (p.Hq / p.Hkv) * p.Lq;
  if (p.block_rows != kFmaRows || p.block_keys != kFmaBK || p.key_base % kFmaBK ||
      p.keys_per_split % kFmaBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fma_smem_bytes<kD>();
  const int e = allow_smem(flash_fwd_fma_kernel<T, kD>, smem);
  if (e) return e;
  const dim3 grid((rows + kFmaRows - 1) / kFmaRows, B * p.Hkv, p.splits);
  flash_fwd_fma_kernel<T, kD><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_merge(void* out, const Problem& p, int B, cudaStream_t stream) {
  const int rows = (p.Hq / p.Hkv) * p.Lq;
  const dim3 grid(rows, B * p.Hkv);
  flash_merge_kernel<T><<<grid, kMergeThreads, 0, stream>>>(
      static_cast<T*>(out), p.part_o, p.part_m, p.part_l, p.lse, p.splits, p.Hq, p.Hkv, p.Lq,
      p.D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fma_d(const void* q, const void* k, const void* v, void* out, const Problem& p,
                 int B, cudaStream_t s) {
  if (p.D <= 64) return launch_fma<T, 64>(q, k, v, out, p, B, s);
  if (p.D <= 128) return launch_fma<T, 128>(q, k, v, out, p, B, s);
  return launch_fma<T, 256>(q, k, v, out, p, B, s);
}

int launch_mma_d(const void* q, const void* k, const void* v, void* out, const Problem& p,
                 int B, cudaStream_t s) {
  if (p.D <= 64) return launch_mma<64>(q, k, v, out, p, B, s);
  if (p.D <= 128) return launch_mma<128>(q, k, v, out, p, B, s);
  return launch_mma<256>(q, k, v, out, p, B, s);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// q, out: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D); all contiguous, one dtype:
// dtype 0 = float32, 1 = bfloat16.  kv_positions: null, or (Lk,) int32 key
// positions (ring caches; negative = empty slot), which replace kv_offset.
// path 1 = tensor cores (bf16, D % 8 == 0, 16-byte aligned q/k/v), 0 = CUDA
// cores.  block_rows query rows per block (16, 32, 48 or 64 on the tensor
// cores; 32 on the CUDA cores) and block_keys keys per K/V tile (the
// path's tile: 64, 32 at D > 128 on the tensor cores; 32 on the CUDA
// cores) are the wrapper's plan, checked here against the instantiated
// tile.  splits > 1: key range s covers [key_base + s * keys_per_split,
// + keys_per_split) (multiples of block_keys); part_o (splits, B * Hkv, Hq / Hkv
// * Lq, D), part_m and part_l (splits, B * Hkv, Hq / Hkv * Lq), float32, are
// scratch, and a second kernel merges them into out.  lse: null, or (B, Hq,
// Lq) float32 that receives each row's log-sum-exp.  Returns
// cudaGetLastError() after the launches (or the error that refused one).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* kv_positions, void* out, void* part_o,
                               void* part_m, void* part_l, int B, int Hq, int Hkv,
                               int Lq, int Lk, int D, int q_offset, int kv_offset,
                               int kv_valid_len, int causal, int window, float softcap,
                               float scale, int dtype, int path, int block_rows,
                               int block_keys, int key_base, int keys_per_split,
                               int splits, void* lse, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0 ||
      D <= 0 || D > kMaxD || kv_valid_len <= 0 || static_cast<long long>(B) * Hkv > 65535 ||
      splits < 1 || splits > kMaxSplits || key_base < 0 || keys_per_split <= 0 ||
      (splits > 1 && (part_o == nullptr || part_m == nullptr || part_l == nullptr)) ||
      (dtype != 0 && dtype != 1) || (path != 0 && path != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path == 1 && (dtype != 1 || D % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v)))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.kv_valid = kv_valid_len;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.kv_positions = static_cast<const int*>(kv_positions);
  p.block_rows = block_rows;
  p.block_keys = block_keys;
  p.key_base = key_base;
  p.keys_per_split = keys_per_split;
  p.splits = splits;
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  if (path == 1) {
    e = launch_mma_d(q, k, v, out, p, B, s);
  } else if (dtype == 0) {
    e = launch_fma_d<float>(q, k, v, out, p, B, s);
  } else {
    e = launch_fma_d<bf16>(q, k, v, out, p, B, s);
  }
  if (e || splits == 1) return e;
  return dtype == 0 ? launch_merge<float>(out, p, B, s) : launch_merge<bf16>(out, p, B, s);
}
