// MoE grouped matmul (the expert FFN over capacity buckets) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `moe_gmm` in src/repro/kernels/moe_gmm.py
// (`_kernel`, called through `pl.pallas_call`).  For every expert e:
//
//   h = x[e] @ wg[e],  u = x[e] @ wu[e]          (float32 accumulation)
//   a = cast(silu(h) * u, wd.dtype)              (h, u, a in float32)
//   out[e] = cast(a @ wd[e], x.dtype)            (float32 accumulation)
//
// x: (E, C, D), wg and wu: (E, D, F), wd: (E, F, D), out: (E, C, D), all
// contiguous and of one dtype (float32 or bfloat16).
//
// Bound on this card: on the serve path (E = 32 experts, C = 8 bucket rows,
// D = 1024, F = 512, bf16) the expert weights are 100.7 MB per layer and the
// work 0.8 GFLOP, so the kernel is bound by the bytes of the weights
// (0.030 ms at 3.35 TB/s); at deepseek-v2's (E = 160, C = 8, D = 5120,
// F = 1536) they are 7.55 GB (2.25 ms): the design is about keeping enough
// weight bytes in flight from every SM, and reading each weight once.
//
// Both designs: a thread-block cluster of 8 blocks per expert (256 blocks
// on the serve path); block r owns the F columns [r * FT, r * FT + FT).  The
// hidden (C, F) block never reaches device memory: each block forms its
// slice of h, u and a on chip and multiplies a by its FT rows of wd into a
// partial (rows, DP) output in shared memory, one panel of DP columns of D
// at a time; the cluster then sums the panel's 8 partials through
// distributed shared memory, each block reducing DP/8 of its columns in a
// fixed order, and writes them before the next panel.  The partial stays
// float32: the cluster's sum of partials is where the float32 accumulation
// over F lives.  So the result does not depend on scheduling (no atomics),
// each weight is read once per pass of bucket rows (once per call at
// C <= 8), and shared memory holds one panel of D, not all of it, so any D
// fits.  Panels change no sum: each output's terms add in the same order
// whatever DP is.
//
// bf16 (D and F multiples of 8, 16-byte aligned operands: every model path)
// on the tensor cores, `moe_gmm_mma_kernel<NC>`, NC bucket rows per pass:
// 8 (C <= 8, the serve path), 16 (C <= 16) or 32 (larger C: half the
// passes over the weights of 16; at a 1024-token prefill's C = 320 that is
// 10 passes, each a full read of the weights); fewer where the block's a
// would leave no room for a panel:
// * FT is F/8 rounded up to 8 columns (64 on the serve path, 192 at
//   deepseek's), taken in groups of 64.  The weights stream through a
//   4-stage shared-memory ring of ~19 KB chunks, loaded by 16-byte
//   cp.async: a gate/up chunk is 64 rows of D by the group's 64 columns of
//   wg and of wu, with the pass's NC bucket rows over the same 64 d beside
//   them (so no copy of the whole (NC, D) rows is kept), a down chunk the
//   group's 64 rows of wd by 128 columns of D.  Per pass the stream is
//   every group's gate/up chunks (a for all the block's columns is kept,
//   bf16), then per panel and per group the panel's down chunks.  The ring
//   runs on across these boundaries and across passes: the producer never
//   waits for a, so the first wd chunks load while the last gate/up chunks
//   compute.  (Asking L2 for each block's whole wd slice at kernel entry
//   as well measured slower at the serve shape.)  The launcher takes the
//   fewest panels, as even as whole 128-column chunks allow, with which two
//   blocks fit an SM, else the fewest at one block per SM: one panel of
//   1024 at the serve shape (114 KB a block, ~108 KB of weights in flight
//   per SM), six of 896 (the last 640) at deepseek's.
// * Every product runs on mma.sync.m16n8k16 (bf16 in, f32 out) with the
//   weight tile as the M x K operand, read by ldmatrix.trans, and the
//   bucket rows as N (8 per n-tile): h^T = wg^T x^T and u^T = wu^T x^T
//   with x by ldmatrix, then out^T = wd^T a^T with a by ldmatrix.  Each
//   16-term product is summed from zero by the tensor core and added to
//   the running float32 sum by an IEEE add on the CUDA cores: the tensor
//   core's own float32 accumulation truncates, a bias that would grow over
//   64 steps of k, and every rounding of a = bf16(silu(h) u) that lands
//   otherwise than the float32 reference's moves a row of outputs.  a is
//   formed from h and u as torch forms it.  Eight warps: in a gate/up
//   chunk warp w owns (wg if w < 4 else wu) x the 16 columns 16 (w % 4); in
//   a down chunk the 16 output columns 16 w of the chunk's 128.  Partials
//   over column groups add in group order.
// float32, or bf16 shapes the tensor-core path does not take, on the CUDA
// cores in float32 (never TF32), `moe_gmm_fma_kernel`: one thread per
// (column, slice of D) for h and u and one per output column for the down
// product, 8 bucket rows per pass, weights coalesced along F and D.  The x
// rows and the partial cover one panel of D at a time; h and u carry their
// running sums across the panels in shared memory, so each one's chain of
// fmaf runs over d in the order one panel of all of D would.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; the caller owns `out`.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;     // blocks per expert: one cluster
constexpr int kThreads = 256;
constexpr int kCB = 8;        // bucket rows per pass

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

template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
moe_gmm_fma_kernel(const T* __restrict__ x, const T* __restrict__ wg,
               const T* __restrict__ wu, const T* __restrict__ wd,
               T* __restrict__ out, int C, int D, int F, int FT, int G, int P) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [kCB][P]   this pass's bucket rows, one panel of D
  float* part = xs + kCB * P;       // [kCB][P]   partial out over this F slice, one panel
  float* hs = part + kCB * P;       // [G][kCB][FT]
  float* us = hs + G * kCB * FT;    // [G][kCB][FT]
  float* as = us + G * kCB * FT;    // [kCB][FT]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / kSplit;
  const int tid = threadIdx.x;
  const int f0 = rank * FT;
  const int fn = max(0, min(FT, F - f0));       // this block's F columns

  const T* xe = x + static_cast<long long>(e) * C * D;
  const T* wge = wg + static_cast<long long>(e) * D * F;
  const T* wue = wu + static_cast<long long>(e) * D * F;
  const T* wde = wd + static_cast<long long>(e) * F * D;
  T* oe = out + static_cast<long long>(e) * C * D;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    const int cn = min(kCB, C - c0);
    // h and u for this block's columns, item = (column fl, slice grp of
    // D), over the panels of D in order: each item's fmaf chain runs on
    // from its running sum in shared memory, d = grp, grp + G, ... as one
    // pass over the whole of D would take it
    for (int x0 = 0; x0 < D; x0 += P) {
      const int pw = min(P, D - x0);
      for (int i = tid; i < kCB * P; i += kThreads) {
        const int c = i / P;
        const int d = i - c * P;
        xs[i] = c < cn && d < pw ? to_f(xe[static_cast<long long>(c0 + c) * D + x0 + d]) : 0.f;
      }
      __syncthreads();
      for (int item = tid; item < FT * G; item += kThreads) {
        const int fl = item % FT;
        const int grp = item / FT;
        float h[kCB], u[kCB];
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          h[c] = x0 ? hs[(grp * kCB + c) * FT + fl] : 0.f;
          u[c] = x0 ? us[(grp * kCB + c) * FT + fl] : 0.f;
        }
        if (fl < fn) {
          const int f = f0 + fl;
#pragma unroll 4
          for (int d = x0 + (grp - x0 % G + G) % G; d < x0 + pw; d += G) {
            const float a = to_f(wge[static_cast<long long>(d) * F + f]);
            const float b = to_f(wue[static_cast<long long>(d) * F + f]);
#pragma unroll
            for (int c = 0; c < kCB; ++c) {
              const float xv = xs[c * P + d - x0];
              h[c] = fmaf(xv, a, h[c]);
              u[c] = fmaf(xv, b, u[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          hs[(grp * kCB + c) * FT + fl] = h[c];
          us[(grp * kCB + c) * FT + fl] = u[c];
        }
      }
      __syncthreads();  // xs is read (and the sums are in) before the next panel
    }

    for (int i = tid; i < kCB * FT; i += kThreads) {
      const int c = i / FT;
      const int fl = i - c * FT;
      float h = 0.f, u = 0.f;
      for (int grp = 0; grp < G; ++grp) {
        h += hs[(grp * kCB + c) * FT + fl];
        u += us[(grp * kCB + c) * FT + fl];
      }
      const float a = h / (1.f + expf(-h)) * u;  // silu(h) * u
      as[i] = to_f(from_f<T>(a));                // a.astype(wd.dtype)
    }
    __syncthreads();

    // the down product, one panel of D at a time: partial out = a[:,
    // slice] @ wd[slice, panel], one thread per column d; then the cluster
    // sums the panel's 8 partials, each block over P/8 of its columns
    for (int p0 = 0; p0 < D; p0 += P) {
      const int pw = min(P, D - p0);
      const int DS = (pw + kSplit - 1) / kSplit;
      for (int dl = tid; dl < pw; dl += kThreads) {
        const int d = p0 + dl;
        float o[kCB];
#pragma unroll
        for (int c = 0; c < kCB; ++c) o[c] = 0.f;
        for (int fl = 0; fl < fn; ++fl) {
          const float w = to_f(wde[static_cast<long long>(f0 + fl) * D + d]);
#pragma unroll
          for (int c = 0; c < kCB; ++c) o[c] = fmaf(as[c * FT + fl], w, o[c]);
        }
#pragma unroll
        for (int c = 0; c < kCB; ++c) part[c * P + dl] = o[c];
      }
      cluster.sync();  // every block's partial is in its shared memory
      for (int i = tid; i < kCB * DS; i += kThreads) {
        const int c = i / DS;
        const int dl = rank * DS + (i - c * DS);
        if (c < cn && dl < pw) {
          float s = 0.f;
          for (int q = 0; q < kSplit; ++q) s += cluster.map_shared_rank(part, q)[c * P + dl];
          oe[static_cast<long long>(c0 + c) * D + p0 + dl] = from_f<T>(s);
        }
      }
      cluster.sync();  // the partials are read before the next panel rewrites them
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kStages = 4;    // shared-memory ring of weight chunks
constexpr int kFG = 64;       // F columns per group
constexpr int kK1 = 64;       // D rows per gate/up chunk
constexpr int kD2 = 128;      // D columns per down chunk
constexpr int kS1 = kFG + 8;  // padded gate/up chunk row (bf16): 144 bytes
constexpr int kS2 = kD2 + 8;  // padded down chunk row: 272 bytes
constexpr int kSx = kK1 + 8;  // padded x row of a gate/up chunk: 144 bytes
// a ring slot (bf16): a gate/up chunk (wg and wu rows, then the pass's NC
// bucket rows over the same 64 d) or a down chunk
template <int NC>
__host__ __device__ constexpr int slot_elems() {
  return (2 * kK1 * kS1 + NC * kSx > kFG * kS2) ? 2 * kK1 * kS1 + NC * kSx : kFG * kS2;
}

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

// c += a . b with the 16-term product summed from zero by the tensor core
// and added to c on the CUDA cores, an IEEE float32 add (the tensor core's
// own float32 accumulation truncates).
__device__ __forceinline__ void mma_acc(float* c, const uint32_t* a, const uint32_t* b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b);
  c[0] += t[0];
  c[1] += t[1];
  c[2] += t[2];
  c[3] += t[3];
}

// Shared memory: the ring, a for every column group of the block (bf16), the
// u exchange, and the partial out over one panel of DP columns of D.
template <int NC>
size_t mma_fixed_bytes(int FT) {
  const int ftp = (FT + kFG - 1) / kFG * kFG;
  return sizeof(bf16) * (static_cast<size_t>(kStages) * slot_elems<NC>() + NC * (ftp + 8)) +
         sizeof(float) * NC * kFG;
}

template <int NC>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
moe_gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                   bf16* __restrict__ out, int C, int D, int F, int FT, int DP) {
  constexpr int kNT = NC / 8;  // n8 tiles of bucket rows
  constexpr int kSlot = slot_elems<NC>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ftp = (FT + kFG - 1) / kFG * kFG;
  const int lda = ftp + 8;                                       // padded row of a
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);               // [kStages][kSlot]
  bf16* as = ring + kStages * kSlot;                             // [NC][lda]
  float* us = reinterpret_cast<float*>(as + NC * lda);           // [NC][kFG]
  float* part = us + NC * kFG;                                   // [NC][DP]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / kSplit;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int f0 = rank * FT;
  const int fn = max(0, min(FT, F - f0));
  const int f_end = f0 + fn;

  const bf16* xe = x + static_cast<long long>(e) * C * D;
  const bf16* wge = wg + static_cast<long long>(e) * D * F;
  const bf16* wue = wu + static_cast<long long>(e) * D * F;
  const bf16* wde = wd + static_cast<long long>(e) * F * D;
  bf16* oe = out + static_cast<long long>(e) * C * D;

  const int nfg = (fn + kFG - 1) / kFG;
  const int nk1 = (D + kK1 - 1) / kK1;
  const int nk2 = (D + kD2 - 1) / kD2;
  const int kc = DP / kD2;                 // down chunks per whole panel
  const int npanel = (nk2 + kc - 1) / kc;
  const int n_up = nfg * nk1;              // gate/up chunks per pass
  const int per_pass = n_up + nfg * nk2;
  const int npass = (C + NC - 1) / NC;
  const int total = npass * per_pass;

  // chunk q of the stream, per pass: every group's gate/up chunks, then
  // per panel of D, per group, the panel's down chunks
  auto load_chunk = [&](int q, int slot) {
    bf16* dst = ring + slot * kSlot;
    const int pass = q / per_pass;
    const int rem = q - pass * per_pass;
    if (rem < n_up) {
      const int fgi = rem / nk1;
      const int j = rem - fgi * nk1;
      const int fb = f0 + fgi * kFG;
      // [2][kK1][kS1]: rows d of wg then of wu, the group's 64 columns
      for (int i = tid; i < 2 * kK1 * (kFG / 8); i += kThreads) {
        const int m = i / (kK1 * (kFG / 8));
        const int r = (i / (kFG / 8)) % kK1;
        const int c = i % (kFG / 8);
        const int d = j * kK1 + r;
        const int f = fb + c * 8;
        const bool in = d < D && f < f_end;
        const bf16* src = (m == 0 ? wge : wue) + (in ? static_cast<long long>(d) * F + f : 0);
        cp_async16(dst + (m * kK1 + r) * kS1 + c * 8, src, in ? 16 : 0);
      }
      // [NC][kSx]: the pass's bucket rows over the same 64 d (zeros past C
      // and past D)
      const int c0 = pass * NC;
      for (int i = tid; i < NC * (kK1 / 8); i += kThreads) {
        const int c = i / (kK1 / 8);
        const int d = j * kK1 + (i - c * (kK1 / 8)) * 8;
        const bool in = c0 + c < C && d < D;
        const bf16* src = xe + (in ? static_cast<long long>(c0 + c) * D + d : 0);
        cp_async16(dst + 2 * kK1 * kS1 + c * kSx + (d - j * kK1), src, in ? 16 : 0);
      }
    } else {
      const int r2 = rem - n_up;
      const int p = r2 / (nfg * kc);
      const int r3 = r2 - p * nfg * kc;
      const int pc = min(kc, nk2 - p * kc);
      const int fgi = r3 / pc;
      const int d0 = (p * kc + r3 - fgi * pc) * kD2;
      const int fb = f0 + fgi * kFG;
      // [kFG][kS2]: the group's 64 rows of wd, 128 columns of D
      for (int i = tid; i < kFG * (kD2 / 8); i += kThreads) {
        const int r = i / (kD2 / 8);
        const int c = i - r * (kD2 / 8);
        const int f = fb + r;
        const int d = d0 + c * 8;
        const bool in = f < f_end && d < D;
        const bf16* src = wde + (in ? static_cast<long long>(f) * D + d : 0);
        cp_async16(dst + r * kS2 + c * 8, src, in ? 16 : 0);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < total) load_chunk(st, st);
    cp_async_commit();
  }
  int q = 0;
  // chunk q has landed and slot (q - 1) % kStages is free: refill it
  auto next_chunk = [&]() -> const bf16* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (q + kStages - 1 < total) load_chunk(q + kStages - 1, (q + kStages - 1) % kStages);
    cp_async_commit();
    return ring + (q++ % kStages) * kSlot;
  };

  float hacc[kNT][4];  // [n8 tile]: this warp's 16 columns of h or u
  const int mcol = (warp & 3) * 16;
  for (int pass = 0; pass < npass; ++pass) {
    const int c0 = pass * NC;
    const int cn = min(NC, C - c0);
    for (int fgi = 0; fgi < nfg; ++fgi) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) hacc[n][0] = hacc[n][1] = hacc[n][2] = hacc[n][3] = 0.f;
      for (int j = 0; j < nk1; ++j) {
        const bf16* w = next_chunk();
        // h^T (warps 0-3) or u^T (4-7): 16 columns f by NC rows, k over
        // this chunk's 64 rows of D; the weight tile (stored [d][f]) is
        // the A operand through ldmatrix.trans, the x rows the B operand
        const bf16* wt = w + (warp >> 2) * kK1 * kS1;
        const bf16* xs = w + 2 * kK1 * kS1;
#pragma unroll
        for (int ks = 0; ks < kK1 / 16; ++ks) {
          if (j * kK1 + ks * 16 >= D) break;  // block-uniform: D is a multiple of 8, not of 64
          uint32_t a[4];
          ldmatrix_x4_trans(a, wt + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS1 + mcol +
                                   ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            uint32_t b[2];  // a k8..15 half past D is zeros on both sides
            ldmatrix_x2(b, xs + (n * 8 + (lane & 7)) * kSx + ks * 16 + ((lane >> 3) & 1) * 8);
            mma_acc(hacc[n], a, b);
          }
        }
      }
      // u to shared memory; then a = bf16(silu(h) * u) from the h warps,
      // formed as torch forms it, into the group's columns of a
      if (warp >= 4) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            us[(n * 8 + ((lane & 3) << 1) + (c & 1)) * kFG + mcol + (lane >> 2) + 8 * (c >> 1)] =
                hacc[n][c];
      }
      __syncthreads();
      if (warp < 4) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = n * 8 + ((lane & 3) << 1) + (c & 1);
            const int col = mcol + (lane >> 2) + 8 * (c >> 1);
            const float h = hacc[n][c];
            const float sh = h / (1.f + expf(-h));      // F.silu
            const float av = __fmul_rn(sh, us[row * kFG + col]);
            as[row * lda + fgi * kFG + col] = __float2bfloat16_rn(av);  // a.astype(wd.dtype)
          }
      }
      __syncthreads();  // us is read before the next group rewrites it
    }

    // the down product, one panel of D at a time: per group in order, the
    // partial out^T over the panel (16 columns d per warp by NC rows, k over
    // the group's 64 f); then the cluster sums the panel's 8 partials
    for (int p = 0; p < npanel; ++p) {
      const int pd0 = p * DP;
      const int pw = min(DP, D - pd0);
      const int pc = min(kc, nk2 - p * kc);
      for (int i = tid; i < NC * DP; i += kThreads) part[i] = 0.f;
      for (int fgi = 0; fgi < nfg; ++fgi) {
        for (int jc = 0; jc < pc; ++jc) {
          const bf16* w = next_chunk();
          const int dl = warp * 16;
          float o[kNT][4];
#pragma unroll
          for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
          for (int ks = 0; ks < kFG / 16; ++ks) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, w + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS2 + dl +
                                    ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              uint32_t b[2];
              ldmatrix_x2(b, as + (n * 8 + (lane & 7)) * lda + fgi * kFG + ks * 16 +
                                 ((lane >> 3) & 1) * 8);
              mma_acc(o[n], a, b);
            }
          }
          const int dbase = jc * kD2 + dl;
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int d = dbase + (lane >> 2) + 8 * (c >> 1);
              const int row = n * 8 + ((lane & 3) << 1) + (c & 1);
              if (d < pw) part[row * DP + d] += o[n][c];
            }
        }
      }
      __syncthreads();
      cluster.sync();  // every block's partial is in its shared memory
      const int DS = (pw + kSplit - 1) / kSplit;
      for (int i = tid; i < NC * DS; i += kThreads) {
        const int c = i / DS;
        const int d = rank * DS + (i - c * DS);
        if (c < cn && d < pw) {
          float s = 0.f;
          for (int r = 0; r < kSplit; ++r) s += cluster.map_shared_rank(part, r)[c * DP + d];
          oe[static_cast<long long>(c0 + c) * D + pd0 + d] = __float2bfloat16_rn(s);
        }
      }
      cluster.sync();  // the partials are read before the next panel rewrites them
    }
  }
  cp_async_wait<0>();
}

// F columns per block of the tensor-core design: F/8 rounded up to 8
int mma_ft(int F) { return ((F + kSplit - 1) / kSplit + 7) / 8 * 8; }

constexpr size_t kSmemMax = 232448;  // a block's dynamic shared memory
constexpr size_t kSmemPair = 115712;  // two blocks per SM (1 KB reserved each)

// Panel width DP (columns of D, a multiple of kD2) for NC rows: the fewest
// panels, as even as whole chunks allow, whose partial fits beside the rest
// with two blocks per SM, else with one; 0 if not even one chunk fits.
template <int NC>
int mma_panel(int D, int F) {
  const size_t fixed = mma_fixed_bytes<NC>(mma_ft(F));
  const int nk2 = (D + kD2 - 1) / kD2;
  const size_t budgets[2] = {kSmemPair, kSmemMax};
  for (size_t budget : budgets) {
    if (fixed >= budget) continue;
    const int most = static_cast<int>((budget - fixed) / (sizeof(float) * NC * kD2));
    if (most < 1) continue;
    const int npanel = (nk2 + most - 1) / most;
    return (nk2 + npanel - 1) / npanel * kD2;
  }
  return 0;
}

template <int NC>
int launch_mma(const void* x, const void* wg, const void* wu, const void* wd, void* out,
               int E, int C, int D, int F, cudaStream_t stream) {
  const int FT = mma_ft(F);
  const int DP = mma_panel<NC>(D, F);
  if (DP == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mma_fixed_bytes<NC>(FT) + sizeof(float) * NC * DP;
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_mma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_gmm_mma_kernel<NC><<<E * kSplit, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
      static_cast<const bf16*>(wd), static_cast<bf16*>(out), C, D, F, FT, DP);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* out, int E, int C, int D, int F, cudaStream_t stream) {
  const int FT = (F + kSplit - 1) / kSplit;
  const int G = FT >= kThreads ? 1 : kThreads / FT;
  // the h / u sums and a, then the x rows and the partial over panels of D:
  // the fewest panels, as even as columns allow, that fit
  const size_t fixed = sizeof(float) * (2 * static_cast<size_t>(G) * kCB * FT +
                                        static_cast<size_t>(kCB) * FT);
  const size_t per_col = sizeof(float) * 2 * kCB;
  if (fixed + per_col > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int most = static_cast<int>((kSmemMax - fixed) / per_col);
  const int npanel = (D + most - 1) / most;
  const int P = (D + npanel - 1) / npanel;
  const size_t smem = fixed + per_col * P;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        moe_gmm_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  moe_gmm_fma_kernel<T><<<E * kSplit, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd), static_cast<T*>(out),
      C, D, F, FT, G, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  bf16 with D and F multiples of 8 and
// 16-byte aligned operands runs on the tensor cores; anything else on the
// CUDA cores.
// Returns cudaGetLastError() after the launch (or the error that refused
// it).
extern "C" int moe_gmm(const void* x, const void* wg, const void* wu,
                       const void* wd, void* out, int E, int C, int D, int F,
                       int dtype, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 ||
      static_cast<long long>(E) * kSplit > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, wg, wu, wd, out, E, C, D, F, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D % 8 == 0 && F % 8 == 0 && aligned16(x) && aligned16(wg) && aligned16(wu) &&
      aligned16(wd)) {
    // NC bucket rows per pass: 8 (C <= 8), 16 (C <= 16), else 32; fewer
    // where a (the block's F columns) leaves no room for a panel
    if (C > 16 && mma_panel<32>(D, F)) return launch_mma<32>(x, wg, wu, wd, out, E, C, D, F, s);
    if (C > 8 && mma_panel<16>(D, F)) return launch_mma<16>(x, wg, wu, wd, out, E, C, D, F, s);
    return launch_mma<8>(x, wg, wu, wd, out, E, C, D, F, s);
  }
  return launch<__nv_bfloat16>(x, wg, wu, wd, out, E, C, D, F, s);
}
