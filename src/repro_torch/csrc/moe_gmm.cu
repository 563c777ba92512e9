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
// (0.030 ms at 3.35 TB/s): the design is about keeping enough weight bytes
// in flight from every SM, and reading each weight once.
//
// Both designs: a thread-block cluster of 8 blocks per expert (256 blocks
// on the serve path); block r owns the F columns [r * FT, r * FT + FT).  The
// hidden (C, F) block never reaches device memory: each block forms its
// slice of h, u and a on chip and multiplies a by its FT rows of wd into a
// partial (rows, D) output in shared memory; the cluster then sums the 8
// partials through distributed shared memory, each block reducing D/8
// output columns in a fixed order, and writes them.  So the result does not
// depend on scheduling (no atomics), and each weight is read once per pass
// of bucket rows (once per call at C = 8).
//
// bf16 (D and F multiples of 8, 16-byte aligned operands: every model path)
// on the tensor cores, `moe_gmm_mma_kernel<NC>`, NC bucket rows per pass:
// 8 (C <= 8, the serve path), 16 (C <= 16) or 32 (larger C, where it fits
// shared memory: half the passes over the weights of 16; at a 1024-token
// prefill's C = 320 that is 10 passes, each a full read of the weights):
// * FT is F/8 rounded up to 8 columns (64 on the serve path), taken in
//   groups of 64.  The weights stream through a 4-stage shared-memory ring
//   of 18 KB chunks, loaded by 16-byte cp.async: a gate/up chunk is 64 rows
//   of D by the group's 64 columns of wg and of wu, a down chunk the
//   group's 64 rows of wd by 128 columns of D.  The ring runs on across
//   the gate/up -> down boundary and across passes: the producer never
//   waits for a, so the first wd chunks load while the last gate/up chunks
//   compute.  (Asking L2 for each block's whole wd slice at kernel entry
//   as well measured slower at the serve shape.)
//   With one column group per block the partial output overlays the x
//   rows, so at NC = 8 two blocks fit an SM (107 KB each at the serve
//   shape): ~108 KB of weights in flight per SM.
// * Every product runs on mma.sync.m16n8k16 (bf16 in, f32 out) with the
//   weight tile as the M x K operand, read by ldmatrix.trans, and the
//   bucket rows as N (8 per n-tile): h^T = wg^T x^T and u^T = wu^T x^T
//   with x by ldmatrix, then out^T = wd^T a^T with a by ldmatrix.  Each
//   16-term product is summed from zero by the tensor core and added to
//   the running float32 sum by an IEEE add on the CUDA cores: the tensor
//   core's own float32 accumulation truncates, a bias that would grow over
//   64 steps of k, and every rounding of a = bf16(silu(h) u) that lands
//   otherwise than the float32 reference's moves a row of outputs.  a is
//   formed from h and u as torch forms it.  Eight warps: in a gate/up chunk warp w owns (wg if w < 4 else wu)
//   x the 16 columns 16 (w % 4); in a down chunk the 16 output columns
//   16 w of the chunk's 128.  Partials over column groups add in group
//   order.
// float32, or bf16 shapes the tensor-core path does not take, on the CUDA
// cores in float32 (never TF32), `moe_gmm_fma_kernel`: one thread per
// (column, slice of D) for h and u and one per output column for the down
// product, 8 bucket rows per pass, weights coalesced along F and D.
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
               T* __restrict__ out, int C, int D, int F, int FT, int G) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [kCB][D]   this pass's bucket rows
  float* part = xs + kCB * D;       // [kCB][D]   partial out over this F slice
  float* hs = part + kCB * D;       // [G][kCB][FT]
  float* us = hs + G * kCB * FT;    // [G][kCB][FT]
  float* as = us + G * kCB * FT;    // [kCB][FT]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / kSplit;
  const int tid = threadIdx.x;
  const int f0 = rank * FT;
  const int fn = max(0, min(FT, F - f0));       // this block's F columns
  const int DS = (D + kSplit - 1) / kSplit;     // this block's output columns

  const T* xe = x + static_cast<long long>(e) * C * D;
  const T* wge = wg + static_cast<long long>(e) * D * F;
  const T* wue = wu + static_cast<long long>(e) * D * F;
  const T* wde = wd + static_cast<long long>(e) * F * D;
  T* oe = out + static_cast<long long>(e) * C * D;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    const int cn = min(kCB, C - c0);
    for (int i = tid; i < kCB * D; i += kThreads) {
      const int c = i / D;
      xs[i] = c < cn ? to_f(xe[static_cast<long long>(c0) * D + i]) : 0.f;
    }
    __syncthreads();

    // h and u for this block's columns: item = (column fl, slice grp of D)
    for (int item = tid; item < FT * G; item += kThreads) {
      const int fl = item % FT;
      const int grp = item / FT;
      float h[kCB], u[kCB];
#pragma unroll
      for (int c = 0; c < kCB; ++c) h[c] = u[c] = 0.f;
      if (fl < fn) {
        const int f = f0 + fl;
#pragma unroll 4
        for (int d = grp; d < D; d += G) {
          const float a = to_f(wge[static_cast<long long>(d) * F + f]);
          const float b = to_f(wue[static_cast<long long>(d) * F + f]);
#pragma unroll
          for (int c = 0; c < kCB; ++c) {
            const float xv = xs[c * D + d];
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
    __syncthreads();

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

    // partial out = a[:, slice] @ wd[slice, :], one thread per column d
    for (int d = tid; d < D; d += kThreads) {
      float o[kCB];
#pragma unroll
      for (int c = 0; c < kCB; ++c) o[c] = 0.f;
      for (int fl = 0; fl < fn; ++fl) {
        const float w = to_f(wde[static_cast<long long>(f0 + fl) * D + d]);
#pragma unroll
        for (int c = 0; c < kCB; ++c) o[c] = fmaf(as[c * FT + fl], w, o[c]);
      }
#pragma unroll
      for (int c = 0; c < kCB; ++c) part[c * D + d] = o[c];
    }
    cluster.sync();  // every block's partial is in its shared memory

    // sum the cluster's partials over this block's output columns
    for (int i = tid; i < kCB * DS; i += kThreads) {
      const int c = i / DS;
      const int d = rank * DS + (i - c * DS);
      if (c < cn && d < D) {
        float s = 0.f;
        for (int q = 0; q < kSplit; ++q) s += cluster.map_shared_rank(part, q)[c * D + d];
        oe[static_cast<long long>(c0 + c) * D + d] = from_f<T>(s);
      }
    }
    cluster.sync();  // the partials are read before the next pass rewrites them
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
constexpr int kSlot = (2 * kK1 * kS1 > kFG * kS2) ? 2 * kK1 * kS1 : kFG * kS2;  // bf16

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

// The ring, the pass's x rows, the partial out, the u exchange and a
// (bf16).  With one column group per block (FT <= 64, the serve path) the
// partial overlays the x rows: x is read only before a, the partial only
// after it.
template <int NC>
__host__ __device__ size_t mma_xs_bytes(int D) { return sizeof(bf16) * NC * (D + 8); }
template <int NC>
size_t mma_smem_bytes(int D, bool overlay) {
  const size_t xs = mma_xs_bytes<NC>(D);
  const size_t part = sizeof(float) * NC * D;
  return sizeof(bf16) * kStages * kSlot + (overlay ? (xs > part ? xs : part) : xs + part) +
         sizeof(float) * NC * kFG + sizeof(bf16) * NC * kS1;
}

template <int NC>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
moe_gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                   bf16* __restrict__ out, int C, int D, int F, int FT) {
  constexpr int kNT = NC / 8;  // n8 tiles of bucket rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool overlay = FT <= kFG;
  const size_t xs_bytes = mma_xs_bytes<NC>(D);
  const size_t part_bytes = sizeof(float) * NC * D;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);               // [kStages][kSlot]
  unsigned char* xp = smem_raw + sizeof(bf16) * kStages * kSlot;
  bf16* xs = reinterpret_cast<bf16*>(xp);                        // [NC][D + 8]
  float* part = reinterpret_cast<float*>(overlay ? xp : xp + xs_bytes);  // [NC][D]
  float* us = reinterpret_cast<float*>(
      xp + (overlay ? (xs_bytes > part_bytes ? xs_bytes : part_bytes) : xs_bytes + part_bytes));
  bf16* as = reinterpret_cast<bf16*>(us + NC * kFG);             // [NC][kS1]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / kSplit;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int f0 = rank * FT;
  const int fn = max(0, min(FT, F - f0));
  const int f_end = f0 + fn;
  const int DS = (D + kSplit - 1) / kSplit;
  const int xld = D + 8;

  const bf16* xe = x + static_cast<long long>(e) * C * D;
  const bf16* wge = wg + static_cast<long long>(e) * D * F;
  const bf16* wue = wu + static_cast<long long>(e) * D * F;
  const bf16* wde = wd + static_cast<long long>(e) * F * D;
  bf16* oe = out + static_cast<long long>(e) * C * D;

  const int nfg = (fn + kFG - 1) / kFG;
  const int nk1 = (D + kK1 - 1) / kK1;
  const int nk2 = (D + kD2 - 1) / kD2;
  const int per_fg = nk1 + nk2;
  const int per_pass = nfg * per_fg;
  const int npass = (C + NC - 1) / NC;
  const int total = npass * per_pass;

  // chunk q of the stream: (pass, group, gate/up chunk j < nk1 or down chunk)
  auto load_chunk = [&](int q, int slot) {
    bf16* dst = ring + slot * kSlot;
    const int rem = q % per_pass;
    const int fgi = rem / per_fg;
    const int j = rem - fgi * per_fg;
    const int fb = f0 + fgi * kFG;
    if (j < nk1) {
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
    } else {
      // [kFG][kS2]: the group's 64 rows of wd, 128 columns of D
      const int d0 = (j - nk1) * kD2;
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

  float hacc[kNT][4];  // [n8 tile]: this warp's 16 columns of h or u
  const int mcol = (warp & 3) * 16;
  int q = 0;
  for (int pass = 0; pass < npass; ++pass) {
    const int c0 = pass * NC;
    const int cn = min(NC, C - c0);
    // this pass's bucket rows (zeros past cn) and a zero partial, made
    // visible by the ring's first barrier below
    // (a block with no columns only contributes a zero partial)
    for (int i = tid; nfg > 0 && i < NC * (D / 8); i += kThreads) {
      const int c = i / (D / 8);
      const int d = (i - c * (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < cn) val = *reinterpret_cast<const uint4*>(xe + static_cast<long long>(c0 + c) * D + d);
      *reinterpret_cast<uint4*>(xs + c * xld + d) = val;
    }
    if (!overlay || nfg == 0)
      for (int i = tid; i < NC * D; i += kThreads) part[i] = 0.f;

    for (int fgi = 0; fgi < nfg; ++fgi) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) hacc[n][0] = hacc[n][1] = hacc[n][2] = hacc[n][3] = 0.f;
      for (int j = 0; j < per_fg; ++j, ++q) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // chunk q landed; slot (q - 1) % kStages is free
        if (q + kStages - 1 < total) load_chunk(q + kStages - 1, (q + kStages - 1) % kStages);
        cp_async_commit();
        const bf16* w = ring + (q % kStages) * kSlot;
        if (j < nk1) {
          // h^T (warps 0-3) or u^T (4-7): 16 columns f by NC rows, k over
          // this chunk's 64 rows of D; the weight tile (stored [d][f]) is
          // the A operand through ldmatrix.trans, the x rows the B operand
          const bf16* wt = w + (warp >> 2) * kK1 * kS1;
#pragma unroll
          for (int ks = 0; ks < kK1 / 16; ++ks) {
            const int dk = j * kK1 + ks * 16;
            if (dk >= D) break;  // block-uniform: D is a multiple of 8, not of 64
            uint32_t a[4];
            ldmatrix_x4_trans(a, wt + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS1 + mcol +
                                     ((lane >> 3) & 1) * 8);
            const int dcol = min(dk + ((lane >> 3) & 1) * 8, D - 8);
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              uint32_t b[2];
              ldmatrix_x2(b, xs + (n * 8 + (lane & 7)) * xld + dcol);
              if (dk + 8 >= D) b[1] = 0u;  // the k8..15 half lies past D
              mma_acc(hacc[n], a, b);
            }
          }
          if (j == nk1 - 1) {
            // u to shared memory; then a = bf16(silu(h) * u) from the h
            // warps, formed as torch forms it
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
                  as[row * kS1 + col] = __float2bfloat16_rn(av);  // a.astype(wd.dtype)
                }
            }
            if (overlay)  // x is read; the partial takes its place
              for (int i = tid; i < NC * D; i += kThreads) part[i] = 0.f;
            __syncthreads();
          }
        } else {
          // partial out^T: 16 columns d by NC rows, k over the group's 64 f
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
              ldmatrix_x2(b, as + (n * 8 + (lane & 7)) * kS1 + ks * 16 + ((lane >> 3) & 1) * 8);
              mma_acc(o[n], a, b);
            }
          }
          const int dbase = (j - nk1) * kD2 + dl;
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int d = dbase + (lane >> 2) + 8 * (c >> 1);
              const int row = n * 8 + ((lane & 3) << 1) + (c & 1);
              if (d < D) part[row * D + d] += o[n][c];
            }
        }
      }
    }
    __syncthreads();
    cluster.sync();  // every block's partial is in its shared memory
    for (int i = tid; i < NC * DS; i += kThreads) {
      const int c = i / DS;
      const int d = rank * DS + (i - c * DS);
      if (c < cn && d < D) {
        float s = 0.f;
        for (int r = 0; r < kSplit; ++r) s += cluster.map_shared_rank(part, r)[c * D + d];
        oe[static_cast<long long>(c0 + c) * D + d] = __float2bfloat16_rn(s);
      }
    }
    cluster.sync();  // the partials are read before the next pass rewrites them
  }
  cp_async_wait<0>();
}

// F columns per block of the tensor-core design: F/8 rounded up to 8
int mma_ft(int F) { return ((F + kSplit - 1) / kSplit + 7) / 8 * 8; }

template <int NC>
bool mma_fits(int D, int F) {
  return mma_smem_bytes<NC>(D, mma_ft(F) <= kFG) <= 227 * 1024;
}

template <int NC>
int launch_mma(const void* x, const void* wg, const void* wu, const void* wd, void* out,
               int E, int C, int D, int F, cudaStream_t stream) {
  const int FT = mma_ft(F);
  const size_t smem = mma_smem_bytes<NC>(D, FT <= kFG);
  if (!mma_fits<NC>(D, F)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_mma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_gmm_mma_kernel<NC><<<E * kSplit, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
      static_cast<const bf16*>(wd), static_cast<bf16*>(out), C, D, F, FT);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* out, int E, int C, int D, int F, cudaStream_t stream) {
  const int FT = (F + kSplit - 1) / kSplit;
  const int G = FT >= kThreads ? 1 : kThreads / FT;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(kCB) * D +
                       2 * static_cast<size_t>(G) * kCB * FT +
                       static_cast<size_t>(kCB) * FT);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        moe_gmm_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  moe_gmm_fma_kernel<T><<<E * kSplit, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd), static_cast<T*>(out),
      C, D, F, FT, G);
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
    if (C <= 8) return launch_mma<8>(x, wg, wu, wd, out, E, C, D, F, s);
    if (C > 16 && mma_fits<32>(D, F)) return launch_mma<32>(x, wg, wu, wd, out, E, C, D, F, s);
    return launch_mma<16>(x, wg, wu, wd, out, E, C, D, F, s);
  }
  return launch<__nv_bfloat16>(x, wg, wu, wd, out, E, C, D, F, s);
}
