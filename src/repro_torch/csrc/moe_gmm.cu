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
// (0.030 ms at 3.35 TB/s) and the design is about reading each weight once,
// from as many SMs as possible.
//
// Design: a thread-block cluster of 8 blocks per expert (256 blocks on the
// serve path); block r of the cluster owns the F columns
// [r * F/8, (r + 1) * F/8).  For each pass of 8 bucket rows it stages those
// rows of x in shared memory, computes its (8, F/8) slice of h and u (one
// thread per (column, slice of D), partial sums reduced through shared
// memory in a fixed order), forms a in shared memory, and multiplies it by
// its F/8 rows of wd into a partial (8, D) output in shared memory.  The
// cluster then sums the 8 partials through distributed shared memory, each
// block reducing D/8 output columns in a fixed order, and writes them.  So
// the hidden (C, F) block never reaches device memory, each weight is read
// once per pass of 8 rows (once per call at C = 8), and the result does not
// depend on scheduling: no atomics.  Weight reads are coalesced along F
// (wg, wu) and D (wd).  The products run on the CUDA cores in float32;
// tensor cores (mma / wgmma) and TMA are later work.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the caller owns `out`.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ wg,
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
        moe_gmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  moe_gmm_kernel<T><<<E * kSplit, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd), static_cast<T*>(out),
      C, D, F, FT, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (or the error that refused it).
extern "C" int moe_gmm(const void* x, const void* wg, const void* wu,
                       const void* wd, void* out, int E, int C, int D, int F,
                       int dtype, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 ||
      static_cast<long long>(E) * kSplit > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, wg, wu, wd, out, E, C, D, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, wg, wu, wd, out, E, C, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
