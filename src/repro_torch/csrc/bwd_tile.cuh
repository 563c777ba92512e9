// Shared pieces of the backward kernels (moe_gmm_bwd.cu,
// ssd_intra_chunk_bwd.cu): dtype conversions and one block-level tile of a
// matrix product on the CUDA cores in float32.
//
// `tile_product` adds to a 64 x 64 tile of float32 sums
//
//   acc[i][j] += sum_{k < K} A(m0 + ty + 16 i, k) * B(k, n0 + tx + 16 j)
//
// for the block's 256 threads, thread (ty, tx) = (tid / 16, tid % 16).  The
// operands are read through functors `la(m, k)` and `lb(k, n)` that return
// float32 (and 0 outside their matrix), so one tile routine serves every
// product of the backward passes: transposed operands, operands formed on
// the fly (a decay weight, a row scale) and bounds of any shape.  Each
// 64 x 16 slab of A and 16 x 64 of B is staged through shared memory, read
// along the operand's contiguous axis (`A_KMAJOR`: A's k is contiguous;
// `B_NMAJOR`: B's n is), and each sum runs over k in increasing order with
// fmaf, so the result does not depend on scheduling.  Simple and right
// first: no double buffering, no tensor cores (ROADMAP queue B).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bwd {

constexpr int kT = 256;   // threads per block
constexpr int kBM = 64;   // tile rows
constexpr int kBN = 64;   // tile columns
constexpr int kBK = 16;   // k per staged slab
constexpr int kLd = 65;   // padded shared-memory row (floats)
// shared memory one tile_product stages its slabs in (floats)
constexpr int kTileSmem = 2 * kBK * kLd;

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

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// The tile's row and column of accumulator (i, j) for this thread.
__device__ __forceinline__ int tile_row(int i) { return (threadIdx.x >> 4) + 16 * i; }
__device__ __forceinline__ int tile_col(int j) { return (threadIdx.x & 15) + 16 * j; }

// acc += A[m0:m0+64, 0:K] . B[0:K, n0:n0+64]; `sm` holds kTileSmem floats.
// Every thread of the block calls it (it synchronises).
template <bool A_KMAJOR, bool B_NMAJOR, class LA, class LB>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], float* sm, int m0, int n0,
                                             int K, LA la, LB lb) {
  float* as = sm;               // [kBK][kLd]
  float* bs = sm + kBK * kLd;   // [kBK][kLd]
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kT; ++r) {
      const int e = tid + r * kT;
      const int am = A_KMAJOR ? e / kBK : e % kBM;
      const int ak = A_KMAJOR ? e % kBK : e / kBM;
      as[ak * kLd + am] = k0 + ak < K ? la(m0 + am, k0 + ak) : 0.f;
      const int bn = B_NMAJOR ? e % kBN : e / kBK;
      const int bk = B_NMAJOR ? e / kBN : e % kBK;
      bs[bk * kLd + bn] = k0 + bk < K ? lb(k0 + bk, n0 + bn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace bwd
