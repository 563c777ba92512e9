// Tile-ladder grant of the SoA engine's EDF allocator, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ladder_grant_pallas` in
// src/repro/core/sim/soa_kernels.py.  For each lane r and queue entry w:
//
//     out[r, w] = max_k (cand[r, w, k] <= limit[r, w] + 0.5 ? cand[r, w, k] : 0)
//
// i.e. the largest DoP candidate that fits the tile budget, else 0.  The
// Pallas version materialises the (R, W, C) broadcast of a shared (W, C)
// ladder; here `cand_lane_stride = 0` reads the shared ladder directly.
//
// Design: one thread per (r, w), a short loop over C (at most 6 on the main
// path).  The result is compare and select only, so it equals the plain
// PyTorch version bit for bit.
//
// Bound: it reads limit (4*R*W bytes) and the ladder (4*W*C bytes) and
// writes 4*R*W bytes: about 1.2 MB at R=1024, W=144, C=6, under a
// microsecond at 3.35 TB/s.  So one launch is bound by launch latency, not
// by bytes or operations.  The way past that is to fuse the grant with the
// allocator's prefix fixed point into one kernel per lane row, with the
// per-partition prefix in shared memory.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the caller owns `out`.

#include <cuda_runtime.h>

namespace {

__global__ void ladder_grant_kernel(const float* __restrict__ limit,
                                    const float* __restrict__ cand,
                                    float* __restrict__ out, int R, int W,
                                    int C, long long cand_lane_stride) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = static_cast<long long>(R) * W;
  if (i >= n) return;
  const long long r = i / W;
  const long long w = i - r * W;
  const float lim = limit[i] + 0.5f;
  const float* c = cand + r * cand_lane_stride + w * C;
  float v = c[0];
  float best = (v <= lim) ? v : 0.0f;
  for (int k = 1; k < C; ++k) {
    v = c[k];
    const float sel = (v <= lim) ? v : 0.0f;
    best = sel > best ? sel : best;
  }
  out[i] = best;
}

}  // namespace

// limit: (R, W) float32, contiguous.  cand: (W, C) when cand_lane_stride is
// 0, else (R, W, C) with lane stride cand_lane_stride (= W * C), contiguous
// rows.  out: (R, W) float32.  Returns cudaGetLastError() after the launch.
extern "C" int ladder_grant(const float* limit, const float* cand, float* out,
                            int R, int W, int C, long long cand_lane_stride,
                            void* stream) {
  const long long n = static_cast<long long>(R) * W;
  if (n <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((n + threads - 1) / threads);
  ladder_grant_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      limit, cand, out, R, W, C, cand_lane_stride);
  return static_cast<int>(cudaGetLastError());
}
