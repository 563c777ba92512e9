// Tile-ladder grant of the SoA engine's EDF allocator, for Hopper (sm_90a).
//
// Two kernels, each with a plain C entry point:
//
// 1. `ladder_grant` replaces the TPU kernel `_ladder_grant_pallas` in
//    src/repro/core/sim/soa_kernels.py.  For each lane r and queue entry w:
//
//        out[r, w] = max_k (cand[r, w, k] <= limit[r, w] + 0.5 ? cand[r, w, k] : 0)
//
//    i.e. the largest DoP candidate that fits the tile budget, else 0.  The
//    Pallas version materialises the (R, W, C) broadcast of a shared (W, C)
//    ladder; here `cand_lane_stride = 0` reads the shared ladder directly.
//    One thread per (r, w), a short loop over C.  It moves about 1.2 MB at
//    R=1024, W=144, C=6, under a microsecond at 3.35 TB/s, so one launch is
//    bound by launch latency.  It is kept as the literal counterpart of the
//    Pallas kernel; the round loop runs the fused kernel below instead.
//
// 2. `alloc_ladder` is the whole EDF allocation of one round in one launch,
//    the Hopper design of what the TPU version runs as the Pallas grant
//    inside an XLA fixed point: gather the queue through the round's EDF
//    permutation, iterate
//
//        cur = entry ? grant(min(want, capg - excl(cur)), cand) : 0
//
//    up to 1 + alloc_iters times (excl = exclusive prefix of cur over the
//    earlier entries of the same partition, capg = the entry's partition
//    budget), optionally run tp_driven's work-conserving bump (1 +
//    bump_passes passes of a 3-step take-set relaxation and a feasibility
//    gate), and scatter the result back through the permutation.  Mode
//    `start_keep` runs ads_tile's Phase B start validation on the same
//    prefix: keep = d > 0 and excl(d) + d <= availg + 0.5.
//
//    Design: one block per lane; the lane's queue is staged in shared
//    memory in EDF order.  The partitions are fixed for the call, so the
//    entries are placed once in partition-major order (stable, EDF order
//    within a partition); every per-partition exclusive prefix is then one
//    block-wide exclusive scan, read as scan[pos] - scan[segment start].
//    No (R, W, W) same-partition mask exists.  A fixed-point step that
//    changes nothing ends the loop for the block (the refinement maps are
//    pure functions of cur, so every further step would be a no-op).
//
//    Exactness: every operand is an integer tile count or DoP rung held in
//    float32, far below 2^24, so every partial sum is exact in any order
//    and the grant is compare and select: the kernel equals the PyTorch
//    composition (matrix-product prefixes, cumsums) bit for bit.
//
//    Bound: it reads want, entry, part and the (W, C) ladder once and
//    writes the grant: about 2.2 MB at R=1024, W=160, C=6, P=4, 0.65 us at
//    3.35 TB/s.  The work is O(W) adds per lane and scan, tiny beside that;
//    what one launch replaces is ~36-300 launches of torch ops per call.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; the caller owns the outputs.

#include <cuda_runtime.h>

#include <cmath>

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


// ---------------------------------------------------------------------------
// the fused EDF allocator
// ---------------------------------------------------------------------------
enum Mode { kAlloc = 0, kAllocBump = 1, kStartKeep = 2 };

// The largest dynamic shared memory a block may use on Hopper.
constexpr size_t kMaxSmem = 232448;

struct AllocArgs {
  const float* want;          // (R, W) window order; kStartKeep: d
  const unsigned char* entry; // (R, W) bool, window order (unused by kStartKeep)
  const float* part;          // partition id per entry, lane stride part_ls
  long long part_ls;
  const float* cand;          // (W, C) ladder rows, lane stride cand_ls (0: shared)
  long long cand_ls;
  const float* cap;           // (P,) budget per partition, lane stride cap_ls
  long long cap_ls;
  const long long* perm;      // (W,) EDF order: queue entry i is window entry perm[i]
  float* out;                 // (R, W) grant, window order
  unsigned char* keep;        // (R, W) bool, window order (kStartKeep)
  int W, C, P, alloc_iters, bump_passes;
};

// Dynamic shared memory of one block.  Kept in step with
// `_alloc_smem_bytes` in core/sim/soa_kernels.py, which refuses a W that
// does not fit before launching.
__host__ __device__ inline size_t alloc_smem_bytes(int W, int C, int P) {
  return 4 * (static_cast<size_t>(W) + 1)      // scan buffer (+ total)
         + 4 * 5 * static_cast<size_t>(W)      // want, capg, cur, delta, leftg
         + 4 * 3 * static_cast<size_t>(W)      // pos, part, idx
         + 4 * static_cast<size_t>(W) * C      // ladder rows
         + 4 * 32                              // warp totals
         + 4 * (static_cast<size_t>(P) + 1)    // partition segment starts
         + 2 * static_cast<size_t>(W);         // entry, take flags
}

// In-place exclusive scan of s[0, W) over the block; s[W] gets the total.
// Each thread sums a contiguous chunk, the chunk sums are scanned by warp
// shuffles and then across warps.  Ends with a barrier.
__device__ void excl_scan(float* s, int W, float* warp_tot) {
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = T >> 5;
  const int K = (W + T - 1) / T;
  const int a = min(t * K, W), b = min(a + K, W);
  float sum = 0.0f;
  for (int i = a; i < b; ++i) sum += s[i];
  float x = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float v = lane < nw ? warp_tot[lane] : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < nw) warp_tot[lane] = v;
  }
  __syncthreads();
  float run = (x - sum) + (warp > 0 ? warp_tot[warp - 1] : 0.0f);
  for (int i = a; i < b; ++i) {
    const float v = s[i];
    s[i] = run;
    run += v;
  }
  if (t == T - 1) s[W] = run;
  __syncthreads();
}

template <int MODE>
__global__ void alloc_ladder_kernel(AllocArgs a) {
  const int W = a.W, C = a.C, P = a.P;
  const int T = blockDim.x, t = threadIdx.x;
  const long long r = blockIdx.x;

  extern __shared__ float4 smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);
  float* want = s + (W + 1);
  float* capg = want + W;
  float* cur = capg + W;
  float* delta = cur + W;
  float* leftg = delta + W;
  int* pos = reinterpret_cast<int*>(leftg + W);
  int* part = pos + W;
  int* idx = part + W;
  float* cand = reinterpret_cast<float*>(idx + W);
  float* warp_tot = cand + static_cast<size_t>(W) * C;
  int* segoff = reinterpret_cast<int*>(warp_tot + 32);
  unsigned char* ent = reinterpret_cast<unsigned char*>(segoff + P + 1);
  unsigned char* take = ent + W;

  // ---- stage the lane's queue in EDF order ------------------------------
  for (int i = t; i < W; i += T) {
    const int w = static_cast<int>(a.perm[i]);
    idx[i] = w;
    // truncation toward zero, then the clamp, as `.to(int64).clamp(0, P-1)`
    long long p = static_cast<long long>(a.part[r * a.part_ls + w]);
    p = p < 0 ? 0 : (p > P - 1 ? P - 1 : p);
    part[i] = static_cast<int>(p);
    capg[i] = a.cap[r * a.cap_ls + p];
    if (MODE == kStartKeep) {
      cur[i] = a.want[r * W + w];
    } else {
      const bool e = a.entry[r * W + w] != 0;
      ent[i] = e;
      const float v = e ? a.want[r * W + w] : 0.0f;
      want[i] = v;
      cur[i] = v;
      const float* c = a.cand + r * a.cand_ls + static_cast<long long>(w) * C;
      for (int k = 0; k < C; ++k) cand[i * C + k] = c[k];
    }
  }
  // ---- partition-major positions (stable: EDF order within a partition) -
  if (P == 1) {
    for (int i = t; i < W; i += T) pos[i] = i;
    if (t == 0) {
      segoff[0] = 0;
      segoff[1] = W;
    }
  } else {
    for (int p = t; p <= P; p += T) segoff[p] = 0;
    __syncthreads();
    for (int i = t; i < W; i += T) {
      const int p = part[i];
      int rank = 0;
      for (int j = 0; j < i; ++j) rank += part[j] == p;
      pos[i] = rank;
      atomicAdd(&segoff[p + 1], 1);
    }
    __syncthreads();
    if (t == 0)
      for (int p = 0; p < P; ++p) segoff[p + 1] += segoff[p];
    __syncthreads();
    for (int i = t; i < W; i += T) pos[i] += segoff[part[i]];
  }
  __syncthreads();

  // exclusive same-partition prefix of the values just scanned, and the
  // partition's total
#define EXCL(i) (s[pos[i]] - s[segoff[part[i]]])
#define TOTAL(i) (s[segoff[part[i] + 1]] - s[segoff[part[i]]])

  if constexpr (MODE == kStartKeep) {
    for (int i = t; i < W; i += T) s[pos[i]] = cur[i];
    __syncthreads();
    excl_scan(s, W, warp_tot);
    for (int i = t; i < W; i += T) {
      const float d = cur[i];
      a.keep[r * W + idx[i]] = (d > 0.0f) && (EXCL(i) + d <= capg[i] + 0.5f);
    }
  } else {
    // ---- the ladder fixed point -------------------------------------------
    for (int it = 0; it <= a.alloc_iters; ++it) {
      for (int i = t; i < W; i += T) s[pos[i]] = cur[i];
      __syncthreads();
      excl_scan(s, W, warp_tot);
      int changed = 0;
      for (int i = t; i < W; i += T) {
        float g = 0.0f;
        if (ent[i]) {
          const float lim = fminf(want[i], capg[i] - EXCL(i)) + 0.5f;
          const float* c = cand + i * C;
          g = (c[0] <= lim) ? c[0] : 0.0f;
          for (int k = 1; k < C; ++k) {
            const float sel = (c[k] <= lim) ? c[k] : 0.0f;
            g = sel > g ? sel : g;
          }
        }
        changed |= (g != cur[i]);
        cur[i] = g;
      }
      if (!__syncthreads_or(changed)) break;
    }

    // ---- tp_driven's work-conserving bump -----------------------------------
    if constexpr (MODE == kAllocBump) {
      for (int pass = 0; pass <= a.bump_passes; ++pass) {
        for (int i = t; i < W; i += T) s[pos[i]] = cur[i];
        __syncthreads();
        excl_scan(s, W, warp_tot);
        for (int i = t; i < W; i += T) {
          leftg[i] = capg[i] - TOTAL(i);
          const float g = cur[i], gh = g + 0.5f;
          float nxt = INFINITY;
          for (int k = 0; k < C; ++k) {
            const float c = cand[i * C + k];
            if (c > gh) nxt = fminf(nxt, c);
          }
          const float d = (ent[i] && nxt < INFINITY) ? nxt - g : 0.0f;
          delta[i] = d;
          take[i] = d > 0.0f;
        }
        __syncthreads();
        // three relaxations of the take-set, then the feasibility gate over
        // the final set (prefix over taken entries only)
        for (int step = 0; step < 4; ++step) {
          for (int i = t; i < W; i += T) s[pos[i]] = take[i] ? delta[i] : 0.0f;
          __syncthreads();
          excl_scan(s, W, warp_tot);
          for (int i = t; i < W; i += T) {
            const float d = delta[i];
            const bool fits = EXCL(i) + d <= leftg[i] + 0.5f;
            take[i] = (step < 3 ? d > 0.0f : take[i] != 0) && fits;
          }
          __syncthreads();
        }
        int changed = 0;
        for (int i = t; i < W; i += T) {
          if (take[i]) {
            const float g = cur[i] + delta[i];
            changed |= (g != cur[i]);
            cur[i] = g;
          }
        }
        if (!__syncthreads_or(changed)) break;
      }
    }

    for (int i = t; i < W; i += T) a.out[r * W + idx[i]] = cur[i];
  }
#undef EXCL
#undef TOTAL
}

template <int MODE>
int launch_alloc(const AllocArgs& a, int R, void* stream) {
  if (R <= 0 || a.W <= 0 || a.P <= 0 || (MODE != kStartKeep && a.C <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = alloc_smem_bytes(a.W, a.C, a.P);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        alloc_ladder_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // one thread per entry up to 256, whole warps (the scan shuffles over
  // full warps); longer queues give each thread a run of entries
  const int warps = (a.W + 31) / 32;
  const int threads = 32 * (warps < 1 ? 1 : (warps > 8 ? 8 : warps));
  alloc_ladder_kernel<MODE><<<R, threads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
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

// The EDF allocation of one round for R lanes: gather through perm, the
// ladder fixed point (1 + alloc_iters steps at most), tp_driven's bump when
// bump_passes >= 0 (1 + bump_passes passes at most), scatter back.
// want, out: (R, W) float32; entry: (R, W) bool; part: (R, W) float32 with
// lane stride part_lane_stride (0: one row for every lane); cand: (W, C)
// rows, lane stride cand_lane_stride (0: shared); cap: (R, P) with lane
// stride cap_lane_stride; perm: (W,) int64.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an empty problem or a
// queue that does not fit shared memory.
extern "C" int alloc_ladder(const float* want, const unsigned char* entry,
                            const float* part, long long part_lane_stride,
                            const float* cand, long long cand_lane_stride,
                            const float* cap, long long cap_lane_stride,
                            const long long* perm, float* out, int R, int W,
                            int C, int P, int alloc_iters, int bump_passes,
                            void* stream) {
  AllocArgs a{want, entry, part, part_lane_stride, cand, cand_lane_stride,
              cap, cap_lane_stride, perm, out, nullptr,
              W, C, P, alloc_iters, bump_passes};
  return bump_passes < 0 ? launch_alloc<kAlloc>(a, R, stream)
                         : launch_alloc<kAllocBump>(a, R, stream);
}

// ads_tile's Phase B start validation: keep[r, w] = d > 0 and the EDF
// prefix of d over the entry's partition plus d fits avail (+ 0.5).
// d: (R, W) float32; part and avail as in alloc_ladder; keep: (R, W) bool.
extern "C" int start_keep(const float* d, const float* part,
                          long long part_lane_stride, const float* avail,
                          long long avail_lane_stride, const long long* perm,
                          unsigned char* keep, int R, int W, int P,
                          void* stream) {
  AllocArgs a{d, nullptr, part, part_lane_stride, nullptr, 0, avail,
              avail_lane_stride, perm, nullptr, keep, W, 0, P, 0, -1};
  return launch_alloc<kStartKeep>(a, R, stream);
}
