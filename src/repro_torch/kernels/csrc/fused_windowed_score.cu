// Windowed fused gather-and-score for Hopper (sm_90a): code tables + pair
// (trajectory, offset) coordinates -> (level_lcs [P, H] int32, mss [P] f32).
//
// Replaces the TPU kernel repro/kernels/lcs/fused.py::
// fused_windowed_gather_score (body _fused_windowed_kernel).  The TPU kernel
// DMA'd each pair's whole [H, L] rows by scalar prefetch (its block index
// maps cannot start at an element offset), masked every position outside
// the window [off, off + clip(len - off, 0, W)) to the side sentinels and
// ran the 2L-1-step wavefront over the masked rows.  Sentinels never match,
// so that masked full-row LCS equals the LCS of the two window slices.
// Here one CUDA thread owns one pair and reads only its pair's slices,
// table[t, h, off + i] for i < clip(len - off, 0, W) (so off + i < len <=
// L: no read leaves the row), and runs the exact W x W row DP per level
// instead of L x L: at L = 20, W = 8 that is 3 * 64 cells per pair, not
// 3 * 400.  A length above L is clipped to L, as the masked full row is.
// The DP bodies and the MSS epilogue are fused_score.cu's own (pair_dp.cuh),
// run on the slices with W in place of L.  left/right arrive pre-clamped
// (no PAD_ID) and offsets lie in [0, L): the wrapper checks both.
//
// Bound on an H100: the function must read each input once (the [N, H, L]
// table and [N] lengths, four [P] coordinate vectors, H betas) and write
// P * (H + 1) * 4 bytes, against H * W * W DP cells a pair of integer work;
// at the subtrajectory path's shapes (N = 1e5, H = 3, L = 20, W = 8, 2^28
// slots) the integer work of every slot bounds it, and the bytes bound the
// cells these inputs need (49% of the slots are real window pairs).  The
// table (24 MB) fits in the 50 MB L2.
//
// Design: fused_score.cu's, with W = min(window, L) as the template
// argument (every W 1..32 instantiated; wider windows take the shared
// route): the slices and the DP row in registers, three instructions a
// cell, and no DP for a pair whose two sides are the same window of the
// same table (same table and length pointers, trajectory and offset): its
// LCS is its window's length.  The PAD slots decoded as window 0 of row 0 on both sides are
// such pairs, 51.3% of the subtrajectory path's buffer, at its end.
// Measured on an H100 80GB HBM3 at 700 W (tools/fused_score_breakdown.py):
// about 6.3 ms against 26 ms for the parent design; the loads and stores
// alone take about 5 ms of it.
#include <cuda_runtime.h>

#include "pair_dp.cuh"

namespace {

struct Args {
  const int* table_a;
  const int* len_a;
  const int* table_b;
  const int* len_b;
  const int* left;
  const int* right;
  const int* off_a;
  const int* off_b;
  const float* betas;
  int* level_lcs;
  float* mss;
  long long pairs;
  int H;
  int L;
  int W;
  bool same;  // table_a == table_b and len_a == len_b
};

// window length: clip(min(len, L) - off, 0, W)
__device__ __forceinline__ int window_len(const int* lengths, long long t, int off, int L, int W) {
  return max(0, min(min(__ldg(lengths + t), L) - off, W));
}

template <int W, int F>
__global__ void fused_windowed_regs(const Args g) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= g.pairs) return;  // ragged last block; threads share no data
  const long long li = g.left[p];
  const long long ri = g.right[p];
  const int oa = g.off_a[p];
  const int ob = g.off_b[p];
  const int wla = window_len(g.len_a, li, oa, g.L, W);
  float mss;
  if ((F & kIdentity) != 0 && g.same && li == ri && oa == ob) {
    mss = identity_levels(wla, g.H, g.betas, g.level_lcs + p * g.H);
  } else {
    const long long row = static_cast<long long>(g.H) * g.L;
    mss = score_pair_levels_regs<W, F>(g.table_a + li * row + oa, g.table_b + ri * row + ob, g.L,
                                       wla, window_len(g.len_b, ri, ob, g.L, W), g.H, g.betas,
                                       g.level_lcs + p * g.H);
  }
  g.mss[p] = mss;
}

template <bool IDENTITY>
__global__ void fused_windowed_shared(const Args g) {
  extern __shared__ int smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const long long p = static_cast<long long>(blockIdx.x) * nt + tid;
  if (p >= g.pairs) return;
  const long long li = g.left[p];
  const long long ri = g.right[p];
  const int oa = g.off_a[p];
  const int ob = g.off_b[p];
  const int W = g.W;
  const int wla = window_len(g.len_a, li, oa, g.L, W);
  if (IDENTITY && g.same && li == ri && oa == ob) {
    g.mss[p] = identity_levels(wla, g.H, g.betas, g.level_lcs + p * g.H);
    return;
  }
  const long long row = static_cast<long long>(g.H) * g.L;
  g.mss[p] = score_pair_levels(g.table_a + li * row + oa, g.table_b + ri * row + ob, g.L, wla,
                               window_len(g.len_b, ri, ob, g.L, W), g.H, W, g.betas,
                               g.level_lcs + p * g.H, smem, smem + W * nt, nt, tid);
}

unsigned int blocks_for(long long pairs, int threads) {
  return static_cast<unsigned int>((pairs + threads - 1) / threads);
}

// the register kernel of width W, found by recursion over 32..1
template <int W, int F>
void launch_regs(const Args& g, int threads, cudaStream_t s) {
  if constexpr (W >= 1) {
    if (g.W == W) {
      fused_windowed_regs<W, F><<<blocks_for(g.pairs, threads), threads, 0, s>>>(g);
    } else {
      launch_regs<W - 1, F>(g, threads, s);
    }
  }
}

template <bool IDENTITY>
void launch_shared(const Args& g, int threads, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(2) * g.W * threads * sizeof(int);
  fused_windowed_shared<IDENTITY><<<blocks_for(g.pairs, threads), threads, smem, s>>>(g);
}

Args make_args(const void* table_a, const void* len_a, const void* table_b,
               const void* len_b, const void* left, const void* right,
               const void* off_a, const void* off_b, const void* betas,
               void* level_lcs, void* mss, long long pairs, int H, int L,
               int W) {
  return Args{static_cast<const int*>(table_a), static_cast<const int*>(len_a),
              static_cast<const int*>(table_b), static_cast<const int*>(len_b),
              static_cast<const int*>(left),    static_cast<const int*>(right),
              static_cast<const int*>(off_a),   static_cast<const int*>(off_b),
              static_cast<const float*>(betas), static_cast<int*>(level_lcs),
              static_cast<float*>(mss),         pairs, H, L, W,
              table_a == table_b && len_a == len_b};
}

}  // namespace

// All pointers are device pointers of contiguous tensors: table_a/table_b
// int32 [N, H, L], len_a/len_b int32 [N], left/right/off_a/off_b int32
// [pairs], betas float32 [H], level_lcs int32 [pairs, H], mss float32
// [pairs].  W = min(window, L) >= 1.  route is kRouteRegisters (the
// register kernel of width W, W <= 32) or kRouteShared (the shared-memory
// kernel, any W); the caller picks it from W.  threads is the block size;
// on the shared route the caller keeps 2 * W * threads * 4 bytes of shared
// memory within the 48 KB default.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a route
// that has no kernel at this width.
extern "C" int fused_windowed_score_launch(
    const void* table_a, const void* len_a, const void* table_b,
    const void* len_b, const void* left, const void* right, const void* off_a,
    const void* off_b, const void* betas, void* level_lcs, void* mss,
    long long pairs, int H, int L, int W, int threads, void* stream,
    int route) {
  if (pairs <= 0) return 0;
  const Args g = make_args(table_a, len_a, table_b, len_b, left, right, off_a, off_b, betas,
                           level_lcs, mss, pairs, H, L, W);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteRegisters && W >= 1 && W <= kMaxRegisterWidth) {
    launch_regs<kMaxRegisterWidth, kEngine>(g, threads, s);
  } else if (route == kRouteShared) {
    launch_shared<true>(g, threads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Variants for timing the design's parts; the engine never calls this.
// The codes are fused_score_variant_launch's, with W = 8 (the
// subtrajectory path's window) as the width of variants 1-3.
extern "C" int fused_windowed_score_variant_launch(
    const void* table_a, const void* len_a, const void* table_b,
    const void* len_b, const void* left, const void* right, const void* off_a,
    const void* off_b, const void* betas, void* level_lcs, void* mss,
    long long pairs, int H, int L, int W, int threads, void* stream,
    int variant) {
  if (pairs <= 0) return 0;
  const Args g = make_args(table_a, len_a, table_b, len_b, left, right, off_a, off_b, betas,
                           level_lcs, mss, pairs, H, L, W);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kPathWidth = 8;
  if (variant == 0) {
    launch_shared<false>(g, threads, s);
  } else if (variant >= 1 && variant <= 3 && W == kPathWidth) {
    // the register kernel at the path's width with one part changed
    constexpr int kFlags[] = {kEngine & ~kIdentity, kEngine | kStop, kEngine & ~kDp};
    using Kernel = void (*)(const Args);
    const Kernel kernels[] = {fused_windowed_regs<kPathWidth, kFlags[0]>,
                              fused_windowed_regs<kPathWidth, kFlags[1]>,
                              fused_windowed_regs<kPathWidth, kFlags[2]>};
    kernels[variant - 1]<<<blocks_for(pairs, threads), threads, 0, s>>>(g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
