// Fused gather-and-score for Hopper (sm_90a): code tables + pair indices ->
// (level_lcs [P, H] int32, mss [P] float32).
//
// Replaces the TPU kernel repro/kernels/lcs/fused.py::fused_gather_score
// (bodies _fused_kernel and _masked_rows_lcs).  On the TPU a scalar-prefetch
// grid DMA'd each pair's two [H, L] rows straight out of the resident code
// table, so the [P, H, L] gathered copies never existed in HBM.  Here one
// CUDA thread owns one pair: it reads left[p] and right[p] itself, loads its
// rows from the tables, masks positions >= length to the side sentinels
// (-1 for side A, -2 for side B) in registers, runs the exact row DP of
// each of the H levels, writes |M_h|, and folds the MSS epilogue as the
// forward FMA chain acc = fma(|M_h|, beta_h, acc) in h order (pair_dp.cuh,
// shared with the windowed scorer).  left/right arrive pre-clamped (no
// PAD_ID), as score_pairs passes them.
//
// Bound on an H100: the function must read each input once (two [N, H, L]
// tables, two [N] length vectors, two [P] index vectors, H betas) and write
// P * (H + 1) * 4 bytes, against H * L * L DP cells a pair of integer work
// (one op a cell at 64 int32 lanes an SM: 16.7 T cells/s); at the main
// path's shapes (N = 1e6, H = 3, L = 10, 2^28 slots) the integer work of
// every slot bounds it, and the bytes bound the cells these inputs need
// (45% of the slots are real pairs).  What sets the pace instead is the
// gather: each real pair pulls its b row (120 bytes, 4-5 sectors) from a
// 120 MB table that L2 cannot hold, at random.
//
// Design, for L <= 32 (the register route):
// - L is a template argument (every width 1..32 is instantiated), so the
//   a row, the b row and the DP row sit in registers and the L x L loops
//   unroll into straight-line code: three instructions a cell, no shared
//   memory (the first design's body, kept as the shared route, pays two
//   shared loads and a store a cell and ran near that ceiling, 7.2 cells
//   an SM a clock).
// - A pair whose two sides are the same row of the same table (the
//   launcher compares the table and length pointers) needs no DP: its LCS
//   is min(len, L) at every level (pair_dp.cuh).  The PAD slots clamped to
//   (0, 0) are such pairs, 54.5% of the main path's buffer, at its end.
// Measured on an H100 80GB HBM3 at 700 W (tools/fused_score_breakdown.py):
// about 10 ms at main against 41 ms for the parent design, with the DP
// itself hidden under the gather (the loads and stores alone take as long).
// Rows wider than 32 take the shared route (the first design's body).
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
  const float* betas;
  int* level_lcs;
  float* mss;
  long long pairs;
  int H;
  int L;
  bool same;  // table_a == table_b and len_a == len_b
};

template <int W, int F>
__global__ void fused_score_regs(const Args g) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= g.pairs) return;  // ragged last block; threads share no data
  const long long li = g.left[p];
  const long long ri = g.right[p];
  const int wla = __ldg(g.len_a + li);
  float mss;
  if ((F & kIdentity) != 0 && g.same && li == ri) {
    mss = identity_levels(min(max(wla, 0), W), g.H, g.betas, g.level_lcs + p * g.H);
  } else {
    mss = score_pair_levels_regs<W, F>(g.table_a + li * g.H * W, g.table_b + ri * g.H * W, W, wla,
                                       __ldg(g.len_b + ri), g.H, g.betas, g.level_lcs + p * g.H);
  }
  g.mss[p] = mss;
}

template <bool IDENTITY>
__global__ void fused_score_shared(const Args g) {
  extern __shared__ int smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const long long p = static_cast<long long>(blockIdx.x) * nt + tid;
  if (p >= g.pairs) return;
  const long long li = g.left[p];
  const long long ri = g.right[p];
  const int L = g.L;
  if (IDENTITY && g.same && li == ri) {
    g.mss[p] = identity_levels(min(max(g.len_a[li], 0), L), g.H, g.betas, g.level_lcs + p * g.H);
    return;
  }
  g.mss[p] = score_pair_levels(g.table_a + li * g.H * L, g.table_b + ri * g.H * L, L,
                               g.len_a[li], g.len_b[ri], g.H, L, g.betas,
                               g.level_lcs + p * g.H, smem, smem + L * nt, nt, tid);
}

unsigned int blocks_for(long long pairs, int threads) {
  return static_cast<unsigned int>((pairs + threads - 1) / threads);
}

// the register kernel of width L, found by recursion over W = 32..1
template <int W, int F>
void launch_regs(const Args& g, int threads, cudaStream_t s) {
  if constexpr (W >= 1) {
    if (g.L == W) {
      fused_score_regs<W, F><<<blocks_for(g.pairs, threads), threads, 0, s>>>(g);
    } else {
      launch_regs<W - 1, F>(g, threads, s);
    }
  }
}

template <bool IDENTITY>
void launch_shared(const Args& g, int threads, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(2) * g.L * threads * sizeof(int);
  fused_score_shared<IDENTITY><<<blocks_for(g.pairs, threads), threads, smem, s>>>(g);
}

Args make_args(const void* table_a, const void* len_a, const void* table_b,
               const void* len_b, const void* left, const void* right,
               const void* betas, void* level_lcs, void* mss, long long pairs,
               int H, int L) {
  return Args{static_cast<const int*>(table_a), static_cast<const int*>(len_a),
              static_cast<const int*>(table_b), static_cast<const int*>(len_b),
              static_cast<const int*>(left),    static_cast<const int*>(right),
              static_cast<const float*>(betas), static_cast<int*>(level_lcs),
              static_cast<float*>(mss),         pairs, H, L,
              table_a == table_b && len_a == len_b};
}

}  // namespace

// All pointers are device pointers of contiguous tensors: table_a/table_b
// int32 [N, H, L], len_a/len_b int32 [N], left/right int32 [pairs], betas
// float32 [H], level_lcs int32 [pairs, H], mss float32 [pairs].  route is
// kRouteRegisters (the register kernel of width L, L <= 32) or kRouteShared
// (the shared-memory kernel, any L); the caller picks it from L.  threads is
// the block size; on the shared route the caller keeps 2 * L * threads * 4
// bytes of shared memory within the 48 KB default.  Launches on ``stream``
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a route that has no kernel at this width.
extern "C" int fused_score_launch(const void* table_a, const void* len_a,
                                  const void* table_b, const void* len_b,
                                  const void* left, const void* right,
                                  const void* betas, void* level_lcs,
                                  void* mss, long long pairs, int H, int L,
                                  int threads, void* stream, int route) {
  if (pairs <= 0) return 0;
  const Args g = make_args(table_a, len_a, table_b, len_b, left, right, betas,
                           level_lcs, mss, pairs, H, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteRegisters && L >= 1 && L <= kMaxRegisterWidth) {
    launch_regs<kMaxRegisterWidth, kEngine>(g, threads, s);
  } else if (route == kRouteShared) {
    launch_shared<true>(g, threads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Variants for timing the design's parts; the engine never calls this.
// variant 0: the parent design, the shared route without the identity
// shortcut (any L); at L = 10 (the main path's width) only, the register
// kernel with one part changed: 1 no identity shortcut, 2 the row loop
// stopped at len_a, 3 loads and stores only (a wrong LCS on purpose).
// Returns cudaErrorInvalidValue for a variant that has no kernel at this
// width.
extern "C" int fused_score_variant_launch(
    const void* table_a, const void* len_a, const void* table_b,
    const void* len_b, const void* left, const void* right, const void* betas,
    void* level_lcs, void* mss, long long pairs, int H, int L, int threads,
    void* stream, int variant) {
  if (pairs <= 0) return 0;
  const Args g = make_args(table_a, len_a, table_b, len_b, left, right, betas,
                           level_lcs, mss, pairs, H, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kPathWidth = 10;
  if (variant == 0) {
    launch_shared<false>(g, threads, s);
  } else if (variant >= 1 && variant <= 3 && L == kPathWidth) {
    // the register kernel at the path's width with one part changed
    constexpr int kFlags[] = {kEngine & ~kIdentity, kEngine | kStop, kEngine & ~kDp};
    using Kernel = void (*)(const Args);
    const Kernel kernels[] = {fused_score_regs<kPathWidth, kFlags[0]>,
                              fused_score_regs<kPathWidth, kFlags[1]>,
                              fused_score_regs<kPathWidth, kFlags[2]>};
    kernels[variant - 1]<<<blocks_for(pairs, threads), threads, 0, s>>>(g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
