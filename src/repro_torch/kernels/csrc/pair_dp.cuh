// The per-pair bodies of the fused scorers (fused_score.cu and
// fused_windowed_score.cu): one thread scores one pair over all H levels.
//
// arow/brow point at level 0 of the pair's two operand rows (a window
// slice's first position, or a whole row's); level h starts row_stride ints
// further on.  Positions i < wla of a and j < wlb of b are read; the rest
// are the side sentinels (-1 for side A, -2 for side B), so the W x W row
// DP gives the LCS of the two sentinel-masked rows.  Writes |M_h| to
// level_out[h] and returns the MSS as the forward FMA chain
// acc = fma(|M_h|, beta_h, acc) in h order (__fmaf_rn, so the compiler
// cannot reorder or contract differently) — the rounding order of the
// port's mss_scores, which matches the reference's.
//
// Two bodies:
//   score_pair_levels_regs<W, F>  widths 1..32 (the register route): W is a
//     template argument, so the a row, the b row and the DP row live in
//     registers and both loops unroll into straight-line code; a cell is
//     three SASS instructions (ISETP, VIMNMX, a predicated VIADD).
//   score_pair_levels             widths 33..126 (the shared route): the
//     runtime-W body, b row and DP row in shared memory as [W][blockDim].
#pragma once

// Bits of the register body's template flags.  The engine runs kEngine;
// each other combination the variant launchers build changes one part, to
// be timed (tools/fused_score_breakdown.py).
enum : int {
  kIdentity = 1,  // pairs whose two sides are one row of one table: no DP
  kStop = 2,      // the row loop stops at wla
  kDp = 4,        // run the DP at all (without it: loads and stores only)
  kEngine = kIdentity | kDp,
};

// The launchers' route argument: the caller (kernels/lcs/fused.py route())
// picks it from the DP width.  The register route has a kernel for every
// width up to kMaxRegisterWidth; a wider one is refused, not rerouted.
enum : int { kRouteRegisters = 0, kRouteShared = 1 };
constexpr int kMaxRegisterWidth = 32;

// A pair whose two sides are one row (one window) of one table: the masked
// rows are x + [-1]*k and x + [-2]*k with x the wl valid codes, and their
// LCS is exactly wl for ANY int32 codes (a common subsequence is some
// matches inside the two copies of x, followed by matches of one side's x
// against the other side's sentinels only; those two parts take disjoint
// positions of one copy of x, so there are at most wl matches, and x itself
// gives wl).  No row is read.
__device__ __forceinline__ float identity_levels(int wl, int H,
                                                 const float* __restrict__ betas,
                                                 int* __restrict__ level_out) {
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) {
    level_out[h] = wl;
    acc = __fmaf_rn(static_cast<float>(wl), betas[h], acc);
  }
  return acc;
}

// Positions [0, W) of the row at p into out[], positions >= n as pad, one
// load a position through the read-only path.
template <int W>
__device__ __forceinline__ void load_row(const int* __restrict__ p, int n, int pad, int (&out)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = j < n ? __ldg(p + j) : pad;
}

// The register route's body.  With kEngine it runs every row and column of
// the W x W DP: on an H100 the main path's kernel is bound by its gathered
// b rows, not by its cells, and the subtrajectory path's windows are nearly
// all full, so the stop at wla (kStop) and its per-row exits measured
// slower on both.  The cell is a select: it compiles to one instruction
// fewer than the DPX form __viaddmax_s32(diag, match, max(up, left)), which
// equals it for every LCS DP and measured slower (PERF.md).
template <int W, int F>
__device__ __forceinline__ float score_pair_levels_regs(
    const int* __restrict__ arow, const int* __restrict__ brow,
    long long row_stride, int wla, int wlb, int H,
    const float* __restrict__ betas, int* __restrict__ level_out) {
  wla = min(max(wla, 0), W);
  wlb = min(max(wlb, 0), W);
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) {
    // the a row is shared by most lanes of a warp (pairs sorted by left
    // row), so it comes from L1; the b rows are scattered
    int av[W], bv[W], dp[W];
    load_row<W>(arow + h * row_stride, wla, -1, av);
    load_row<W>(brow + h * row_stride, wlb, -2, bv);
#pragma unroll
    for (int j = 0; j < W; ++j) dp[j] = 0;
    int lvl;
    if constexpr ((F & kDp) != 0) {
      // kStop: rows past wla hold the sentinel -1, which matches only a
      // valid code -1 of b; without one they leave the DP row as it is, and
      // the loop stops at wla (nearly warp-uniform: a warp's pairs share a
      // left row).  b's sentinels (-2) stay in the unrolled columns: a valid
      // code -2 of a may match them, as in the full DP.
      int rows = W;
      if ((F & kStop) != 0 && wla < W) {
        bool b_holds_a_sentinel = false;
#pragma unroll
        for (int j = 0; j < W; ++j) b_holds_a_sentinel |= bv[j] == -1;
        if (!b_holds_a_sentinel) rows = wla;
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (i >= rows) break;
        int diag = 0;    // dp[i][j]
        int left_v = 0;  // dp[i + 1][j]
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const int up = dp[j];  // dp[i][j + 1]
          const int v = (av[i] == bv[j]) ? diag + 1 : max(up, left_v);
          diag = up;
          left_v = v;
          dp[j] = v;
        }
      }
      lvl = dp[W - 1];
    } else {
      // loads and stores only: a value that depends on every loaded code,
      // so the loads stay (a wrong LCS, on purpose)
      lvl = 0;
#pragma unroll
      for (int j = 0; j < W; ++j) lvl ^= av[j] + bv[j];
    }
    level_out[h] = lvl;
    acc = __fmaf_rn(static_cast<float>(lvl), betas[h], acc);
  }
  return acc;
}

// The shared route's body (the first design's, unchanged): the b row and the DP row
// live in shared memory as [W][blockDim] (sb, sdp: this thread's column, so
// dynamic indexing spills nothing to local memory and neighbouring threads
// sit on neighbouring banks); each cell costs two shared loads and a store.
__device__ __forceinline__ float score_pair_levels(
    const int* __restrict__ arow, const int* __restrict__ brow,
    long long row_stride, int wla, int wlb, int H, int W,
    const float* __restrict__ betas, int* __restrict__ level_out, int* sb,
    int* sdp, int nt, int tid) {
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) {
    const int* a = arow + h * row_stride;
    const int* b = brow + h * row_stride;
    for (int j = 0; j < W; ++j) {
      sb[j * nt + tid] = (j < wlb) ? b[j] : -2;
      sdp[j * nt + tid] = 0;
    }
    for (int i = 0; i < W; ++i) {
      const int ai = (i < wla) ? a[i] : -1;
      int diag = 0;    // dp[i][j]
      int left_v = 0;  // dp[i + 1][j]
      for (int j = 0; j < W; ++j) {
        const int up = sdp[j * nt + tid];  // dp[i][j + 1]
        const int v = (ai == sb[j * nt + tid]) ? diag + 1 : max(up, left_v);
        diag = up;
        left_v = v;
        sdp[j * nt + tid] = v;
      }
    }
    const int lvl = sdp[(W - 1) * nt + tid];
    level_out[h] = lvl;
    acc = __fmaf_rn(static_cast<float>(lvl), betas[h], acc);
  }
  return acc;
}
