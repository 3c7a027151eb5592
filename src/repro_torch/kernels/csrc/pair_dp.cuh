// The per-pair body of the fused scorers (fused_score.cu and
// fused_windowed_score.cu): one thread scores one pair over all H levels.
//
// arow/brow point at level 0 of the pair's two operand rows (a window
// slice's first position, or a whole row's); level h starts row_stride ints
// further on.  Positions i < wla of a and j < wlb of b are read; the rest
// are the side sentinels (-1 for side A, -2 for side B), which never match,
// so the W x W row DP gives the LCS of the two valid prefixes.  The b row
// and the DP row live in shared memory as [W][blockDim] (sb, sdp: this
// thread's column, so dynamic indexing spills nothing to local memory and
// neighbouring threads sit on neighbouring banks); each cell costs two
// shared loads and a store.  Writes |M_h| to level_out[h] and returns the
// MSS as the forward FMA chain acc = fma(|M_h|, beta_h, acc) in h order
// (__fmaf_rn, so the compiler cannot reorder or contract differently) — the
// rounding order of the port's mss_scores, which matches the reference's.
#pragma once

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
