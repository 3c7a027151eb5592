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
// The DP and the MSS epilogue are fused_score.cu's own (pair_dp.cuh), run
// on the slices with W in place of L.  left/right arrive pre-clamped (no
// PAD_ID) and offsets lie in [0, L): the wrapper checks both.
//
// Bound on an H100: the function must read each input once (the [N, H, L]
// table and [N] lengths, four [P] coordinate vectors, H betas) and write
// P * (H + 1) * 4 bytes, against P * H * W * W DP cells of integer work; at
// the subtrajectory path's shapes (N = 1e5, H = 3, L = 20, W = 8) the 192
// cells a pair, at one int32 op per cell and 64 int32 lanes per SM, take
// a little longer than the 32 bytes a pair of coordinates and outputs at
// the HBM rate, so the integer work bounds it, narrowly.  Per-pair row
// reads are scattered by the pair indices, as in fused_score.cu.
#include <cuda_runtime.h>

#include "pair_dp.cuh"

namespace {

__global__ void fused_windowed_score_kernel(const int* __restrict__ table_a,
                                            const int* __restrict__ len_a,
                                            const int* __restrict__ table_b,
                                            const int* __restrict__ len_b,
                                            const int* __restrict__ left,
                                            const int* __restrict__ right,
                                            const int* __restrict__ off_a,
                                            const int* __restrict__ off_b,
                                            const float* __restrict__ betas,
                                            int* __restrict__ level_lcs,
                                            float* __restrict__ mss,
                                            long long pairs, int H, int L,
                                            int W) {
  extern __shared__ int smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const long long p = static_cast<long long>(blockIdx.x) * nt + tid;
  if (p >= pairs) return;  // ragged last block; threads share no data
  const long long li = left[p];
  const long long ri = right[p];
  const int oa = off_a[p];
  const int ob = off_b[p];
  // window lengths: clip(min(len, L) - off, 0, W)
  const int wla = max(0, min(min(len_a[li], L) - oa, W));
  const int wlb = max(0, min(min(len_b[ri], L) - ob, W));
  mss[p] = score_pair_levels(table_a + li * H * L + oa,
                             table_b + ri * H * L + ob, L, wla, wlb, H, W,
                             betas, level_lcs + p * H, smem, smem + W * nt,
                             nt, tid);
}

}  // namespace

// All pointers are device pointers of contiguous tensors: table_a/table_b
// int32 [N, H, L], len_a/len_b int32 [N], left/right/off_a/off_b int32
// [pairs], betas float32 [H], level_lcs int32 [pairs, H], mss float32
// [pairs].  W = min(window, L) >= 1.  threads is the block size; the caller
// keeps 2 * W * threads * 4 bytes of shared memory within the 48 KB
// default.  Launches on ``stream`` and returns cudaGetLastError() (0 on
// success).
extern "C" int fused_windowed_score_launch(
    const void* table_a, const void* len_a, const void* table_b,
    const void* len_b, const void* left, const void* right, const void* off_a,
    const void* off_b, const void* betas, void* level_lcs, void* mss,
    long long pairs, int H, int L, int W, int threads, void* stream) {
  if (pairs <= 0) return 0;
  const long long blocks = (pairs + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(2) * W * threads * sizeof(int);
  fused_windowed_score_kernel<<<static_cast<unsigned int>(blocks), threads,
                                smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table_a), static_cast<const int*>(len_a),
      static_cast<const int*>(table_b), static_cast<const int*>(len_b),
      static_cast<const int*>(left), static_cast<const int*>(right),
      static_cast<const int*>(off_a), static_cast<const int*>(off_b),
      static_cast<const float*>(betas), static_cast<int*>(level_lcs),
      static_cast<float*>(mss), pairs, H, L, W);
  return static_cast<int>(cudaGetLastError());
}
