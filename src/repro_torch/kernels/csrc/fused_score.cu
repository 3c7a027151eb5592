// Fused gather-and-score for Hopper (sm_90a): code tables + pair indices ->
// (level_lcs [P, H] int32, mss [P] float32).
//
// Replaces the TPU kernel repro/kernels/lcs/fused.py::fused_gather_score
// (bodies _fused_kernel and _masked_rows_lcs).  On the TPU a scalar-prefetch
// grid DMA'd each pair's two [H, L] rows straight out of the resident code
// table, so the [P, H, L] gathered copies never existed in HBM.  Here one
// CUDA thread owns one pair: it reads left[p] and right[p] itself, loads its
// rows from the tables, masks positions >= length to the side sentinels
// (-1 for side A, -2 for side B) in registers, runs the exact row DP over
// all L x L cells of each of the H levels, writes |M_h|, and folds the MSS
// epilogue as the forward FMA chain acc = fma(|M_h|, beta_h, acc) in h order
// (pair_dp.cuh, shared with the windowed scorer).
// left/right arrive pre-clamped (no PAD_ID), as score_pairs passes them.
//
// Bound on an H100: the function must read each input once (two [N, H, L]
// tables, two [N] length vectors, two [P] index vectors, H betas) and write
// P * (H + 1) * 4 bytes, against P * H * L * L DP cells of integer work; at
// the main path's shapes (N = 1e6, H = 3, L = 10) the integer work bounds
// it (one op per cell at the 64 int32 lanes per SM).  The
// simple design reads each pair's rows again per pair, uncoalesced (rows are
// scattered by the pair indices), and keeps the b row and the DP row in
// shared memory in a [L][blockDim] layout (pair_dp.cuh).  The DP costs two
// shared loads and a store per cell; that work, not the bytes, is what a
// later PR has to shrink.
#include <cuda_runtime.h>

#include "pair_dp.cuh"

namespace {

__global__ void fused_score_kernel(const int* __restrict__ table_a,
                                   const int* __restrict__ len_a,
                                   const int* __restrict__ table_b,
                                   const int* __restrict__ len_b,
                                   const int* __restrict__ left,
                                   const int* __restrict__ right,
                                   const float* __restrict__ betas,
                                   int* __restrict__ level_lcs,
                                   float* __restrict__ mss,
                                   long long pairs, int H, int L) {
  extern __shared__ int smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const long long p = static_cast<long long>(blockIdx.x) * nt + tid;
  if (p >= pairs) return;  // ragged last block; threads share no data
  const long long li = left[p];
  const long long ri = right[p];
  mss[p] = score_pair_levels(table_a + li * H * L, table_b + ri * H * L, L,
                             len_a[li], len_b[ri], H, L, betas,
                             level_lcs + p * H, smem, smem + L * nt, nt, tid);
}

}  // namespace

// All pointers are device pointers of contiguous tensors: table_a/table_b
// int32 [N, H, L], len_a/len_b int32 [N], left/right int32 [pairs], betas
// float32 [H], level_lcs int32 [pairs, H], mss float32 [pairs].  threads is
// the block size; the caller keeps 2 * L * threads * 4 bytes of shared
// memory within the 48 KB default.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_score_launch(const void* table_a, const void* len_a,
                                  const void* table_b, const void* len_b,
                                  const void* left, const void* right,
                                  const void* betas, void* level_lcs,
                                  void* mss, long long pairs, int H, int L,
                                  int threads, void* stream) {
  if (pairs <= 0) return 0;
  const long long blocks = (pairs + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(2) * L * threads * sizeof(int);
  fused_score_kernel<<<static_cast<unsigned int>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table_a), static_cast<const int*>(len_a),
      static_cast<const int*>(table_b), static_cast<const int*>(len_b),
      static_cast<const int*>(left), static_cast<const int*>(right),
      static_cast<const float*>(betas), static_cast<int*>(level_lcs),
      static_cast<float*>(mss), pairs, H, L);
  return static_cast<int>(cudaGetLastError());
}
