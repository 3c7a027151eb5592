// Batched LCS of pre-gathered, sentinel-padded rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lcs/kernel.py::lcs_pallas (body
// _lcs_kernel): a [B, L] x [B, L] int32 -> [B] int32.  The TPU kernel laid
// the DP along anti-diagonals so that block_b rows vectorized across VPU
// lanes; here each CUDA thread owns one row pair and runs the exact row DP
// over all L x L cells (plain equality, so the -1/-2 side sentinels never
// match), and the ragged last block is masked by a bounds check.
//
// Bound on an H100: per row the kernel must read 2 * L * 4 bytes and write
// 4, against L * L DP cells of integer work (one op a cell at 64 int32
// lanes an SM, 16.7 T cells/s), so at L = 10 it is bound by memory bytes:
// 84 bytes against 100 cells a row, 0.631 ms for the kernel path's 25.2M
// rows at 3.35 TB/s.
//
// Two routes, picked by the caller (kernels/lcs/kernel.py route()) from L:
// - registers, L <= 32: L is a template argument (every width 1..32 is an
//   instantiation), so both rows and the DP row live in registers and the
//   L x L loops unroll into straight-line code (pair_dp.cuh lcs_dp_regs, the
//   fused scorers' DP: about three instructions a cell).  A block of 128
//   threads owns 128 consecutive rows, so its a and b tiles are contiguous
//   and start on a 512-byte multiple; it stages both into shared memory
//   with 16-byte loads (a scalar copy for the ragged last tile or an
//   unaligned operand), at an odd row pitch so that the threads' row reads
//   fall on distinct banks, and stores its 128 results coalesced.
// - shared, L = 33..126: the first design's body, one thread a row pair
//   reading its rows thread-strided, the b row and the DP row in shared
//   memory as [L][blockDim] (two shared loads and a store a cell).
// A register route wider than kMaxRegisterWidth is refused, not rerouted.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): ~0.70 ms on the
// kernel path's rows (90% of the byte bound), 1.8x the shared route there,
// and as fast as its loads and stores alone: the DP hides under them.
#include <cstdint>

#include <cuda_runtime.h>

#include "pair_dp.cuh"

namespace {

constexpr int kRowsPerBlock = 128;  // the register route's block: one row a thread

// a tile's row pitch in shared memory: W rounded up to odd, so the 32 rows
// a warp reads at one column sit on 32 distinct banks
template <int W>
constexpr int kPitch = W % 2 == 0 ? W + 1 : W;

// Copy the count = rows * W ints at src (a tile of consecutive rows) into
// dst at row pitch kPitch<W>: 16-byte loads, all issued before the shared
// stores, when src is 16-byte aligned; one int a load for the rest.
template <int W>
__device__ __forceinline__ void stage_tile(const int* __restrict__ src, int count, int* dst) {
  constexpr int P = kPitch<W>;
  auto put = [&](int e, int v) { dst[(e / W) * P + e % W] = v; };
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // a full tile is 32 * W vectors, ceil(W / 4) a thread
    constexpr int kPerThread = (kRowsPerBlock * W / 4 + kRowsPerBlock - 1) / kRowsPerBlock;
    const int vectors = count / 4;
    const int4* v = reinterpret_cast<const int4*>(src);
    int4 x[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int i = threadIdx.x + r * kRowsPerBlock;
      if (i < vectors) x[r] = __ldg(v + i);
    }
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int i = threadIdx.x + r * kRowsPerBlock;
      if (i < vectors) {
        put(4 * i, x[r].x);
        put(4 * i + 1, x[r].y);
        put(4 * i + 2, x[r].z);
        put(4 * i + 3, x[r].w);
      }
    }
    done = vectors * 4;
  }
  for (int e = done + threadIdx.x; e < count; e += kRowsPerBlock) put(e, __ldg(src + e));
}

// The register route at width W.  F: kDp runs the DP; without it, loads
// and stores only (a wrong LCS on purpose, for timing).
template <int W, int F>
__global__ void __launch_bounds__(kRowsPerBlock)
    lcs_rows_regs(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                  long long rows) {
  constexpr int P = kPitch<W>;
  __shared__ int sa[kRowsPerBlock * P];
  __shared__ int sb[kRowsPerBlock * P];
  const long long first = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const int n = static_cast<int>(min(static_cast<long long>(kRowsPerBlock), rows - first));
  stage_tile<W>(a + first * W, n * W, sa);
  stage_tile<W>(b + first * W, n * W, sb);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= n) return;  // ragged last tile; no sync follows
  int av[W], bv[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    av[j] = sa[t * P + j];
    bv[j] = sb[t * P + j];
  }
  int lvl;
  if constexpr ((F & kDp) != 0) {
    lvl = lcs_dp_regs<W>(av, bv, W);
  } else {
    lvl = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) lvl ^= av[j] + bv[j];
  }
  out[first + t] = lvl;
}

__global__ void lcs_rows_shared(const int* __restrict__ a, const int* __restrict__ b,
                                int* __restrict__ out, long long rows, int L) {
  extern __shared__ int smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.x) * nt + tid;
  if (row >= rows) return;  // ragged last block; threads share no data
  int* sb = smem;           // sb[j * nt + tid] = b[row, j]
  int* sdp = smem + L * nt; // sdp[j * nt + tid] = dp[i][j + 1]
  const int* arow = a + row * L;
  const int* brow = b + row * L;
  for (int j = 0; j < L; ++j) {
    sb[j * nt + tid] = brow[j];
    sdp[j * nt + tid] = 0;
  }
  for (int i = 0; i < L; ++i) {
    const int ai = arow[i];
    int diag = 0;  // dp[i][j]     (previous row, previous column)
    int left = 0;  // dp[i + 1][j] (this row, previous column)
    for (int j = 0; j < L; ++j) {
      const int up = sdp[j * nt + tid];  // dp[i][j + 1]
      const int v = (ai == sb[j * nt + tid]) ? diag + 1 : max(up, left);
      diag = up;
      left = v;
      sdp[j * nt + tid] = v;
    }
  }
  out[row] = sdp[(L - 1) * nt + tid];
}

unsigned int blocks_for(long long rows, int threads) {
  return static_cast<unsigned int>((rows + threads - 1) / threads);
}

// the register kernel of width L, found by recursion over W = 32..1
template <int W, int F>
void launch_regs(const int* a, const int* b, int* out, long long rows, int L, cudaStream_t s) {
  if constexpr (W >= 1) {
    if (L == W) {
      lcs_rows_regs<W, F><<<blocks_for(rows, kRowsPerBlock), kRowsPerBlock, 0, s>>>(a, b, out, rows);
    } else {
      launch_regs<W - 1, F>(a, b, out, rows, L, s);
    }
  }
}

}  // namespace

// a, b: int32 [rows, L] device pointers; out: int32 [rows].  route is
// kRouteRegisters (L <= kMaxRegisterWidth; threads must be kRowsPerBlock)
// or kRouteShared (any L; threads is the block size, and the caller keeps
// 2 * L * threads * 4 bytes of shared memory within the 48 KB default).
// Launches on ``stream`` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a route that has no kernel at this width or
// block size.
extern "C" int lcs_launch(const void* a, const void* b, void* out, long long rows, int L,
                          int threads, void* stream, int route) {
  if (rows <= 0) return 0;
  const int* pa = static_cast<const int*>(a);
  const int* pb = static_cast<const int*>(b);
  int* po = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteRegisters && L >= 1 && L <= kMaxRegisterWidth && threads == kRowsPerBlock) {
    launch_regs<kMaxRegisterWidth, kDp>(pa, pb, po, rows, L, s);
  } else if (route == kRouteShared && L >= 1) {
    const size_t smem = static_cast<size_t>(2) * L * threads * sizeof(int);
    lcs_rows_shared<<<blocks_for(rows, threads), threads, smem, s>>>(pa, pb, po, rows, L);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Variants for timing; the engine never calls this.  variant 0: the
// register route's staging, row reads and stores without the DP (a wrong
// LCS on purpose), at the kernel paths' widths 10 and 8 only.  Returns
// cudaErrorInvalidValue for a variant that has no kernel at this width.
extern "C" int lcs_variant_launch(const void* a, const void* b, void* out, long long rows, int L,
                                  int threads, void* stream, int variant) {
  if (rows <= 0) return 0;
  const int* pa = static_cast<const int*>(a);
  const int* pb = static_cast<const int*>(b);
  int* po = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant != 0 || threads != kRowsPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 10) {
    lcs_rows_regs<10, 0><<<blocks_for(rows, kRowsPerBlock), kRowsPerBlock, 0, s>>>(pa, pb, po, rows);
  } else if (L == 8) {
    lcs_rows_regs<8, 0><<<blocks_for(rows, kRowsPerBlock), kRowsPerBlock, 0, s>>>(pa, pb, po, rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
