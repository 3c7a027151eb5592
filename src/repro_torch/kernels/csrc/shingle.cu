// k-sequential shingle keys for Hopper (sm_90a): type codes [N, L] int32 +
// lengths [N] int32 -> raw keys [N, s_pad] int32.
//
// Replaces the TPU kernel repro/kernels/shingle/kernel.py::shingle_pallas.
// For combination s < S = C(L, k) of the static index table combos [S, k]
// (strictly increasing positions), a row's key is the base-Q pack
// key = (..(types[c0] * Q + types[c1]) * Q + ..) of its codes at those
// positions; it is PAD_KEY (INT32_MAX) where the last position is >= the
// row's length, and in every column s >= S.  The TPU kernel selected the
// codes with k one-hot f32 matmuls on the MXU, exact only because the codes
// are below 2^24; Hopper's tensor cores would round them in TF32, so this
// kernel gathers by the combination table and packs in integer arithmetic
// (unsigned, so a product past 2^31 wraps as the reference's int32 does).
//
// One thread per (row, column) of the output, columns fastest, so the
// stores of a warp are consecutive and coalesce; the 32 threads of a warp
// read the same row (the op's s_pad is a multiple of 128), whose codes
// come from L1.
// Bound on an H100: the function must read N * (L + 1) * 4 bytes and write
// N * s_pad * 4, against N * s_pad * k multiply-adds; at the paper's
// shapes (L = 10, k = 3, s_pad = 128) the output bytes bound it by far.
#include <cuda_runtime.h>

namespace {

constexpr int kPadKey = 0x7fffffff;

__global__ void shingle_kernel(const int* __restrict__ types,
                               const int* __restrict__ lengths,
                               const int* __restrict__ combos,
                               int* __restrict__ out, long long total, int L,
                               int k, int S, int s_pad, int num_types) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long row = e / s_pad;
  const int s = static_cast<int>(e - row * s_pad);
  int key = kPadKey;
  if (s < S && combos[s * k + k - 1] < lengths[row]) {
    const int* trow = types + row * L;
    unsigned int acc = 0u;
    for (int j = 0; j < k; ++j) {
      acc = acc * static_cast<unsigned int>(num_types) +
            static_cast<unsigned int>(trow[combos[s * k + j]]);
    }
    key = static_cast<int>(acc);
  }
  out[e] = key;
}

}  // namespace

// types int32 [rows, L], lengths int32 [rows], combos int32 [S, k], out
// int32 [rows, s_pad] (s_pad >= S): device pointers of contiguous tensors.
// threads is the block size.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int shingle_launch(const void* types, const void* lengths,
                              const void* combos, void* out, long long rows,
                              int L, int k, int S, int s_pad, int num_types,
                              int threads, void* stream) {
  const long long total = rows * s_pad;
  if (total <= 0) return 0;
  const long long blocks = (total + threads - 1) / threads;
  shingle_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(types), static_cast<const int*>(lengths),
      static_cast<const int*>(combos), static_cast<int*>(out), total, L, k, S,
      s_pad, num_types);
  return static_cast<int>(cudaGetLastError());
}
