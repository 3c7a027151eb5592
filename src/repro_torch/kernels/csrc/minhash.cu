// MinHash signatures for Hopper (sm_90a): type codes [N, L] int32 + lengths
// [N] int32 + hash parameters ab [P, 2] int32 -> signatures [N, P] int32.
//
// Replaces the TPU kernel repro/kernels/minhash/kernel.py::minhash_pallas.
// Signature p of a row is the minimum, over its positions i < length, of
// the reference's hash of the code x = types[row, i]:
//
//   lo = (a_lo * x) mod M            a_lo = a & 0xFFFF, a_hi = a >> 16
//   hi = (a_hi * x) mod M            M = 2^31 - 1
//   hi = (hi * 256) mod M, twice
//   h  = fold(fold(lo + hi) + b)     fold(v) = v >= M ? v - M : v
//
// evaluated in int32 exactly as the reference does it: every product and
// sum wraps (computed in uint32_t and reinterpreted), and "mod" is floor-mod
// (the sign of M, as jnp's % and torch's).  The wrapped hash is NOT the
// exact (a*x + b) mod M, and most signatures are negative; a Mersenne
// shift-and-add reduction would give the exact hash and other candidates.
// An empty row gives INT32_MAX.
//
// One thread per output element (row, p), p fastest: a block is
// blockDim.x = min(P, 256) threads over p (looping when P is larger) by
// blockDim.y rows, so the stores of a block are one contiguous run.  The
// threads of a row read the same L codes, which come from L1.
// Bound on an H100: the function must read N * (L + 1) * 4 + P * 8 bytes and
// write N * P * 4, against N * L * P hash evaluations of 16 int32
// operations each as the reference's formula counts them (4 multiplies, 4
// mods, 2 adds, 2 folds of a compare and a select, the mask and the
// minimum); at the paper's shapes (L = 10, P = 16) the operations bound it.
// This kernel spends more: each floor-mod here is up to three
// compare-and-adds, so an evaluation issues ~40 instructions.
#include <cuda_runtime.h>

namespace {

constexpr int kM = 0x7fffffff;        // 2^31 - 1
constexpr int kIntMax = 0x7fffffff;   // empty-row signature

__device__ __forceinline__ int mul_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) * static_cast<unsigned int>(b));
}

__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) + static_cast<unsigned int>(b));
}

// floor-mod by M of any int32 v: the result is in [0, M).  v >= M only for
// v = M; v < 0 needs M added once, or twice for v = -2^31.
__device__ __forceinline__ int floor_mod_m(int v) {
  if (v >= kM) v -= kM;
  if (v < 0) v += kM;
  if (v < 0) v += kM;
  return v;
}

__device__ __forceinline__ int fold(int v) { return v >= kM ? v - kM : v; }

__global__ void minhash_kernel(const int* __restrict__ types,
                               const int* __restrict__ lengths,
                               const int* __restrict__ ab,
                               int* __restrict__ out, long long rows, int L,
                               int P) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int* trow = types + row * L;
  const int n = min(lengths[row], L);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int a = ab[2 * p];
    const int b = ab[2 * p + 1];
    const int a_hi = a >> 16;
    const int a_lo = a & 0xFFFF;
    int best = kIntMax;
    for (int i = 0; i < n; ++i) {
      const int x = trow[i];
      const int lo = floor_mod_m(mul_wrap(a_lo, x));
      int hi = floor_mod_m(mul_wrap(a_hi, x));
      hi = floor_mod_m(mul_wrap(hi, 256));
      hi = floor_mod_m(mul_wrap(hi, 256));
      const int h = fold(add_wrap(fold(add_wrap(lo, hi)), b));
      best = min(best, h);
    }
    out[row * P + p] = best;
  }
}

}  // namespace

// types int32 [rows, L], lengths int32 [rows], ab int32 [P, 2], out int32
// [rows, P]: device pointers of contiguous tensors.  threads is the block
// size (a multiple of 32).  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int minhash_launch(const void* types, const void* lengths,
                              const void* ab, void* out, long long rows, int L,
                              int P, int threads, void* stream) {
  if (rows <= 0 || P <= 0) return 0;
  const int tx = P < threads ? P : threads;
  const int ty = threads / tx;
  const long long blocks = (rows + ty - 1) / ty;
  minhash_kernel<<<static_cast<unsigned int>(blocks), dim3(tx, ty), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(types), static_cast<const int*>(lengths),
      static_cast<const int*>(ab), static_cast<int*>(out), rows, L, P);
  return static_cast<int>(cudaGetLastError());
}
