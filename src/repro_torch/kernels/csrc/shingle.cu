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
// Bound on an H100: the function must read N * (L + 1) * 4 bytes and write
// N * s_pad * 4, against N * s_pad * k multiply-adds; at the paper's shapes
// (N = 1M, L = 10, k = 3, s_pad = 128) it writes 512 MB and reads 44 MB,
// 0.166 ms at 3.35 TB/s: the output bytes bound it by far.
//
// Design (the kernel runs at the rate it writes):
// - A persistent grid (as many blocks as fit on the SMs) of warps that
//   stride over rows; a warp writes one row's 128-column chunk at a time,
//   and keeps one chunk for its whole life when the grid has a warp for
//   every chunk (s_pad = 128: every warp, every row).
// - Each lane owns four columns of the chunk.  Before the row loop it loads
//   their combination indices and last indices into registers once (k is a
//   template argument up to kMaxRegisterK; a wider k reads the table through
//   L1 in the row loop), so a row costs no division and no table load.
// - A row's codes arrive in one coalesced load (lane j < L holds code j,
//   prefetched a row ahead) and are picked by __shfl_sync for L <= 32; wider
//   rows are staged in a per-warp shared-memory slice.  The length is one
//   broadcast load.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): ~0.23 ms at the
// shapes above, 3x the first design; the loads and stores alone take
// ~0.21 and a fill of the same output ~0.16, so the mixed read/write
// stream sets the time, not the picks and packs.
// - The four keys go out as one 16-byte streaming store (__stcs on an int4:
//   512 MB written once, larger than L2), lanes on consecutive 16 bytes.
//   Where s_pad % 4 != 0 or the output is not 16-byte aligned, lane q*32+j
//   of the chunk stores column q*32+j as a scalar instead.
// The first design (one thread per output int, a 64-bit division and k + 1
// dependent table loads each) is kept as variant 0 of the variant launcher,
// for timing only.
#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kPadKey = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 128;         // columns a warp writes per row: 32 lanes x 4
constexpr int kMaxWarps = 8;        // warps a block
constexpr int kMaxRegisterK = 8;    // k up to this: indices in registers
constexpr int kMaxShuffleWidth = 32;
// widest row the shared route stages: one warp's slice in the 48 KB a block
// may use without an opt-in
constexpr int kMaxWidth = 48 * 1024 / 4;

enum : int { kRouteShuffle = 0, kRouteShared = 1 };
enum : int { kEngine = 0, kLoadsStores = 1 };  // kernel flags (timing only)

struct Args {
  const int* types;
  const int* lengths;
  const int* combos;
  int* out;
  long long rows;
  int L, k, S, s_pad, num_types;
  int chunks;  // ceil(s_pad / kChunk)
  bool vec;    // 16-byte stores: s_pad % 4 == 0 and out 16-byte aligned
};

// column q of this lane in chunk c
__device__ __forceinline__ int column(const Args& g, long long c, int lane, int q) {
  return static_cast<int>(c) * kChunk + (g.vec ? lane * 4 + q : q * 32 + lane);
}

// The lane's four columns: their combination indices (K > 0: in registers)
// or their table rows (K == 0: k read in the row loop), and last indices
// (INT_MAX for a column >= S, so it is never valid).
template <int K>
struct Columns {
  int idx[4][K > 0 ? K : 1];
  int col[4];
  int last[4];
};

template <int K>
__device__ __forceinline__ void load_columns(Columns<K>& st, const Args& g, long long c, int lane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int s = column(g, c, lane, q);
    const bool real = s < g.S;
    st.col[q] = real ? s : -1;
    st.last[q] = real ? __ldg(g.combos + static_cast<long long>(s) * g.k + g.k - 1) : INT_MAX;
    if constexpr (K > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        st.idx[q][j] = real ? __ldg(g.combos + static_cast<long long>(s) * K + j) : 0;
      }
    }
  }
}

// The four keys of one row, codes picked by pick(position).  Every lane
// runs every pick (a shuffle needs the whole warp); a column's key is
// selected only after.
template <int K, typename Pick>
__device__ __forceinline__ int4 row_keys(const Columns<K>& st, const Args& g, int len, Pick pick) {
  const unsigned q_types = static_cast<unsigned>(g.num_types);
  int key[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned acc = 0u;
    if constexpr (K > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) acc = acc * q_types + static_cast<unsigned>(pick(st.idx[q][j]));
    } else {
      const int* combo = g.combos + static_cast<long long>(max(st.col[q], 0)) * g.k;
      for (int j = 0; j < g.k; ++j) {
        const int p = st.col[q] >= 0 ? __ldg(combo + j) : 0;
        acc = acc * q_types + static_cast<unsigned>(pick(p));
      }
    }
    key[q] = st.last[q] < len ? static_cast<int>(acc) : kPadKey;
  }
  return make_int4(key[0], key[1], key[2], key[3]);
}

__device__ __forceinline__ void store_keys(const Args& g, long long row, long long c, int lane,
                                           int4 keys) {
  int* orow = g.out + row * g.s_pad;
  if (g.vec) {
    const int s = column(g, c, lane, 0);
    if (s < g.s_pad) __stcs(reinterpret_cast<int4*>(orow + s), keys);
  } else {
    const int key[4] = {keys.x, keys.y, keys.z, keys.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = column(g, c, lane, q);
      if (s < g.s_pad) __stcs(orow + s, key[q]);
    }
  }
}

// K: the order k (0 = any k, read through L1); ROUTE: how a row's codes
// reach the lanes; F: kEngine, or kLoadsStores (the row's loads and the
// stores without the picks and the pack, for timing).
template <int K, int ROUTE, int F>
__global__ void __launch_bounds__(kMaxWarps * 32) shingle_rows(const Args g) {
  extern __shared__ int slices[];  // kRouteShared: one L-int slice a warp
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const long long gw = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long G = static_cast<long long>(gridDim.x) * warps;
  // the warp's chunks and rows: one chunk for its whole life when the grid
  // has a warp for every chunk, else every row of a strided set of chunks
  long long c0 = gw, c_step = G, r0 = 0, r_step = 1;
  if (g.chunks < G) {
    const long long groups = G / g.chunks;
    if (gw >= groups * g.chunks) return;  // a whole warp: no sync is missed
    c0 = gw % g.chunks;
    c_step = g.chunks;
    r0 = gw / g.chunks;
    r_step = groups;
  }
  const int L = g.L;
  for (long long c = c0; c < g.chunks; c += c_step) {
    Columns<K> st;
    load_columns(st, g, c, lane);
    if constexpr (ROUTE == kRouteShuffle) {
      // lane j < L holds code j of the row; the next row's code and length
      // are in flight while this row is packed and stored
      auto fetch = [&](long long row, int& code, int& len) {
        code = 0;
        len = 0;
        if (row < g.rows) {
          if (lane < L) code = __ldg(g.types + row * L + lane);
          len = __ldg(g.lengths + row);
        }
      };
      int code, len;
      fetch(r0, code, len);
      for (long long row = r0; row < g.rows; row += r_step) {
        int next_code, next_len;
        fetch(row + r_step, next_code, next_len);
        int4 keys;
        if constexpr (F == kEngine) {
          keys = row_keys(st, g, len, [&](int p) { return __shfl_sync(kFull, code, p); });
        } else {
          keys = make_int4(code, len, code ^ len, st.last[0]);
        }
        store_keys(g, row, c, lane, keys);
        code = next_code;
        len = next_len;
      }
    } else {
      int* slice = slices + warp * L;
      for (long long row = r0; row < g.rows; row += r_step) {
        const int* trow = g.types + row * L;
        for (int j = lane; j < L; j += 32) slice[j] = __ldg(trow + j);
        const int len = __ldg(g.lengths + row);
        __syncwarp();
        const int4 keys = row_keys(st, g, len, [&](int p) { return slice[p]; });
        __syncwarp();  // the slice is rewritten by the next row
        store_keys(g, row, c, lane, keys);
      }
    }
  }
}

// the first design: one thread per (row, column) of the output
__global__ void shingle_parent(const int* __restrict__ types, const int* __restrict__ lengths,
                               const int* __restrict__ combos, int* __restrict__ out,
                               long long total, int L, int k, int S, int s_pad, int num_types) {
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

using Kernel = void (*)(const Args);

// the engine kernel of order k on a route, found by recursion over
// K = kMaxRegisterK..1 (0 for any wider k)
template <int K, int ROUTE>
Kernel engine_kernel(int k) {
  if constexpr (K >= 1) {
    if (k == K) return shingle_rows<K, ROUTE, kEngine>;
    return engine_kernel<K - 1, ROUTE>(k);
  } else {
    return shingle_rows<0, ROUTE, kEngine>;
  }
}

Args make_args(const void* types, const void* lengths, const void* combos, void* out,
               long long rows, int L, int k, int S, int s_pad, int num_types) {
  return Args{static_cast<const int*>(types),
              static_cast<const int*>(lengths),
              static_cast<const int*>(combos),
              static_cast<int*>(out),
              rows, L, k, S, s_pad, num_types,
              (s_pad + kChunk - 1) / kChunk,
              s_pad % 4 == 0 && reinterpret_cast<unsigned long long>(out) % 16 == 0};
}

// A persistent launch: as many blocks as fit on the card at once, no more
// than there are (row, chunk) pairs for their warps.
int launch_rows(Kernel kernel, const Args& g, cudaStream_t stream) {
  const int warps =
      g.L <= kMaxShuffleWidth ? kMaxWarps : std::max(1, std::min(kMaxWarps, kMaxWidth / g.L));
  const size_t smem = g.L <= kMaxShuffleWidth ? 0 : static_cast<size_t>(warps) * g.L * sizeof(int);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  const long long work = (g.rows * g.chunks + warps - 1) / warps;
  const long long blocks = std::min(work, static_cast<long long>(std::max(sms * per_sm, 1)));
  kernel<<<static_cast<unsigned int>(blocks), warps * 32, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// types int32 [rows, L], lengths int32 [rows], combos int32 [S, k], out
// int32 [rows, s_pad] (s_pad >= S): device pointers of contiguous tensors.
// Rows wider than kMaxWidth codes (only k = 1 or k >= L - 1 keep C(L, k)
// small there) are refused with cudaErrorInvalidValue.  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int shingle_launch(const void* types, const void* lengths, const void* combos,
                              void* out, long long rows, int L, int k, int S, int s_pad,
                              int num_types, void* stream) {
  if (L > kMaxWidth || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || s_pad <= 0) return 0;
  const Args g = make_args(types, lengths, combos, out, rows, L, k, S, s_pad, num_types);
  const Kernel kernel = L <= kMaxShuffleWidth ? engine_kernel<kMaxRegisterK, kRouteShuffle>(k)
                                              : engine_kernel<kMaxRegisterK, kRouteShared>(k);
  return launch_rows(kernel, g, static_cast<cudaStream_t>(stream));
}

// Variants for timing; the op never calls this.  variant 0: the first
// design (any shape); variant 1: the engine kernel's loads and stores
// without the picks and the pack (a wrong key on purpose), k = 3 and
// L <= 32 only.  Returns cudaErrorInvalidValue for a variant that has no
// kernel at this shape.
extern "C" int shingle_variant_launch(const void* types, const void* lengths,
                                      const void* combos, void* out, long long rows, int L,
                                      int k, int S, int s_pad, int num_types, void* stream,
                                      int variant) {
  if (rows <= 0 || s_pad <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    constexpr int kThreads = 256;
    const long long total = rows * s_pad;
    shingle_parent<<<static_cast<unsigned int>((total + kThreads - 1) / kThreads), kThreads, 0,
                     s>>>(static_cast<const int*>(types), static_cast<const int*>(lengths),
                          static_cast<const int*>(combos), static_cast<int*>(out), total, L, k,
                          S, s_pad, num_types);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 1 && k == 3 && L <= kMaxShuffleWidth) {
    const Args g = make_args(types, lengths, combos, out, rows, L, k, S, s_pad, num_types);
    return launch_rows(shingle_rows<3, kRouteShuffle, kLoadsStores>, g, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
