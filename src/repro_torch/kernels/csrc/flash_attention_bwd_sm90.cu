// Flash attention's backward (causal or not, GQA) for Hopper (sm_90a) on the
// tensor cores: q [B, Sq, H, D], k/v [B, Skv, KH, D], out and dout [B, Sq,
// H, D] bfloat16 (head dim contiguous, D a multiple of 16 up to 256, any
// 16-byte-aligned batch/sequence/head strides), the forward's logsumexp lse
// [B, H, Sq] float32 -> dq [B, Sq, H, D], dk and dv [B, Skv, KH, D]
// contiguous bfloat16.
//
// The gradient of flash_attention_sm90.cu's function, which the JAX package
// leaves to jax.grad of repro/models/layers.py::chunked_attention (no TPU
// kernel has a backward); attention/kernel.py::flash_attention_bwd computes
// it in float32 torch ops and stays its plain version.  With s = (q . k) /
// sqrt(D) (the causal mask q_pos >= k_pos), p = exp(s - lse), delta =
// rowsum(dout * out): dv = p^T dout, dp = dout v^T, ds = p (dp - delta),
// dq = ds k / sqrt(D), dk = ds^T q / sqrt(D), dk and dv summed over the
// H / KH query heads that read each kv head.  q, k, v and dout enter the
// tensor cores as the bf16 they are; p and ds are rounded once to bf16 as
// product operands, as the forward rounds p before p . v; lse, delta, p,
// ds and every accumulator are float32; dq, dk, dv are rounded once to bf16.
//
// Bound on an H100: 10 D flops a (query, key) pair the mask keeps (five
// products) at 989 TFLOP/s bf16: [2, 4096, 32, 160] causal is 8.6e11 flops,
// 0.87 ms.  The design runs seven products (s and dp twice) so that every
// output is written once by one block, with no float32 atomics and the same
// bits on every run:
//
// - flash_bwd_delta_kernel: delta = rowsum(dout * out) in float32, one warp
//   a row, into [B, H, Sq].
// - flash_bwd_dkdv_sm90_kernel: one block per (64-key tile, b * KH + kvh),
//   256 threads, its k and v tiles loaded once by TMA.  It walks the kv
//   head's H / KH query heads and, for each, the 64-query steps on or below
//   the diagonal, q and dout brought by TMA through a ring of kNS stages.
//   Warpgroup w forms S^T = K Q^T and dP^T = V dO^T for the step's queries
//   32 w .. 32 w + 31 (wgmma m64n32k16, both operands K-major), then P^T and
//   dS^T in float32 registers, and writes them as bf16 to two 128B-swizzled
//   [64 keys][64 queries] tiles.  Then warpgroup 0 runs dV += P^T dO and
//   warpgroup 1 dK += dS^T Q (wgmma m64n64k16 per 64-column chunk, A from
//   the tile, B = dout or q MN-major: the transpose bit), so each thread
//   holds one float32 accumulator of NC x 32 registers and the GQA sum needs
//   no second pass.
// - flash_bwd_dq_sm90_kernel: the forward's shape.  One block per (128-row
//   q tile, b * H + h), two warpgroups of 64 rows; the q and dout tiles
//   once, k and v tiles through a ring.  S = Q K^T and dP = dO V^T (K-major
//   wgmma), P and dS in registers, dQ += dS K with dS as bf16 A fragments
//   and the k tile MN-major.
//
// Tile sizes follow the head dim's NC 64-column chunks: the dQ kernel's key
// tile is 64 keys up to D = 192 and 32 past it (DqTile), so that q, dout and
// two stages of k and v fit the 227 KB a block may use (193 KB at NC 3 and
// 4); the dK/dV kernel holds k, v, two stages of q and dout and the two
// tiles (161 KB at NC 3, 209 KB at NC 4).  Past the head dim, TMA fills the
// last chunk with zeros: s and dp take D / 16 k-steps, dk, dv and dq carry
// zero columns that are never stored.  Rows past Sq or Skv are zero-filled
// too: a query past Sq gets p = 0 (its lse read as +inf), keys past Skv are
// masked in the dQ kernel, and rows past either sequence are not stored.
// Tiles wholly above the causal diagonal are neither loaded nor computed.
#include <cmath>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;   // two warpgroups, no producer warp
constexpr int kRowBytes = 128;  // a 64-column bf16 row: the 128B swizzle span
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 64;       // keys per dK/dV block
constexpr int kQStep = 64;      // queries per step of the dK/dV kernel (32 a warpgroup)
constexpr int kBQ = 128;        // q rows per dQ block
constexpr int kNS = 2;          // stages of either kernel's ring

// Keys per k/v tile of the dQ kernel for NC 64-column chunks of the head
// dim: a multiple of 16 that the m64nNk16 of q . k takes.
template <int NC>
struct DqTile {
  static constexpr int BK = 64;  // 65-193 KB
};
template <>
struct DqTile<4> {
  static constexpr int BK = 32;  // D 208-256: 193 KB
};

struct Params {
  int Sq, Skv, H, KH, D, causal;
  float scale;
  const float* lse;    // [B, H, Sq], natural log
  const float* delta;  // [B, H, Sq]
  __nv_bfloat16 *dq, *dk, *dv;
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// Byte offset of (row, col) in a 128B-swizzled tile of 64-column bf16 rows:
// 16-byte chunk col / 8 of a row sits at chunk (col / 8) ^ (row % 8).
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return row * kRowBytes + (((col >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// acc[64 x N] = A B^T over the head dim's k-steps of 16 columns (ks < KS;
// none over the zero padding past D): A and B tiles of 64-column chunks of
// 128-byte rows, K-major, a_chunk and b_chunk bytes apart.
template <int KS, int N>
__device__ __forceinline__ void mma_rows(float (&acc)[N / 2], uint32_t a, uint32_t b, uint32_t a_chunk,
                                           uint32_t b_chunk) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t off = (ks % 4) * 32;  // 16 columns inside the swizzle atom
    wgmma_ss(acc, sw128_desc(a + (ks / 4) * a_chunk + off), sw128_desc(b + (ks / 4) * b_chunk + off), ks > 0);
  }
}

__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* out, const __nv_bfloat16* dout, long long ob,
                                       long long os, long long oh, long long db, long long ds, long long dh,
                                       float* delta, int B, int Sq, int H, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(B) * Sq * H) return;
  const int h = row % H, s = (row / H) % Sq, b = row / (static_cast<long long>(H) * Sq);
  const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(out + b * ob + s * os + h * oh);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(dout + b * db + s * ds + h * dh);
  float acc = 0.f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 x = __bfloat1622float2(o[c]), y = __bfloat1622float2(g[c]);
    acc += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * Sq + s] = acc;
}

template <int KS, int NC = (KS + 3) / 4>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap, const Params p) {
  constexpr uint32_t kChunk = 64 * kRowBytes;  // a 64-column chunk of a 64-row tile
  constexpr uint32_t kTile = NC * kChunk;      // a 64-row tile of the head dim
  constexpr uint32_t kStage = 2 * kTile;       // q, then dout
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNS + 1];  // full[kNS], k and v
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1,024-aligned
  const uint32_t v_s = k_s + kTile, st0 = v_s + kTile;
  const uint32_t pt_s = st0 + kNS * kStage, dst_s = pt_s + kChunk;  // P^T, dS^T [key][query]
  const uint32_t full0 = smem_u32(&bars[0]), kv_bar = smem_u32(&bars[kNS]);

  const int b = blockIdx.x / p.KH, kvh = blockIdx.x % p.KH, rep = p.H / p.KH;
  const int k0 = blockIdx.y * kKeys;  // causal: the longest blocks have the lowest y
  const int q_first = p.causal ? k0 / kQStep : 0;  // the first step with a query >= k0
  const int per_head = max(0, (p.Sq + kQStep - 1) / kQStep - q_first);
  const int n_steps = rep * per_head;
  const int tid = threadIdx.x;
  auto load_step = [&](int i) {  // one thread: q and dout of step i into its stage
    const int h = kvh * rep + i / per_head, q0 = (q_first + i % per_head) * kQStep;
    const uint32_t st = st0 + (i % kNS) * kStage, full = full0 + 8 * (i % kNS);
    mbar_expect_tx(full, kStage);
    for (int c = 0; c < NC; ++c) {
      tma_load(st + c * kChunk, &qmap, full, 64 * c, h, q0, b);
      tma_load(st + kTile + c * kChunk, &domap, full, 64 * c, h, q0, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kNS; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(kv_bar, 2 * kTile);
    for (int c = 0; c < NC; ++c) {
      tma_load(k_s + c * kChunk, &kmap, kv_bar, 64 * c, kvh, k0, b);
      tma_load(v_s + c * kChunk, &vmap, kv_bar, 64 * c, kvh, k0, b);
    }
    for (int i = 0; i < min(kNS, n_steps); ++i) load_step(i);
  }
  __syncthreads();

  // this thread: key rows kr and kr + 8 of the tile; in each n8 block of
  // the warpgroup's 32 queries, columns cq and cq + 1
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int kr = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const float sl2 = p.scale * kLog2e;
  float acc[NC][32];  // warpgroup 0: dv; 1: dk / scale
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float s[16], dp[16];

  mbar_wait(kv_bar, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int h = kvh * rep + i / per_head, q0 = (q_first + i % per_head) * kQStep;
    const int qw = q0 + 32 * wg;  // this warpgroup's first query
    // lse (in log2 units) and delta of this thread's 8 queries qw + 8 n + cq + e;
    // a query past Sq gets p = exp2(-inf) = 0
    const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    float lse2[8], dl[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = qw + 8 * (j / 2) + cq + j % 2;
      lse2[j] = q < p.Sq ? p.lse[row0 + q] * kLog2e : __int_as_float(0x7f800000);
      dl[j] = q < p.Sq ? p.delta[row0 + q] : 0.f;
    }
    const uint32_t q_st = st0 + (i % kNS) * kStage, do_st = q_st + kTile;
    mbar_wait(full0 + 8 * (i % kNS), (i / kNS) & 1);
    __syncwarp();  // the warp reconverges before the .aligned wgmma instructions

    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_rows<KS, 32>(s, k_s, q_st + 32 * wg * kRowBytes, kChunk, kChunk);
    mma_rows<KS, 32>(dp, v_s, do_st + 32 * wg * kRowBytes, kChunk, kChunk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // s[4 n + e]: key k0 + kr + 8 (e / 2), query qw + 8 n + cq + e % 2
    const bool diag = p.causal && k0 + kKeys - 1 > q0;  // a key past one of the step's queries
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float pv = exp2f(fmaf(s[e], sl2, -lse2[2 * (e / 4) + e % 2]));
      if (diag && kr + 8 * ((e % 4) / 2) + k0 > qw + 8 * (e / 4) + cq + e % 2) pv = 0.f;
      s[e] = pv;
      dp[e] = pv * (dp[e] - dl[2 * (e / 4) + e % 2]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = swizzled(kr + 8 * r, 32 * wg + 8 * n + cq);
        st_shared(pt_s + off, pack_bf16(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
        st_shared(dst_s + off, pack_bf16(dp[4 * n + 2 * r], dp[4 * n + 2 * r + 1]));
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the tiles, to the tensor cores
    __syncthreads();  // both warpgroups' halves are written

    // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q; 16 queries a k-step
    const uint32_t a_s = wg == 0 ? pt_s : dst_s, b_s = wg == 0 ? do_st : q_st;
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQStep / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_ss_tb_n64(acc[c], sw128_desc(a_s + kk * 32), sw128_desc(b_s + c * kChunk + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    __syncthreads();  // the tiles and the stage are free
    if (tid == 0 && i + kNS < n_steps) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_step(i + kNS);
    }
  }

  // acc[c][4 n + e]: key k0 + kr + 8 (e / 2), column 64 c + 8 n + cq + e % 2
  __nv_bfloat16* grad = wg == 0 ? p.dv : p.dk;
  const float mul = wg == 0 ? 1.f : p.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + 8 * r;
    if (key >= p.Skv) continue;
    __nv_bfloat16* grow = grad + ((static_cast<long long>(b) * p.Skv + key) * p.KH + kvh) *
                                     static_cast<long long>(p.D);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * c + 8 * n + cq;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(grow + col) =
              __floats2bfloat162_rn(acc[c][4 * n + 2 * r] * mul, acc[c][4 * n + 2 * r + 1] * mul);
      }
  }
}

template <int KS, int NC = (KS + 3) / 4>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap, const Params p) {
  constexpr int kBK = DqTile<NC>::BK;
  constexpr uint32_t kQChunk = kBQ * kRowBytes;   // one 64-column chunk of the q or dout tile
  constexpr uint32_t kKVChunk = kBK * kRowBytes;  // one 64-column chunk of a k or v tile
  constexpr uint32_t kStage = 2 * NC * kKVChunk;  // k chunks, then v chunks
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNS + 1];  // full[kNS], q and dout
  __shared__ int done[kNS];  // warpgroups that have finished with the stage, counted up
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + NC * kQChunk, kv_s = do_s + NC * kQChunk;
  const uint32_t full0 = smem_u32(&bars[0]), q_bar = smem_u32(&bars[kNS]);

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal tiles first
  const int kv_end = p.causal ? min(p.Skv, q0 + kBQ) : p.Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  auto load_tile = [&](int j) {  // one thread: k and v of tile j into its stage
    const uint32_t st = kv_s + (j % kNS) * kStage, full = full0 + 8 * (j % kNS);
    mbar_expect_tx(full, kStage);
    for (int c = 0; c < NC; ++c) {
      tma_load(st + c * kKVChunk, &kmap, full, 64 * c, kvh, j * kBK, b);
      tma_load(st + (NC + c) * kKVChunk, &vmap, full, 64 * c, kvh, j * kBK, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kNS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      done[s] = 0;
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(q_bar, 2 * NC * kQChunk);
    for (int c = 0; c < NC; ++c) {
      tma_load(q_s + c * kQChunk, &qmap, q_bar, 64 * c, h, q0, b);
      tma_load(do_s + c * kQChunk, &domap, q_bar, 64 * c, h, q0, b);
    }
    for (int j = 0; j < min(kNS, n_tiles); ++j) load_tile(j);
  }
  __syncthreads();

  // warpgroup wg owns rows q0 + 64 wg ..; this thread rows r0 and r0 + 8
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int wg_row0 = q0 + 64 * wg;
  const int r0 = wg_row0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t q_wg = q_s + 64 * wg * kRowBytes, do_wg = do_s + 64 * wg * kRowBytes;
  const float sl2 = p.scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + row;
    lse2[r] = row < p.Sq ? p.lse[at] * kLog2e : 0.f;
    dl[r] = row < p.Sq ? p.delta[at] : 0.f;
  }

  float acc[NC][32];  // dq / scale
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float s[kBK / 2], dp[kBK / 2];
  uint32_t fa[kBK / 16][4];
  auto release = [&](int j) {  // as flash_attention_sm90.cu: the second warpgroup refills
    if (wg == 0)
      asm volatile("bar.sync 1, 128;" ::: "memory");
    else
      asm volatile("bar.sync 2, 128;" ::: "memory");
    if (tid % 128 == 0 && atomicAdd(&done[j % kNS], 1) % 2 == 1 && j + kNS < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(j + kNS);
    }
  };
  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(full0 + 8 * (j % kNS), (j / kNS) & 1);
    __syncwarp();
    const uint32_t k_st = kv_s + (j % kNS) * kStage, v_st = k_st + NC * kKVChunk;

    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_rows<KS, kBK>(s, q_wg, k_st, kQChunk, kKVChunk);
    mma_rows<KS, kBK>(dp, do_wg, v_st, kQChunk, kKVChunk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // s[4 n + e]: row r0 + 8 (e / 2), key j BK + 8 n + cq + e % 2; only
    // tiles that cross the Skv edge or this warpgroup's diagonal are masked
    const bool mask = (j + 1) * kBK > p.Skv || (p.causal && (j + 1) * kBK - 1 > wg_row0);
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const int r = (e % 4) / 2, key = j * kBK + 8 * (e / 4) + cq + e % 2;
      float pv = exp2f(fmaf(s[e], sl2, -lse2[r]));
      if (mask && (key >= p.Skv || (p.causal && key > r0 + 8 * r))) pv = 0.f;
      s[e] = pv * (dp[e] - dl[r]);  // ds
    }
    // ds to bf16 A fragments of k16 (the accumulator layout is the fragment layout)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) fa[kk][f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);

#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(fa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_rs_n64(acc[c], fa[kk], sw128_desc(k_st + c * kKVChunk + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    release(j);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= p.Sq) continue;
    __nv_bfloat16* grow = p.dq + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) *
                                     static_cast<long long>(p.D);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * c + 8 * n + cq;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(grow + col) = __floats2bfloat162_rn(
              acc[c][4 * n + 2 * r] * p.scale, acc[c][4 * n + 2 * r + 1] * p.scale);
      }
  }
}

template <int KS, int NC = (KS + 3) / 4>
int launch(const CUtensorMap* maps, const Params& p, int B, cudaStream_t stream) {
  // maps: q and dout in 64-row boxes, k and v in 64-row boxes (dK/dV);
  // q and dout in 128-row boxes, k and v in DqTile<NC>::BK-row boxes (dQ)
  const int smem_kv = 1024 + 2 * NC * 64 * kRowBytes + kNS * 2 * NC * 64 * kRowBytes + 2 * 64 * kRowBytes;
  const int smem_q = 1024 + 2 * NC * kBQ * kRowBytes + kNS * 2 * NC * DqTile<NC>::BK * kRowBytes;
  auto dkdv = flash_bwd_dkdv_sm90_kernel<KS>;
  auto dq = flash_bwd_dq_sm90_kernel<KS>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(B * p.KH, (p.Skv + kKeys - 1) / kKeys), kThreads, smem_kv, stream>>>(maps[0], maps[2], maps[3],
                                                                                   maps[1], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq<<<dim3(B * p.H, (p.Sq + kBQ - 1) / kBQ), kThreads, smem_q, stream>>>(maps[4], maps[6], maps[7], maps[5],
                                                                          p);
  return static_cast<int>(cudaGetLastError());
}

int dq_key_tile(int D) { return (D + 63) / 64 == 4 ? DqTile<4>::BK : DqTile<1>::BK; }

}  // namespace

// Device pointers q, k, v, out, dout (bfloat16; head dim contiguous, element
// strides (batch, sequence, head) given, 16-byte-aligned pointers and
// strides of 8 elements for the dims longer than 1), lse (float32 [B, H,
// Sq], the forward's), delta (float32 [B, H, Sq] scratch), dq (bfloat16
// [B, Sq, H, D]), dk, dv (bfloat16 [B, Skv, KH, D]), the last three
// contiguous and fully written.  D a multiple of 16 up to 256, H a multiple
// of KH.  Launches the three kernels on ``stream`` and returns 0, or the
// cudaError_t of what failed (cudaErrorInvalidValue for operands the tensor
// maps cannot describe).
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout, const void* lse,
    void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KH, int D,
    long long qb, long long qs, long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh, long long db, long long ds,
    long long dh, int causal, void* stream) {
  if (D <= 0 || D > 256 || D % 16 != 0 || KH <= 0 || H % KH != 0) return 1;  // cudaErrorInvalidValue
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if ((Sq + kBQ - 1) / kBQ > 65535 || (Skv + kKeys - 1) / kKeys > 65535) return 1;  // grid.y
  const void* ptrs[5] = {q, k, v, out, dout};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return 1;
  CUtensorMap maps[8];
  int err = make_map(&maps[0], q, D, H, Sq, B, qh, qs, qb, kQStep);
  if (err == 0) err = make_map(&maps[1], dout, D, H, Sq, B, dh, ds, db, kQStep);
  if (err == 0) err = make_map(&maps[2], k, D, KH, Skv, B, kh, ks, kb, kKeys);
  if (err == 0) err = make_map(&maps[3], v, D, KH, Skv, B, vh, vs, vb, kKeys);
  if (err == 0) err = make_map(&maps[4], q, D, H, Sq, B, qh, qs, qb, kBQ);
  if (err == 0) err = make_map(&maps[5], dout, D, H, Sq, B, dh, ds, db, kBQ);
  if (err == 0) err = make_map(&maps[6], k, D, KH, Skv, B, kh, ks, kb, dq_key_tile(D));
  if (err == 0) err = make_map(&maps[7], v, D, KH, Skv, B, vh, vs, vb, dq_key_tile(D));
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * Sq * H;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                           st>>>(static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
                                 ob, os, oh, db, ds, dh, static_cast<float*>(delta), B, Sq, H, D);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  // the scale as chunked_attention forms it: 1 / sqrt(D) in double, then float
  const Params p{Sq, Skv, H, KH, D, causal, static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))),
                 static_cast<const float*>(lse), static_cast<const float*>(delta),
                 static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv)};
  switch (D / 16) {
    case 1: return launch<1>(maps, p, B, st);
    case 2: return launch<2>(maps, p, B, st);
    case 3: return launch<3>(maps, p, B, st);
    case 4: return launch<4>(maps, p, B, st);
    case 5: return launch<5>(maps, p, B, st);
    case 6: return launch<6>(maps, p, B, st);
    case 7: return launch<7>(maps, p, B, st);
    case 8: return launch<8>(maps, p, B, st);
    case 9: return launch<9>(maps, p, B, st);
    case 10: return launch<10>(maps, p, B, st);
    case 11: return launch<11>(maps, p, B, st);
    case 12: return launch<12>(maps, p, B, st);
    case 13: return launch<13>(maps, p, B, st);
    case 14: return launch<14>(maps, p, B, st);
    case 15: return launch<15>(maps, p, B, st);
    default: return launch<16>(maps, p, B, st);
  }
}
