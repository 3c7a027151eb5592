// Mamba-2 SSD intra-chunk step for Hopper (sm_90a) on the tensor cores: for
// every chunk bc and head h,
//
//   M[i][j]  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j    for j <= i, else 0
//   y[i][p]  = sum_j M[i][j] x[j][p]
//   st[p][n] = sum_j x[j][p] * B[j][n] * exp(cum_last - cum_j) * dt_j
//   cd       = exp(cum_last)
//
// x [BC, Q, H, P] and B, C [BC, Q, N] bfloat16 (one group), cum and dt
// [BC, Q, H] float32 -> y [BC, Q, H, P], st [BC, H, P, N] and cd [BC, H],
// all float32 (y is not rounded to x's dtype).  Q <= 128; P and N multiples
// of 16 up to 128.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_intra_pallas,
// with the numbers of repro/models/mamba.py::_ssd_chunked, which the
// serving path runs.  ssd_intra.cu keeps float32 operands and other shapes
// on the CUDA cores.
//
// Numerics.  x, B and C are bfloat16, so C B^T and every product with x is
// exact on the bf16 tensor cores with float32 accumulation.  Only M (through
// exp and dt) and B * w (w_j = exp(cum_last - cum_j) dt_j) are float32
// values.  Each is split into three bfloat16 parts, hi = bf16(v),
// mid = bf16(v - hi), lo = bf16(v - hi - mid), whose sum is v exactly (24
// significand bits in three 8-bit parts; below |v| ~ 2^-110 the last part
// loses bits under 2^-133), and each part is one more product on the tensor
// cores: y = M_hi x + M_mid x + M_lo x, the same for the state.  M is formed
// as the plain version forms it, (s * exp(cum_i - cum_j)) * dt_j with one
// expf an entry: exp(cum_i) * exp(-cum_j) would overflow (cum reaches -205).
// With BF16_INTRA (the reference's ssm_bf16_intra) the kernel rounds where
// the plain version rounds instead: s, the decay, s * decay and * dt, and
// w, to bfloat16; M then needs one product and B * w (16 significand bits)
// two.
//
// Bound on an H100: the bytes.  At zamba2-2.7b's prefill (BC 64, Q 128,
// H 80, P = N = 64) y (float32, 168 MB), x (84 MB) and the state (84 MB)
// take ~0.10 ms at 3.35 TB/s; the tensor-core work with three parts is ~40
// GFLOP, ~0.04 ms at 989 TFLOP/s.
//
// Design:
// - One block per (chunk, run of HG heads; the wrapper picks HG in 4..10 to
//   fill the SMs' waves), 256 threads: two warpgroups, warpgroup w owns rows
//   i in [64 w, 64 w + 64).  No producer warp: the warpgroup that finishes
//   with an x stage second refills it by TMA, as in flash_attention_sm90.cu.
// - TMA brings C and B [128, N] (zero past Q and N) into 128B-swizzled
//   shared memory once; S = C B^T runs on the tensor cores (wgmma m64n128k16,
//   N / 16 k-steps rounded up to 64 columns), since only the decay and dt
//   depend on the head.  Each thread then parks its S values over the C
//   tile, in a column of its own (float4 rows, conflict-free), and reads 8
//   of them back per k-step: S held in registers across the heads took 64
//   of them and kept one block on an SM; parked, a block needs <= 128
//   registers and two blocks share an SM at N, P <= 64 (~110 KB of shared
//   memory each), so one block's loads and stores overlap the other's
//   arithmetic.
// - x_h [128, P] comes through a 2-stage ring of TMA boxes of a 4-D map over
//   x [BC, Q, H, P] (row stride H P), so the next head's x is in flight
//   while this one computes and no box reads into the next chunk.  The
//   heads' cum, dt and w are tables in shared memory, filled once.
// - y: M is formed in the accumulator layout of S (which is the register
//   A-fragment layout of k16) 16 keys at a time, split, and multiplied into
//   y by register-A wgmma m64n64k16 against x (MN-major: the transpose bit).
//   Rows 0-63 take the first 4 k-steps only (causal); a warp whose rows lie
//   before a k-step's keys feeds zeros.  M is formed branch-free (a select
//   after the exp): a branch around each entry's exp cost a third of the
//   kernel's time.
// - The state: st^T = (B w)^T x, A built in registers from B in shared
//   memory (read through the swizzle) times w, split, B operand x as for y.
//   At N <= 64 the one 64-row tile goes to the warpgroups in turn (head hh
//   to warpgroup hh % 2); at N > 64 each warpgroup takes one tile.
// - Epilogue: y rows as float2 pairs (every store fills 32-byte sectors),
//   state entries n-contiguous; rows past Q, columns past P and N are not
//   written.
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;            // two warpgroups of 64 rows, no producer warp
constexpr int kRows = 128;               // rows of every tile: the chunk, zero-filled past Q
constexpr uint32_t kTile = kRows * 128;  // a [128][64] bf16 tile of 128-byte swizzled rows
constexpr int kMaxHeads = 16;            // heads a block may take (its cum/dt/w tables)
// C B^T of both warpgroups in shared memory after it is formed, each
// thread's values in its own column ([float4 row][128 threads]): 8 rows for
// warpgroup 0 (keys 0-63), 16 for warpgroup 1.  It overwrites the C tile.
constexpr uint32_t kSBytes = (8 + 16) * 128 * 16;
static_assert(2 * kTile <= kSBytes, "the C tile (up to two 64-column chunks) lies under S");

struct Params {
  int Q, H, P, N, HG;
  const float* cum;
  const float* dt;
  float* y;
  float* st;
  float* cd;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Fragment register f of NP bf16 parts of (v0, v1), two neighbouring columns
// of one A-fragment row: part k = bf16 of what parts 0..k-1 left, so that the
// parts sum to v exactly (three parts for a float32, two for a product of
// two bfloat16 values).
template <int NP>
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t (&fr)[NP][4], int f) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);  // .x (low half) = v0
    fr[k][f] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= __low2float(h);
    v1 -= __high2float(h);
  }
}

template <int NP>
__device__ __forceinline__ void fence_parts(uint32_t (&fr)[NP][4]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) fence_regs(fr[k]);
}

// acc[c] += sum over the NP parts of A_part x[16 kk .. 16 kk + 16][64 c ..]:
// x is [key][64-column chunk] in shared memory, MN-major for this product.
template <int NP, int NCP>
__device__ __forceinline__ void issue_parts(float (&acc)[NCP][32], const uint32_t (&fr)[NP][4],
                                            uint32_t x_st, int kk) {
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int c = 0; c < NCP; ++c)
      wgmma_rs_n64(acc[c], fr[k], sw128_desc(x_st + c * kTile + kk * 16 * 128));
}

// M[i][j] for one entry: (s * exp(cum_i - cum_j)) * dt_j as the plain
// version forms it (under BF rounded to bfloat16 where it rounds), 0 for
// keys past the row or the chunk.  Branch-free: the exp of a masked entry
// may be inf and is discarded by the select.
template <bool BF>
__device__ __forceinline__ float m_entry(float s, float cum_i, float cum_j, float dt_j, bool keep) {
  float m;
  if (BF) {
    const float decay = bf16_round(expf(cum_i - cum_j));
    m = bf16_round(bf16_round(bf16_round(s) * decay) * bf16_round(dt_j));
  } else {
    m = (s * expf(cum_i - cum_j)) * dt_j;
  }
  return keep ? m : 0.f;
}

// y of this warpgroup's rows for one head, over KS k-steps of 16 keys.  s_th
// is this thread's column of S, C B^T on the accumulator layout: value
// 4 n + e (float4 row n, component e) is row r + 8 (e / 2), key
// 8 n + cq + e % 2, with r = wrow0 + lane / 4 and cq = 2 (lane % 4).
template <int KS, int NCP, bool BF>
__device__ __forceinline__ void head_y(const float4* s_th, uint32_t x_st, const float* cum_h,
                                       const float* dt_h, int wrow0, int lane, const Params& p,
                                       int bc, int h) {
  constexpr int NP = BF ? 1 : 3;
  const int ra = wrow0 + lane / 4, cq = 2 * (lane % 4);
  const float ci[2] = {cum_h[ra], cum_h[ra + 8]};
  float acc[NCP][32];
#pragma unroll
  for (int c = 0; c < NCP; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  uint32_t fk[NP][4];
#pragma unroll
  for (int c = 0; c < NCP; ++c) fence_regs(acc[c]);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (16 * kk > wrow0 + 15 || 16 * kk >= p.Q) {  // every key past this warp's rows or Q
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int f = 0; f < 4; ++f) fk[k][f] = 0u;
    } else {
      const float4 sa = s_th[(2 * kk) * 128], sb = s_th[(2 * kk + 1) * 128];
      const float s[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // rows ra + 8 (f % 2), keys j, j + 1
        const int row = ra + 8 * (f % 2);
        const int j = 16 * kk + 8 * (f / 2) + cq;
        const float m0 = m_entry<BF>(s[2 * f], ci[f % 2], cum_h[j], dt_h[j], j <= row && j < p.Q);
        const float m1 = m_entry<BF>(s[2 * f + 1], ci[f % 2], cum_h[j + 1], dt_h[j + 1],
                                     j + 1 <= row && j + 1 < p.Q);
        split_pair<NP>(m0, m1, fk, f);
      }
    }
    fence_parts(fk);
    wgmma_fence();
    issue_parts<NP, NCP>(acc, fk, x_st, kk);
    wgmma_commit();
    wgmma_wait<0>();  // the fragments may be rebuilt
    fence_parts(fk);
  }
#pragma unroll
  for (int c = 0; c < NCP; ++c) fence_regs(acc[c]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= p.Q) continue;
    float* yrow = p.y + ((static_cast<long long>(bc) * p.Q + row) * p.H + h) * p.P;
#pragma unroll
    for (int c = 0; c < NCP; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * c + 8 * n + cq;
        if (col < p.P)
          *reinterpret_cast<float2*>(yrow + col) = make_float2(acc[c][4 * n + 2 * r], acc[c][4 * n + 2 * r + 1]);
      }
  }
}

// B[j][n] of a 128B-swizzled [128][64] bf16 tile: 16-byte chunk n / 8 of
// row j sits at chunk (n / 8) ^ (j % 8).
__device__ __forceinline__ float b_at(const uint8_t* tile, int j, int n) {
  const int off = j * 128 + (((n >> 3) ^ (j & 7)) << 4) + ((n & 7) << 1);
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + off));
}

// The state of one head for the 64 state rows n0 .. n0 + 63 (B's tile
// b_tile): st^T[n][p] = sum_j (B[j][n] w_j) x[j][p] over 8 k-steps.
template <int NCP, bool BF>
__device__ __forceinline__ void head_state(uint32_t x_st, const uint8_t* b_tile, const float* w_h,
                                           int n0, int wp, int lane, const Params& p, int bc, int h) {
  constexpr int NP = BF ? 2 : 3;
  const int na = 16 * wp + lane / 4, cq = 2 * (lane % 4);
  float acc[NCP][32];
#pragma unroll
  for (int c = 0; c < NCP; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  uint32_t fk[NP][4];
#pragma unroll
  for (int c = 0; c < NCP; ++c) fence_regs(acc[c]);
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    if (16 * kk >= p.Q) {  // keys past the chunk: w = 0
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int f = 0; f < 4; ++f) fk[k][f] = 0u;
    } else {
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // state rows na + 8 (f % 2), keys j, j + 1
        const int n = na + 8 * (f % 2);
        const int j = 16 * kk + 8 * (f / 2) + cq;
        split_pair<NP>(b_at(b_tile, j, n) * w_h[j], b_at(b_tile, j + 1, n) * w_h[j + 1], fk, f);
      }
    }
    fence_parts(fk);
    wgmma_fence();
    issue_parts<NP, NCP>(acc, fk, x_st, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_parts(fk);
  }
#pragma unroll
  for (int c = 0; c < NCP; ++c) fence_regs(acc[c]);
  float* sth = p.st + (static_cast<long long>(bc) * p.H + h) * p.P * p.N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + na + 8 * r;
    if (n >= p.N) continue;
#pragma unroll
    for (int c = 0; c < NCP; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 64 * c + 8 * i + cq + e;
          if (col < p.P) sth[static_cast<long long>(col) * p.N + n] = acc[c][4 * i + 2 * r + e];
        }
  }
}

// NCN: 64-column chunks of N (1 up to 64, 2 up to 128); NCP: of P.
template <int NCN, int NCP, bool BF>
__global__ void __launch_bounds__(kThreads, NCN == 1 && NCP == 1 ? 2 : 1)
ssd_intra_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap cmap, const Params p) {
  constexpr uint32_t kStage = NCP * kTile;  // one head's x
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // B and C, x stages 0 and 1
  __shared__ int done[2];  // warpgroups that have finished with an x stage, counted up
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t c_s = (raw + 1023u) & ~1023u;  // swizzle atoms: 1,024-aligned
  const uint32_t b_s = c_s + kSBytes;
  const uint32_t x_s = b_s + NCN * kTile;
  const uint8_t* b_gen = smem_raw + (b_s - raw);
  float* cum_s = reinterpret_cast<float*>(smem_raw + (x_s + 2 * kStage - raw));  // [HG][128]
  float* dt_s = cum_s + p.HG * kRows;
  float* w_s = dt_s + p.HG * kRows;
  const uint32_t bc_bar = smem_u32(&bars[0]), full0 = smem_u32(&bars[1]);

  const int bc = blockIdx.x, h0 = blockIdx.y * p.HG;
  const int nh = min(p.HG, p.H - h0);
  const int tid = threadIdx.x;
  auto load_x = [&](int hh) {  // one thread: head h0 + hh's x into stage hh % 2
    const uint32_t full = full0 + 8 * (hh % 2);
    mbar_expect_tx(full, kStage);
    for (int c = 0; c < NCP; ++c)
      tma_load(x_s + (hh % 2) * kStage + c * kTile, &xmap, full, 64 * c, h0 + hh, 0, bc);
  };
  if (tid == 0) {
    mbar_init(bc_bar, 1);
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    done[0] = done[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bc_bar, 2 * NCN * kTile);
    for (int c = 0; c < NCN; ++c) {
      tma_load(c_s + c * kTile, &cmap, bc_bar, 64 * c, 0, 0, bc);
      tma_load(b_s + c * kTile, &bmap, bc_bar, 64 * c, 0, 0, bc);
    }
    for (int hh = 0; hh < min(2, nh); ++hh) load_x(hh);
  }
  // the heads' cum and dt (zero past Q), then w and cd
  for (int i = tid; i < kRows * p.HG; i += kThreads) {
    const int j = i / p.HG, hh = i - j * p.HG;
    float c = 0.f, d = 0.f;
    if (j < p.Q && hh < nh) {
      const long long o = (static_cast<long long>(bc) * p.Q + j) * p.H + h0 + hh;
      c = p.cum[o];
      d = p.dt[o];
    }
    cum_s[hh * kRows + j] = c;
    dt_s[hh * kRows + j] = d;
  }
  __syncthreads();
  for (int i = tid; i < kRows * p.HG; i += kThreads) {
    const int hh = i / kRows, j = i - hh * kRows;
    float w = 0.f;
    if (j < p.Q && hh < nh) {
      w = expf(cum_s[hh * kRows + p.Q - 1] - cum_s[i]) * dt_s[i];
      if (BF) w = bf16_round(w);
    }
    w_s[i] = w;
  }
  if (tid < nh) p.cd[static_cast<long long>(bc) * p.H + h0 + tid] = expf(cum_s[tid * kRows + p.Q - 1]);
  __syncthreads();

  const int wg = tid / 128, wp = (tid % 128) / 32, lane = tid % 32;
  const int wrow0 = 64 * wg + 16 * wp;  // this warp's first row
  const bool has_rows = 64 * wg < p.Q;
  float S[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) S[i] = 0.f;
  mbar_wait(bc_bar, 0);
  __syncwarp();  // the warp reconverges before the .aligned wgmma instructions
  if (has_rows) {  // S = C B^T for this warpgroup's rows, all 128 keys
    fence_regs(S);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * NCN; ++ks) {
      const uint32_t off = (ks / 4) * kTile + (ks % 4) * 32;  // 16 columns inside the swizzle atom
      wgmma_ss(S, sw128_desc(c_s + off + 64 * wg * 128), sw128_desc(b_s + off), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(S);
  }
  __syncthreads();  // both warpgroups' C B^T is done: S may overwrite C
  const float4* s_th = reinterpret_cast<const float4*>(smem_raw + (c_s - raw)) + 8 * 128 * wg + tid % 128;
  if (has_rows) {
    float4* s_out = const_cast<float4*>(s_th);
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      if (wg == 0 && v == 8) break;  // warpgroup 0 keeps keys 0-63
      s_out[v * 128] = make_float4(S[4 * v], S[4 * v + 1], S[4 * v + 2], S[4 * v + 3]);
    }
  }

  // After both warpgroups are done with head hh's x, its stage takes head
  // hh + 2: the warpgroup that finishes second issues the loads.
  auto release = [&](int hh) {
    if (wg == 0)  // this warpgroup's wgmmas are done (named barriers 1 and 2)
      asm volatile("bar.sync 1, 128;" ::: "memory");
    else
      asm volatile("bar.sync 2, 128;" ::: "memory");
    if (tid % 128 == 0 && atomicAdd(&done[hh % 2], 1) % 2 == 1 && hh + 2 < nh) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_x(hh + 2);
    }
  };
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const uint32_t x_st = x_s + (hh % 2) * kStage;
    mbar_wait(full0 + 8 * (hh % 2), (hh / 2) & 1);
    __syncwarp();
    if (has_rows) {
      const float* cum_h = cum_s + hh * kRows;
      const float* dt_h = dt_s + hh * kRows;
      if (wg == 0)
        head_y<4, NCP, BF>(s_th, x_st, cum_h, dt_h, wrow0, lane, p, bc, h);
      else
        head_y<8, NCP, BF>(s_th, x_st, cum_h, dt_h, wrow0, lane, p, bc, h);
    }
    if (NCN == 2 || hh % 2 == wg) {
      const int mt = NCN == 2 ? wg : 0;
      head_state<NCP, BF>(x_st, b_gen + mt * kTile, w_s + hh * kRows, 64 * mt, wp, lane, p, bc, h);
    }
    release(hh);
  }
}

template <int NCN, int NCP, bool BF>
int launch(const CUtensorMap& xm, const CUtensorMap& bm, const CUtensorMap& cm, const Params& p,
           int BC, cudaStream_t stream) {
  const int smem = 1024 + kSBytes + (NCN + 2 * NCP) * kTile +
                   3 * p.HG * kRows * static_cast<int>(sizeof(float));
  auto kernel = ssd_intra_sm90_kernel<NCN, NCP, BF>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BC, (p.H + p.HG - 1) / p.HG);
  kernel<<<grid, kThreads, smem, stream>>>(xm, bm, cm, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF>
int dispatch(const CUtensorMap& xm, const CUtensorMap& bm, const CUtensorMap& cm, const Params& p,
             int BC, cudaStream_t s) {
  if (p.N <= 64) return p.P <= 64 ? launch<1, 1, BF>(xm, bm, cm, p, BC, s) : launch<1, 2, BF>(xm, bm, cm, p, BC, s);
  return p.P <= 64 ? launch<2, 1, BF>(xm, bm, cm, p, BC, s) : launch<2, 2, BF>(xm, bm, cm, p, BC, s);
}

}  // namespace

// Device pointers of contiguous tensors: x [BC, Q, H, P], bm and cm
// [BC, Q, N] bfloat16 (16-byte-aligned), cum and dt [BC, Q, H] float32,
// y [BC, Q, H, P], st [BC, H, P, N] and cd [BC, H] float32.  Q in 1..128,
// P and N multiples of 16 up to 128; heads_per_block (at most 16) heads
// share one block's C B^T; bf16_intra != 0 rounds as the reference's
// ssm_bf16_intra does.  Launches on ``stream`` and returns 0, or the
// cudaError_t of what failed (cudaErrorInvalidValue for operands it does
// not take).
extern "C" int ssd_intra_sm90_launch(const void* x, const void* cum, const void* dt,
                                     const void* bm, const void* cm, void* y, void* st,
                                     void* cd, int BC, int Q, int H, int P, int N,
                                     int heads_per_block, int bf16_intra, void* stream) {
  if (Q < 1 || Q > kRows || P < 16 || P > 128 || P % 16 != 0 || N < 16 || N > 128 ||
      N % 16 != 0 || H < 1 || heads_per_block < 1 || heads_per_block > kMaxHeads)
    return 1;  // cudaErrorInvalidValue
  if (BC <= 0) return 0;
  if ((H + heads_per_block - 1) / heads_per_block > 65535) return 1;  // grid.y
  const void* ptrs[3] = {x, bm, cm};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return 1;
  CUtensorMap xm, bmap, cmap;
  const long long QN = static_cast<long long>(Q) * N, HP = static_cast<long long>(H) * P;
  int err = make_map(&xm, x, P, H, Q, BC, P, HP, Q * HP, kRows);
  if (err == 0) err = make_map(&bmap, bm, N, 1, Q, BC, N, N, QN, kRows);
  if (err == 0) err = make_map(&cmap, cm, N, 1, Q, BC, N, N, QN, kRows);
  if (err != 0) return err;
  const Params p{Q, H, P, N, heads_per_block, static_cast<const float*>(cum),
                 static_cast<const float*>(dt), static_cast<float*>(y), static_cast<float*>(st),
                 static_cast<float*>(cd)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_intra ? dispatch<true>(xm, bmap, cmap, p, BC, s) : dispatch<false>(xm, bmap, cmap, p, BC, s);
}
