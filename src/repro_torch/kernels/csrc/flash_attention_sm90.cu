// Flash attention (forward, causal or not, GQA) for Hopper (sm_90a) on the
// tensor cores: q [B, Sq, H, D], k/v [B, Skv, KH, D] bfloat16 (head dim
// contiguous, D a multiple of 16 up to 256, any 16-byte-aligned batch/
// sequence/head strides) -> out [B, Sq, H, D] contiguous bfloat16.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::
// flash_attention_pallas and computes the function of
// repro/models/layers.py::chunked_attention: s = (q . k) * (1 / sqrt(D)) in
// float32, the causal mask q_pos >= k_pos filled with -1e30, an online
// softmax over kv tiles (m, l in float32, l summed from the float32 p), and
// out = acc / max(l, 1e-30) rounded once to bfloat16.  As in the Pallas body
// (and unlike chunked_attention), p is rounded to bfloat16 before p . v, so
// that the second product runs on the tensor cores too.  Query head h reads
// kv head h / (H / KH); nothing is replicated.
//
// Bound on an H100: 4 D flops a (query, key) pair the mask keeps (2 for
// q . k, 2 for p . v) at 989 TFLOP/s bf16 against q, k, v and out moved once
// at 3.35 TB/s: operations above a few hundred keys, which is every prefill
// layer of the serving path.  So the design keeps the tensor cores fed:
//
// - One block per (128-row q tile, b * H + h), 256 threads: two warpgroups
//   of 64 rows each.  Causal q tiles are issued longest first (the tile
//   index is the slow grid dimension, counted down), so the short tiles
//   fill the last wave.
// - Loads are TMA (cp.async.bulk.tensor) through 4-D tensor maps over the
//   operands' own [B, S, H, D] strides, so the fused-qkv views load with no
//   copy: the q tile once, then BK-key k and v tiles through a ring of NS
//   stages (the Tile table below), one block an SM.  Up to D = 128: 128 keys
//   in 2 stages (4 at D <= 64; 161 KB and 145 KB of shared memory).  Past
//   128 the q tile alone is 48 KB (D <= 192) or 64 KB (D <= 256), and 128-key
//   tiles in 2 stages would need 240 KB or 320 KB of the 227 KB a block may
//   use, so the key tile shrinks: 64 keys in 3 stages at D <= 192 (193 KB),
//   the fastest of the tiles that fit at deepseek-v2's operands, and 64 keys
//   in 2 stages at D <= 256 (193 KB; 80 keys in 225 KB ran within 2% of it
//   and needs 12 more registers a thread).  tools/flash_attention_tiles.py
//   times the candidates; PERF.md has their times.  Each stage has a full
//   mbarrier that counts the TMA bytes; a stage is refilled with the tile NS
//   ahead by one thread of the warpgroup that finishes with it second (a
//   shared counter decides which), so no warp waits for the other
//   warpgroup.  There is no producer warp: a ninth warp puts three warps on
//   one of the SM's four register files (16K registers each), which caps a
//   thread at 168 registers; the two warpgroups need 186-191 at D 80-128,
//   and at 168 ptxas serialized the wgmmas.  Past D = 128 a thread holds o
//   in 32 NC floats (96 at D 144-192, 128 at D 208-256); the narrower key
//   tile gives back registers of s (BK / 2) and of p's fragments (BK / 4):
//   ptxas reports 170 and 202 registers, no spill.
// - S = Q K^T: wgmma.mma_async m64nBKk16, bf16 in, float32 accumulate, both
//   operands K-major in shared memory (D is contiguous in q and k).
// - Softmax in registers on the wgmma accumulator layout: a thread holds two
//   rows; the row max and sum are reduced over the 4 threads of a row with
//   __shfl_xor_sync.  Only tiles that cross the causal diagonal or the Skv
//   edge are masked; tiles wholly above the diagonal are never loaded.
// - O += P V: wgmma m64n64k16 per 64 output columns, with A = P converted to
//   bf16 in registers (the float32 accumulator layout of m64nNk16 is the
//   register A-fragment layout of k16) and B = the v tile in shared memory,
//   which is MN-major for this product: the transpose bit, no copy.
// - Epilogue: acc / max(l, 1e-30) to bf16, stored as bf16 pairs; rows past
//   Sq and columns past D are not written.
// - Each warpgroup runs q . k, the softmax and p . v in turn, and the two
//   warpgroups interleave on the tensor cores.  A schedule that runs the
//   softmax of tile j beside p . v of tile j - 1 ran slower (ptxas
//   serializes wgmmas whose accumulators the softmax reads), and so did
//   64-key tiles and a third stage (at D <= 128).
//
// Where the trouble is, and what this does about it:
// 1. D = 80 (zamba2-2.7b), 144, 160, ...: rows of more than 128 bytes do not
//    fit one 128-byte swizzle box.  The tensor map declares D as its inner
//    dimension and loads boxes of 64 columns; TMA zero-fills columns D.. of
//    the last box, so a tile is [rows][NC x 64] with zeros past D.  q . k
//    runs only D / 16 k-steps (no work on the padding); p . v writes zeros
//    to columns past D, never stored.
// 2. Ragged Sq and Skv: TMA zero-fills rows past either sequence, but a zero
//    key scores 0, not -inf, so keys past Skv are masked to -inf (p exactly
//    0) in the tile that crosses Skv; rows past Sq are computed, not stored.
//    With BK < 128 a warpgroup's last causal tile can lie wholly above its
//    diagonal (the other warpgroup's rows need it): every score is -1e30,
//    so p is exactly 0 and the rescale exactly 1, as in chunked_attention.
// 3. TMA's alignment rules (16-byte global address, strides multiples of 16
//    bytes): the wrapper copies an operand that breaks them (.contiguous())
//    before the launch; the launcher refuses one that still does.
// 4. Descriptor layouts: the wgmma shared-memory descriptors (128B swizzle,
//    8-row groups 1,024 bytes apart, k-steps of 32 bytes inside the swizzle
//    atom) must match the tensor maps' CU_TENSOR_MAP_SWIZZLE_128B and every
//    tile base is 1,024-byte aligned.  A mismatch gives wrong numbers, not
//    an error, so every shape is held against the plain version on the card.
// 5. Build time: inline PTX and a plain C launcher, no CUTLASS or PyTorch
//    header.  cuTensorMapEncodeTiled is looked up in libcuda at run time
//    (cudaGetDriverEntryPoint), so the build does not link it.
#include <cmath>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 128;                   // q rows per block
constexpr int kThreads = 256;              // two warpgroups of 64 rows, no producer warp
constexpr int kRowBytes = 128;             // a 64-column bf16 row: the 128B swizzle span
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Keys per k/v tile (BK, a multiple of 16: the m64nBKk16 of q . k, k-steps
// of 16 keys in p . v) and stages of the k/v ring (NS) for NC 64-column
// chunks of the head dim.  Shared memory: 1 KB of alignment, the q tile
// (NC x 16 KB) and NS stages of k and v (NS x 2 NC x BK x 128 bytes), at most
// the 227 KB a block may use.  attention/kernel.py::key_tile reads BK.
template <int NC>
struct Tile {
  static constexpr int BK = 128, NS = NC == 1 ? 4 : 2;  // 145 KB, 161 KB
};
template <>
struct Tile<3> {
  static constexpr int BK = 64, NS = 3;  // D 144-192: 193 KB
};
template <>
struct Tile<4> {
  static constexpr int BK = 64, NS = 2;  // D 208-256: 193 KB
};

// Keys per k/v tile at head dim D: the tensor maps' box rows.
int key_tile(int D) {
  switch ((D + 63) / 64) {
    case 3: return Tile<3>::BK;
    case 4: return Tile<4>::BK;
    default: return Tile<1>::BK;
  }
}

struct Params {
  int Sq, Skv, H, KH, D, causal;
  float scale;
  __nv_bfloat16* out;
};

// S[64 x BK] = Q K^T over KS k-steps of 16 columns (none over the zero
// padding past D): q and k tiles are 64-column chunks of 128-byte rows.
template <int KS, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_wg, uint32_t k_st,
                                         uint32_t q_chunk, uint32_t kv_chunk) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t off = (ks % 4) * 32;  // 16 columns inside the swizzle atom
    wgmma_ss(sc, sw128_desc(q_wg + (ks / 4) * q_chunk + off),
             sw128_desc(k_st + (ks / 4) * kv_chunk + off), ks > 0);
  }
}

// O[64 x 64 NC] += P V: P as bf16 A fragments, v [key][64-column chunk] in
// shared memory, MN-major for this product (the transpose bit).
template <int NC, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[NC][32], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_st, uint32_t kv_chunk) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs_n64(o[c], pa[kk], sw128_desc(v_st + c * kv_chunk + kk * 16 * kRowBytes));
}

// The online softmax of one tile on the accumulator layout, in place:
// sc[4 n + e] is row r0 + 8 (e / 2), key k0 + 8 n + cq + e % 2.  Leaves p
// (float32) in sc, the rescale of the earlier tiles in corr, and updates
// the row max m and the row sum l (from the float32 p).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool mask, int k0, int r0, int cq,
                                             const Params& p) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] *= p.scale;
  if (mask) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + cq + (i % 2);
      const int row = r0 + 8 * ((i % 4) / 2);
      if (key >= p.Skv)
        sc[i] = __int_as_float(static_cast<int>(0xff800000u));  // -inf past the sequence: p = 0
      else if (p.causal && key > row)
        sc[i] = kNegInf;  // chunked_attention's mask value
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * n + 2 * r + e];
        x = exp2f((x - mx) * kLog2e);
        sum += x;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    corr[r] = exp2f((m[r] - mx) * kLog2e);
    l[r] = l[r] * corr[r] + sum;
    m[r] = mx;
  }
}

// p to bf16 A fragments of k16: k-step kk covers n8 blocks 2 kk and 2 kk + 1
// (the m64nNk16 accumulator layout is the register A-fragment layout).
template <int BK>
__device__ __forceinline__ void to_fragments(const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) pa[kk][f] = pack_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
}

// KS: k-steps of 16 columns in q . k (D / 16); NC: 64-column chunks of the
// head dim (1 for D <= 64, 2 up to 128, 3 up to 192, 4 up to 256); NS:
// stages of the k/v ring; keys per k/v tile from the Tile table.
template <int KS, int NS, int NC = (KS + 3) / 4>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const Params p) {
  constexpr int kBK = Tile<NC>::BK;
  constexpr uint32_t kQChunk = kBQ * kRowBytes;   // one 64-column chunk of the q tile
  constexpr uint32_t kKVChunk = kBK * kRowBytes;  // one 64-column chunk of a k or v tile
  constexpr uint32_t kStage = 2 * NC * kKVChunk;  // k chunks, then v chunks
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[NS + 1];  // full[NS], q
  __shared__ int done[NS];  // warpgroups that have finished with the stage, counted up
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1,024-aligned
  const uint32_t kv_smem = q_smem + NC * kQChunk;
  const uint32_t full0 = smem_u32(&bars[0]), q_bar = smem_u32(&bars[NS]);

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal tiles first
  const int kv_end = p.causal ? min(p.Skv, q0 + kBQ) : p.Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  auto load_tile = [&](int j) {  // one thread: k and v of tile j into its stage
    const uint32_t st = kv_smem + (j % NS) * kStage, full = full0 + 8 * (j % NS);
    mbar_expect_tx(full, kStage);
    for (int c = 0; c < NC; ++c) {
      tma_load(st + c * kKVChunk, &kmap, full, 64 * c, kvh, j * kBK, b);
      tma_load(st + (NC + c) * kKVChunk, &vmap, full, 64 * c, kvh, j * kBK, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      done[s] = 0;
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(q_bar, NC * kQChunk);
    for (int c = 0; c < NC; ++c) tma_load(q_smem + c * kQChunk, &qmap, q_bar, 64 * c, h, q0, b);
    for (int j = 0; j < min(NS, n_tiles); ++j) load_tile(j);
  }
  __syncthreads();

  // warpgroup wg owns rows q0 + 64 wg ..; this thread rows r0 and r0 + 8
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int wg_row0 = q0 + 64 * wg;
  const int r0 = wg_row0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);  // first of this thread's two columns in each n8 block
  const uint32_t q_wg = q_smem + 64 * wg * kRowBytes;

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float sc[kBK / 2];
  uint32_t pa[kBK / 16][4];
  // After both warpgroups are done with tile j, its stage takes tile j + NS:
  // the warpgroup that finishes second issues the loads.
  auto release = [&](int j) {
    if (wg == 0)  // this warpgroup's wgmmas are done (named barriers 1 and 2)
      asm volatile("bar.sync 1, 128;" ::: "memory");
    else
      asm volatile("bar.sync 2, 128;" ::: "memory");
    if (tid % 128 == 0 && atomicAdd(&done[j % NS], 1) % 2 == 1 && j + NS < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(j + NS);
    }
  };
  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS;
    mbar_wait(full0 + 8 * s, (j / NS) & 1);
    __syncwarp();  // the warp reconverges before the .aligned wgmma instructions
    const uint32_t k_st = kv_smem + s * kStage, v_st = k_st + NC * kKVChunk;

    fence_regs(sc);
    wgmma_fence();
    issue_qk<KS, kBK>(sc, q_wg, k_st, kQChunk, kKVChunk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    // only tiles that cross the Skv edge or this warpgroup's causal diagonal are masked
    const bool mask = (j + 1) * kBK > p.Skv || (p.causal && (j + 1) * kBK - 1 > wg_row0);
    softmax_tile<kBK>(sc, m, l, corr, mask, j * kBK, r0, cq, p);
    to_fragments<kBK>(sc, pa);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i % 4) / 2];

#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
    issue_pv<NC, kBK>(o, pa, v_st, kKVChunk);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    release(j);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow =
        p.out + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * static_cast<long long>(p.D);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * c + 8 * n + cq;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * n + 2 * r] / den, o[c][4 * n + 2 * r + 1] / den);
      }
  }
}


template <int KS>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const Params& p,
           int B, cudaStream_t stream) {
  constexpr int NC = (KS + 3) / 4, NS = Tile<NC>::NS;
  const int smem = 1024 + NC * kBQ * kRowBytes + NS * 2 * NC * Tile<NC>::BK * kRowBytes;
  auto kernel = flash_fwd_sm90_kernel<KS, NS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * p.H, (p.Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers q, k, v (bfloat16), out (bfloat16, contiguous [B, Sq, H,
// D]); element strides (batch, sequence, head) of q, k, v, the head dim
// contiguous.  D a multiple of 16 up to 256, H a multiple of KH, the
// pointers 16-byte aligned and the strides multiples of 8 elements (of the
// dims longer than 1).  Launches on ``stream`` and returns 0, or the
// cudaError_t of what failed (cudaErrorInvalidValue for operands the tensor
// maps cannot describe).
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H, int KH,
    int D, long long qb, long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, int causal, void* stream) {
  if (D <= 0 || D > 256 || D % 16 != 0 || KH <= 0 || H % KH != 0) return 1;  // cudaErrorInvalidValue
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if ((Sq + kBQ - 1) / kBQ > 65535) return 1;  // grid.y
  const void* ptrs[3] = {q, k, v};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return 1;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, D, H, Sq, B, qh, qs, qb, kBQ);
  if (err == 0) err = make_map(&km, k, D, KH, Skv, B, kh, ks, kb, key_tile(D));
  if (err == 0) err = make_map(&vm, v, D, KH, Skv, B, vh, vs, vb, key_tile(D));
  if (err != 0) return err;
  // the scale as chunked_attention forms it: 1 / sqrt(D) in double, then float
  const Params p{Sq, Skv, H, KH, D, causal,
                 static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))),
                 static_cast<__nv_bfloat16*>(out)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / 16) {
    case 1: return launch<1>(qm, km, vm, p, B, st);
    case 2: return launch<2>(qm, km, vm, p, B, st);
    case 3: return launch<3>(qm, km, vm, p, B, st);
    case 4: return launch<4>(qm, km, vm, p, B, st);
    case 5: return launch<5>(qm, km, vm, p, B, st);
    case 6: return launch<6>(qm, km, vm, p, B, st);
    case 7: return launch<7>(qm, km, vm, p, B, st);
    case 8: return launch<8>(qm, km, vm, p, B, st);
    case 9: return launch<9>(qm, km, vm, p, B, st);
    case 10: return launch<10>(qm, km, vm, p, B, st);
    case 11: return launch<11>(qm, km, vm, p, B, st);
    case 12: return launch<12>(qm, km, vm, p, B, st);
    case 13: return launch<13>(qm, km, vm, p, B, st);
    case 14: return launch<14>(qm, km, vm, p, B, st);
    case 15: return launch<15>(qm, km, vm, p, B, st);
    default: return launch<16>(qm, km, vm, p, B, st);
  }
}
