// Flash attention (forward, causal or not, GQA) for Hopper (sm_90a):
// q [B, Sq, H, D], k/v [B, Skv, KH, D] (float32 or bfloat16, head dim
// contiguous, any batch/sequence/head strides) -> out [B, Sq, H, D]
// contiguous, in q's dtype.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::
// flash_attention_pallas, and computes the function of
// repro/models/layers.py::chunked_attention, which the serving path runs:
// scores s = (q . k) * (1 / sqrt(D)) in float32, the causal mask
// q_pos >= k_pos filled with -1e30, an online softmax over kv tiles
// (m, l, acc carried in registers), p . v in float32 (p is not rounded to
// v's dtype, as in chunked_attention and unlike the Pallas body), and
// out = acc / max(l, 1e-30) rounded once to q's dtype.  Query head h reads
// kv head h / (H / KH); nothing is replicated.  Ragged Sq and Skv are
// masked here: rows past Sq are neither loaded nor stored, keys past Skv
// get probability 0.
//
// Design: one block of 128 threads per (64-row q tile, b * H + h); causal
// tiles are issued last-first, so the longest ones start first.  The q
// tile and each 64-key k/v tile are staged in shared memory as float32
// (q and k transposed, [D][64 + 4], so a thread reads 4 q rows and 8 keys
// as float4s; v row-major); each thread owns 4 query rows: 8 scores of
// each per tile (the 8 threads of a row reduce max and sum with warp
// shuffles) and D / 8 output columns (tx, tx + 8, ...).  Probabilities go
// through shared memory ([key][row], transposed) into the p . v product.
// Kv tiles wholly above the causal diagonal are skipped: their
// probabilities are exactly 0.  Dynamic shared memory: 4 * (2 D (64 + 4) +
// 64 D + 64 (64 + 4)) bytes, 120 KB at D = 128, 81 KB at D = 80.
//
// Bound on an H100: 4 B H Sq Skv D flops (2 for q.k, 2 for p.v; about half
// of that when causal) against q, k, v and out read or written once; with
// bf16 operands the tensor cores (989 TFLOP/s) would make the bytes the
// bound at short sequences and the operations at long ones.  This kernel
// computes in float32 on the CUDA cores (67 TFLOP/s), with every shared-
// memory load feeding 4-10 multiply-adds, so it runs far above that
// bound; wgmma with TMA-fed tiles is the later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // 16 row groups x 8 column lanes
constexpr int kLd = 64 + 4;      // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Shape {
  int B, Sq, Skv, H, KH, D;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;  // element strides
  int causal;
  float scale;
};

// MAXC: a compile-time bound on D / 8, the output columns of one thread
template <typename T, int MAXC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Shape s) {
  extern __shared__ float smem[];
  const int D = s.D;
  float* qt = smem;               // [D][kLd]: q tile, transposed
  float* kt = qt + D * kLd;       // [D][kLd]: k tile, transposed
  float* vs = kt + D * kLd;       // [kBK][D]: v tile
  float* pt = vs + kBK * D;       // [kBK][kLd]: probabilities, transposed

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int q0 = tile * kBQ;
  const int b = blockIdx.y / s.H;
  const int h = blockIdx.y % s.H;
  const int kvh = h / (s.H / s.KH);
  const T* qp = q + b * s.qb + h * s.qh;
  const T* kp = k + b * s.kb + kvh * s.kh;
  const T* vp = v + b * s.vb + kvh * s.vh;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;        // rows 4 ty .. 4 ty + 3
  const int tx = tid & 7;         // score columns 8 tx .. 8 tx + 7; out columns tx + 8 c
  const int nc = D >> 3;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int row = q0 + r;
    qt[c * kLd + r] = row < s.Sq ? to_f32(qp[row * s.qs + c]) : 0.f;
  }

  float m[4], l[4], acc[4][MAXC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = s.causal ? min(s.Skv, q0 + kBQ) : s.Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const int key = k0 + r;
      const bool ok = key < s.Skv;
      kt[c * kLd + r] = ok ? to_f32(kp[key * s.ks + c]) : 0.f;
      vs[r * D + c] = ok ? to_f32(vp[key * s.vs + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[r][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + c * kLd + 4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(kt + c * kLd + 8 * tx);
      const float4 kb = *reinterpret_cast<const float4*>(kt + c * kLd + 8 * tx + 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[r][j] = fmaf(qv[r], kv[j], sc[r][j]);
    }

    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + 4 * ty + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * tx + j;
        float x = sc[r][j] * s.scale;
        if (key >= s.Skv) x = __int_as_float(static_cast<int>(0xff800000u));  // -inf past the sequence: p = 0
        else if (s.causal && key > row) x = kNegInf;        // chunked_attention's mask value
        sc[r][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[r][j] = expf(sc[r][j] - m_new);
        sum += sc[r][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(pt + (8 * tx + j) * kLd + 4 * ty) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < MAXC; ++c) acc[r][c] *= corr[r];
    __syncthreads();

    const int keys = min(kBK, s.Skv - k0);
    for (int j = 0; j < keys; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + j * kLd + 4 * ty);
      const float* vr = vs + j * D + tx;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < nc) {
          const float vv = vr[8 * c];
          acc[0][c] = fmaf(pa.x, vv, acc[0][c]);
          acc[1][c] = fmaf(pa.y, vv, acc[1][c]);
          acc[2][c] = fmaf(pa.z, vv, acc[2][c]);
          acc[3][c] = fmaf(pa.w, vv, acc[3][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= s.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + ((static_cast<long long>(b) * s.Sq + row) * s.H + h) * D + tx;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < nc) store_as(orow + 8 * c, acc[r][c] / denom);
    }
  }
}

template <typename T, int MAXC>
int launch(const void* q, const void* k, const void* v, void* out, const Shape& s,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(s.D) * kLd +
                                       static_cast<size_t>(kBK) * s.D + kBK * kLd);
  auto kernel = flash_fwd_kernel<T, MAXC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.Sq + kBQ - 1) / kBQ, s.B * s.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dim(const void* q, const void* k, const void* v, void* out,
                   const Shape& s, cudaStream_t stream) {
  const int nc = s.D / 8;
  if (nc <= 8) return launch<T, 8>(q, k, v, out, s, stream);
  if (nc <= 16) return launch<T, 16>(q, k, v, out, s, stream);
  return launch<T, 32>(q, k, v, out, s, stream);
}

}  // namespace

// Device pointers q, k, v, out; element strides (batch, sequence, head) of
// q, k, v (the head dim is contiguous; out is contiguous [B, Sq, H, D]);
// dtype 0 = float32, 1 = bfloat16.  D <= 256 and a multiple of 8, H a
// multiple of KH, Sq and Skv >= 1.  Launches on ``stream`` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
    int H, int KH, int D, long long qb, long long qs, long long qh, long long kb,
    long long ks, long long kh, long long vb, long long vs, long long vh, int causal,
    int dtype, void* stream) {
  if (D <= 0 || D > 256 || D % 8 != 0 || KH <= 0 || H % KH != 0) return 1;  // cudaErrorInvalidValue
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (static_cast<long long>(B) * H > 65535) return 1;  // grid.y
  // the scale as chunked_attention forms it: 1 / sqrt(D) in double, then float
  Shape s{B, Sq, Skv, H, KH, D, qb, qs, qh, kb, ks, kh, vb, vs, vh, causal,
          static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_for_dim<float>(q, k, v, out, s, st);
  if (dtype == 1) return launch_for_dim<__nv_bfloat16>(q, k, v, out, s, st);
  return 1;
}
