// Mamba-2 SSD intra-chunk step for Hopper (sm_90a): for every chunk bc
// and head h,
//
//   M[i][j]  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j    for j <= i, else 0
//   y[i][p]  = sum_j M[i][j] x[j][p]
//   st[p][n] = sum_j x[j][p] * B[j][n] * exp(cum_last - cum_j) * dt_j
//   cd       = exp(cum_last)
//
// x [BC, Q, H, P] and B, C [BC, Q, N] (one group; float32 or bfloat16, the
// same for all three), cum and dt [BC, Q, H] float32 -> y [BC, Q, H, P],
// st [BC, H, P, N] and cd [BC, H], all float32.  Q <= 128, N <= 128,
// P <= 128 and a multiple of 4.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_intra_pallas,
// with the numbers of repro/models/mamba.py::_ssd_chunked, which the
// serving path runs: everything in float32, and y returned in float32, not
// rounded to x's dtype as the Pallas out_shape does.  This is the route for
// float32 operands, and for bfloat16 shapes the tensor-core kernel does not
// take (P or N not a multiple of 16): a float32 x, B or C is not exact in
// bfloat16, so bf16 tensor cores would need every operand split, and TF32
// would round the reference's float32 products.  bfloat16 operands with P
// and N multiples of 16, and ssm_bf16_intra (which this kernel does not
// take), run ssd_intra_sm90.cu on the tensor cores.
//
// Design: C B^T depends on the chunk only (one B/C group), so one block of
// 256 threads takes one chunk and a run of HG heads and computes C B^T once,
// into shared memory ([j][i], lower triangle), from B and C staged
// transposed ([n][row]); each thread makes an 8 x 8 tile of it.  B is then
// restaged row-major for the chunk states.  For each of its heads the block
// stages x [Q][P] and the head's cum and dt, builds M 32 keys at a time in
// shared memory ([j][i], one exp per entry), and accumulates y (each thread
// 4 rows x P / 8 columns; key tiles wholly above a thread's rows are
// skipped) and the state (each thread 4 (or 8) p rows x N / 16 columns).
// Shared memory: 4 * (Q LQ + max(N LQ, Q (N + 4)) + max(N LQ, Q (P + 4) +
// 35 LQ)) bytes with LQ = round8(Q) + 4: 156 KB at Q = 128, N = 64,
// P = 64 (zamba2), 203 KB at N = 128 (mamba2).
//
// Bound on an H100: per chunk 2 Q^2 N flops for C B^T, per chunk and head
// about Q^2 P (y, causal half) + 2 Q P N (state) flops and Q^2 / 2 exps,
// against x, B, C, cum, dt read once and y, st written once.  In float32 on
// the CUDA cores (67 TFLOP/s) the operations bound it at the serving
// path's shapes; the bytes are a third of that.  A shared-memory load feeds
// 4 multiply-adds here (one float4 of M, one x value), so the kernel runs
// at a fraction of that rate.  The serving path's bfloat16 operands take
// ssd_intra_sm90.cu instead, where the float32 M goes to the bf16 tensor
// cores as three bfloat16 parts whose sum is exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kJT = 32;  // keys per tile of M

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Dims {
  int Q, H, P, N, HG, LQ;
};

__host__ __device__ __forceinline__ int max_i(int a, int b) { return a > b ? a : b; }

// shared-memory floats of each region (see the header)
__host__ __device__ __forceinline__ int region_b(const Dims& d) {
  return max_i(d.N * d.LQ, d.Q * (d.N + 4));
}
__host__ __device__ __forceinline__ int region_x(const Dims& d) {
  return max_i(d.N * d.LQ, d.Q * (d.P + 4) + (kJT + 3) * d.LQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ cum,
                 const float* __restrict__ dt, const T* __restrict__ bm,
                 const T* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ st, float* __restrict__ cd, Dims d) {
  extern __shared__ float smem[];
  const int Q = d.Q, H = d.H, P = d.P, N = d.N, LQ = d.LQ;
  const int LN = N + 4, LP = P + 4;
  float* cbt = smem;                 // [Q][LQ]: C B^T, [j][i]
  float* rb = cbt + Q * LQ;          // B transposed [N][LQ], then B [Q][LN]
  float* rx = rb + region_b(d);      // C transposed [N][LQ], then x, M, cum, dt, w
  const long long bc = blockIdx.x;
  const int h0 = blockIdx.y * d.HG;
  const int tid = threadIdx.x;
  const T* bchunk = bm + bc * Q * N;
  const T* cchunk = cm + bc * Q * N;

  // --- C B^T, once for the chunk --------------------------------------
  for (int i = tid; i < Q * N; i += kThreads) {
    const int row = i / N, n = i - row * N;
    rb[n * LQ + row] = to_f32(bchunk[i]);
    rx[n * LQ + row] = to_f32(cchunk[i]);
  }
  __syncthreads();
  {
    const int tj = tid >> 4, ti = tid & 15;  // rows j = 8 tj + jj, columns i = 8 ti + ii
    if (8 * tj < Q && 8 * ti < Q) {
      float a[8][8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) a[jj][ii] = 0.f;
      if (tj <= ti) {  // else every j > i: the tile is 0
        for (int n = 0; n < N; ++n) {
          const float4 b0 = *reinterpret_cast<const float4*>(rb + n * LQ + 8 * tj);
          const float4 b1 = *reinterpret_cast<const float4*>(rb + n * LQ + 8 * tj + 4);
          const float4 c0 = *reinterpret_cast<const float4*>(rx + n * LQ + 8 * ti);
          const float4 c1 = *reinterpret_cast<const float4*>(rx + n * LQ + 8 * ti + 4);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int ii = 0; ii < 8; ++ii) a[jj][ii] = fmaf(cv[ii], bv[jj], a[jj][ii]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * tj + jj;
        if (j >= Q) break;
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int i = 8 * ti + ii;
          cbt[j * LQ + i] = j <= i ? a[jj][ii] : 0.f;
        }
      }
    }
  }
  __syncthreads();
  float* bs = rb;  // [Q][LN]
  for (int i = tid; i < Q * N; i += kThreads) {
    const int row = i / N, n = i - row * N;
    bs[row * LN + n] = to_f32(bchunk[i]);
  }
  float* xs = rx;                // [Q][LP]
  float* mt = xs + Q * LP;       // [kJT][LQ]: a tile of M, [j][i]
  float* cum_s = mt + kJT * LQ;  // [Q]
  float* dt_s = cum_s + LQ;      // [Q]
  float* w_s = dt_s + LQ;        // [Q]: exp(cum_last - cum_j) dt_j

  const int ry = tid >> 3, cx = tid & 7;   // y: rows 4 ry + r, columns cx + 8 c
  const int sp = tid >> 4, sn = tid & 15;  // state: rows 64 pb + 4 sp + r, columns sn + 16 c

  for (int hh = 0; hh < d.HG; ++hh) {
    const int h = h0 + hh;
    if (h >= H) break;
    __syncthreads();  // the previous head's reads are done
    for (int i = tid; i < Q; i += kThreads) {
      const long long o = (bc * Q + i) * H + h;
      cum_s[i] = cum[o];
      dt_s[i] = dt[o];
    }
    for (int i = tid; i < Q * P; i += kThreads) {
      const int row = i / P, p = i - row * P;
      xs[row * LP + p] = to_f32(x[((bc * Q + row) * H + h) * P + p]);
    }
    __syncthreads();
    const float last = cum_s[Q - 1];
    for (int i = tid; i < Q; i += kThreads) w_s[i] = expf(last - cum_s[i]) * dt_s[i];
    if (tid == 0) cd[bc * H + h] = expf(last);

    // y = M x, M built kJT keys at a time
    float acc[4][16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
    for (int jt = 0; jt < Q; jt += kJT) {
      const int jn = min(kJT, Q - jt);
      __syncthreads();  // the previous tile's reads are done (and w_s is visible)
      for (int i = tid; i < jn * Q; i += kThreads) {
        const int jj = i / Q, ii = i - jj * Q;
        const int j = jt + jj;
        float mv = 0.f;
        if (j <= ii) mv = cbt[j * LQ + ii] * expf(cum_s[ii] - cum_s[j]) * dt_s[j];
        mt[jj * LQ + ii] = mv;
      }
      __syncthreads();
      if (4 * ry < Q && 4 * ry + 3 >= jt) {
        for (int jj = 0; jj < jn; ++jj) {
          const float4 m4 = *reinterpret_cast<const float4*>(mt + jj * LQ + 4 * ry);
          const float* xr = xs + (jt + jj) * LP + cx;
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            if (cx + 8 * c < P) {
              const float xv = xr[8 * c];
              acc[0][c] = fmaf(m4.x, xv, acc[0][c]);
              acc[1][c] = fmaf(m4.y, xv, acc[1][c]);
              acc[2][c] = fmaf(m4.z, xv, acc[2][c]);
              acc[3][c] = fmaf(m4.w, xv, acc[3][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ry + r;
      if (i >= Q) break;
      float* yrow = y + ((bc * Q + i) * H + h) * P;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        if (cx + 8 * c < P) yrow[cx + 8 * c] = acc[r][c];
      }
    }

    // the chunk state
    float sa[2][4][8];
#pragma unroll
    for (int pb = 0; pb < 2; ++pb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) sa[pb][r][c] = 0.f;
    for (int j = 0; j < Q; ++j) {
      const float w = w_s[j];
      const float* br = bs + j * LN + sn;
      float bv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = sn + 16 * c < N ? br[16 * c] * w : 0.f;
#pragma unroll
      for (int pb = 0; pb < 2; ++pb) {
        if (64 * pb + 4 * sp < P) {
          const float4 x4 = *reinterpret_cast<const float4*>(xs + j * LP + 64 * pb + 4 * sp);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) sa[pb][r][c] = fmaf(xv[r], bv[c], sa[pb][r][c]);
        }
      }
    }
#pragma unroll
    for (int pb = 0; pb < 2; ++pb) {
      if (64 * pb + 4 * sp >= P) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* srow = st + ((bc * H + h) * P + 64 * pb + 4 * sp + r) * N;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (sn + 16 * c < N) srow[sn + 16 * c] = sa[pb][r][c];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* cum, const void* dt, const void* bm, const void* cm,
           void* y, void* st, void* cd, int BC, const Dims& d, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(d.Q) * d.LQ + region_b(d) + region_x(d));
  auto kernel = ssd_intra_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BC, (d.H + d.HG - 1) / d.HG);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(cum), static_cast<const float*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<float*>(cd), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers of contiguous tensors: x [BC, Q, H, P], cum and dt
// [BC, Q, H] float32, bm and cm [BC, Q, N] (x's dtype), y [BC, Q, H, P],
// st [BC, H, P, N] and cd [BC, H] float32.  dtype 0 = float32,
// 1 = bfloat16; heads_per_block heads share one block's C B^T.  Launches on
// ``stream`` and returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_intra_launch(const void* x, const void* cum, const void* dt,
                                const void* bm, const void* cm, void* y, void* st,
                                void* cd, int BC, int Q, int H, int P, int N,
                                int heads_per_block, int dtype, void* stream) {
  if (Q < 1 || Q > 128 || N < 1 || N > 128 || P < 4 || P > 128 || P % 4 != 0 ||
      heads_per_block < 1 || H < 1)
    return 1;  // cudaErrorInvalidValue
  if (BC <= 0) return 0;
  const Dims d{Q, H, P, N, heads_per_block, (Q + 7) / 8 * 8 + 4};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, cum, dt, bm, cm, y, st, cd, BC, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, cum, dt, bm, cm, y, st, cd, BC, d, s);
  return 1;
}
