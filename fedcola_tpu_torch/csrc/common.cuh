// Shared building blocks of the fused-sublayer kernels (attn_fwd.cu,
// attn_bwd.cu, mlp_fwd.cu, mlp_bwd.cu), which replace the Pallas kernels
// of fedcola_tpu/ops/fused_attention.py and fused_mlp.py.  Each TPU kernel
// becomes a fixed sequence of these pieces, launched back to back on the
// caller's stream:
//
//   * gemm_kernel        per-client batched GEMM; bf16 operands run on the
//                        tensor cores through mma.sync m16n8k16 with f32
//                        accumulation, f32 operands run on FMA (no TF32).
//                        Operands are addressed through (row, col) strides,
//                        so one kernel covers x.W, x.W^T and the
//                        reduce-over-rows product A^T.B that yields dW.
//                        Epilogues: +bias, exact-erf GELU, and the residual
//                        join x + s[c,b]*acc.  What bounds it: operands go
//                        element by element through registers into one
//                        shared buffer, so no load overlaps a product, and
//                        a dW tile's block walks every row of a client
//                        alone (about 10 TFLOP/s in bf16 on the H100).  The
//                        float32 paths keep it as the card's exactness
//                        check, and bf16 shapes off TMA's grid; the bf16
//                        forwards and backwards of the fused route run on
//                        gemm_sm90.cuh (TMA + wgmma, fused epilogues,
//                        split-row dW sums).
//   * ln_fwd_kernel      LayerNorm forward: normalised rows + mean/rstd.
//   * ln_bwd_kernel      LayerNorm backward for dx (+ the identity branch).
//   * colsum_*           deterministic per-client column sums (dbias, dLN
//                        params) in two passes: fixed row chunks (32, or
//                        as many as the caller's scratch holds), then the
//                        chunks summed in order.  No atomics anywhere, so
//                        every result is bit-reproducible run to run.
//   * elementwise        DropPath row scaling, GELU backward.
//
// Everything here is internal to one translation unit (anonymous
// namespace); each .cu file exports one C entry point per TPU kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#define FC_CHECK()                                   \
  do {                                               \
    cudaError_t e__ = cudaGetLastError();            \
    if (e__ != cudaSuccess) return (int)e__;         \
  } while (0)

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865475f));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------------ GEMM --

// C(c, m, n) = epilogue( sum_k A(c, m, k) * B(c, k, n) ) for c = blockIdx.z.
struct GemmArgs {
  int M, N, K;
  const void* A; long long sam, sak, sac;  // A(c,m,k) = A[c*sac + m*sam + k*sak]
  const void* B; long long sbk, sbn, sbc;  // B(c,k,n) = B[c*sbc + k*sbk + n*sbn]
  void* C; long long ldc, scc;             // C(c,m,n) = C[c*scc + m*ldc + n]
  const void* bias; long long sbiasc;      // bias(c,n) = bias[c*sbiasc + n] (T)
  int gelu;                                // 1: exact-erf GELU after the bias
  const void* res;                         // residual x, laid out like C (T)
  const float* s;                          // DropPath scale s[(c*M + m)/seq]
  int seq;
};

constexpr int GBM = 64, GBN = 64, GBK = 32, GT = 128, GPAD = 8;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 64x64 output tile per block, 4 warps; K walked in 32-deep slabs staged
// through shared memory as As[m][k] and Bs[n][k] (k contiguous, padded so
// the fragment loads are bank-conflict free).  The accumulators pass
// through shared memory once more so the epilogue writes coalesced rows
// whatever the fragment layout.
template <typename T, typename OutT>
__global__ void __launch_bounds__(GT) gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) T As[GBM][GBK + GPAD];
  __shared__ __align__(16) T Bs[GBN][GBK + GPAD];
  __shared__ float Cs[GBM][GBN + 4];

  const int tid = threadIdx.x;
  const int c = blockIdx.z;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const T* A = static_cast<const T*>(g.A) + (long long)c * g.sac;
  const T* B = static_cast<const T*>(g.B) + (long long)c * g.sbc;
  const bool a_kcontig = (g.sak == 1);
  const bool b_kcontig = (g.sbk == 1);
  const T zero = from_f<T>(0.0f);

  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // bf16: warp tile 32x32 = 2 (m16) x 4 (n8) mma tiles
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gq = lane >> 2, tq = lane & 3;
  // f32: thread micro-tile of 4 rows x 8 cols
  const int tm = tid >> 3, tn = tid & 7;

  for (int k0 = 0; k0 < g.K; k0 += GBK) {
#pragma unroll 4
    for (int i = 0; i < GBM * GBK / GT; ++i) {
      const int e = tid + i * GT;
      int m, k;
      if (a_kcontig) { m = e / GBK; k = e % GBK; } else { k = e / GBM; m = e % GBM; }
      const int gm = m0 + m, gk = k0 + k;
      As[m][k] = (gm < g.M && gk < g.K) ? A[gm * g.sam + gk * g.sak] : zero;
    }
#pragma unroll 4
    for (int i = 0; i < GBN * GBK / GT; ++i) {
      const int e = tid + i * GT;
      int n, k;
      if (b_kcontig) { n = e / GBK; k = e % GBK; } else { k = e / GBN; n = e % GBN; }
      const int gn = n0 + n, gk = k0 + k;
      Bs[n][k] = (gn < g.N && gk < g.K) ? B[gk * g.sbk + gn * g.sbn] : zero;
    }
    __syncthreads();
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < GBK; kk += 16) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm + mi * 16 + gq;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * tq]);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * tq]);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * tq + 8]);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * tq + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn + ni * 8 + gq;
          bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[col][kk + 2 * tq]);
          bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[col][kk + 2 * tq + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(&acc[(mi * 4 + ni) * 4], af[mi], bfr[ni]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < GBK; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = to_f(As[tm + 16 * i][kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = to_f(Bs[tn + 8 * j][kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i * 8 + j] += a[i] * b[j];
      }
    }
    __syncthreads();
  }

  if constexpr (kBf16) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* d = &acc[(mi * 4 + ni) * 4];
        const int r = wm + mi * 16 + gq, col = wn + ni * 8 + 2 * tq;
        Cs[r][col] = d[0];
        Cs[r][col + 1] = d[1];
        Cs[r + 8][col] = d[2];
        Cs[r + 8][col + 1] = d[3];
      }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[tm + 16 * i][tn + 8 * j] = acc[i * 8 + j];
  }
  __syncthreads();

  OutT* C = static_cast<OutT*>(g.C) + (long long)c * g.scc;
  const T* bias = g.bias ? static_cast<const T*>(g.bias) + (long long)c * g.sbiasc : nullptr;
  const T* res = g.res ? static_cast<const T*>(g.res) + (long long)c * g.scc : nullptr;
  for (int e = tid; e < GBM * GBN; e += GT) {
    const int m = e / GBN, n = e % GBN;
    const int gm = m0 + m, gn = n0 + n;
    if (gm >= g.M || gn >= g.N) continue;
    float v = Cs[m][n];
    if (bias) v += to_f(bias[gn]);
    if (g.gelu) v = gelu_erf(v);
    const long long off = (long long)gm * g.ldc + gn;
    if (res) v = to_f(res[off]) + g.s[((long long)c * g.M + gm) / g.seq] * v;
    C[off] = from_f<OutT>(v);
  }
}

template <typename T, typename OutT>
int gemm(const GemmArgs& g, int nclients, cudaStream_t st) {
  dim3 grid((g.N + GBN - 1) / GBN, (g.M + GBM - 1) / GBM, nclients);
  gemm_kernel<T, OutT><<<grid, GT, 0, st>>>(g);
  FC_CHECK();
  return 0;
}

inline GemmArgs gemm_args(int M, int N, int K) {
  GemmArgs g = {};
  g.M = M; g.N = N; g.K = K;
  g.seq = 1;
  return g;
}

// x[c] (M x K, row-major) . W[c] (K x N, row-major; the JAX [in, out] layout)
inline void set_a_rows(GemmArgs& g, const void* a, long long ld, long long sc) {
  g.A = a; g.sam = ld; g.sak = 1; g.sac = sc;
}
// A^T: the GEMM row index runs along a's columns and K along its rows
inline void set_a_cols(GemmArgs& g, const void* a, long long ld, long long sc) {
  g.A = a; g.sam = 1; g.sak = ld; g.sac = sc;
}
inline void set_b_rows(GemmArgs& g, const void* b, long long ld, long long sc) {
  g.B = b; g.sbk = ld; g.sbn = 1; g.sbc = sc;
}
// B = W^T for a row-major W (N x K)
inline void set_b_cols(GemmArgs& g, const void* b, long long ld, long long sc) {
  g.B = b; g.sbk = 1; g.sbn = ld; g.sbc = sc;
}
inline void set_c(GemmArgs& g, void* c, long long ld, long long sc) {
  g.C = c; g.ldc = ld; g.scc = sc;
}

// ------------------------------------------------------------- LayerNorm --

constexpr int LN_WARPS = 8;
constexpr int LN_MAXV = 32;  // D <= 1024

// One warp per row, a few rows a warp: h = (x - mean) * rstd * gamma[c] +
// beta[c].  Lane l holds elements l, l + 32, ... of the row, NV of them (D
// <= 32 NV; the launcher picks the smallest NV that holds D, and the sums
// run over the same elements in the same order whatever NV is); gamma and
// beta stay in registers from one row of a client to the next.
template <typename T, int NV>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_fwd_kernel(const T* x, const float* gamma, const float* beta, T* h,
              float* mean, float* rstd, long long rows, int rows_per_client,
              int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * LN_WARPS;
  float gr[NV], br[NV];
  int have = -1;  // the client whose gamma and beta are in registers
  for (long long r = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
       r < rows; r += stride) {
    const int c = (int)(r / rows_per_client);
    if (c != have) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        gr[i] = d < D ? gamma[(long long)c * D + d] : 0.0f;
        br[i] = d < D ? beta[(long long)c * D + d] : 0.0f;
      }
      have = c;
    }
    const T* xr = x + r * D;
    float v[NV];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      v[i] = d < D ? to_f(xr[d]) : 0.0f;
      s += v[i];
    }
    const float mu = warp_sum(s) / D;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < D) q += (v[i] - mu) * (v[i] - mu);
    }
    const float inv = 1.0f / sqrtf(warp_sum(q) / D + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < D) h[r * D + d] = from_f<T>((v[i] - mu) * inv * gr[i] + br[i]);
    }
    if (lane == 0) { mean[r] = mu; rstd[r] = inv; }
  }
}

// dx = rstd * (dg - mean(dg) - xhat * mean(dg * xhat)) [+ res], dg = dh*gamma
template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bwd_kernel(const float* dh, const T* x, const float* mean,
              const float* rstd, const float* gamma, const T* res, T* dx,
              long long rows, int rows_per_client, int D) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int c = (int)(r / rows_per_client);
  const float mu = mean[r], inv = rstd[r];
  const float* gr = gamma + (long long)c * D;
  float dg[LN_MAXV], xh[LN_MAXV], rv[LN_MAXV];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      xh[i] = (to_f(x[r * D + d]) - mu) * inv;
      dg[i] = dh[r * D + d] * gr[d];
      // read with the row's other loads, not after the two reductions
      rv[i] = res ? to_f(res[r * D + d]) : 0.0f;
    } else {
      xh[i] = 0.0f;
      dg[i] = 0.0f;
      rv[i] = 0.0f;
    }
    s1 += dg[i];
    s2 += dg[i] * xh[i];
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      float v = inv * (dg[i] - m1 - xh[i] * m2);
      if (res) v += rv[i];
      dx[r * D + d] = from_f<T>(v);
    }
  }
}

template <typename T>
int ln_fwd(const T* x, const float* gamma, const float* beta, T* h,
           float* mean, float* rstd, long long rows, int rpc, int D,
           float eps, cudaStream_t st) {
  const long long want = (rows + LN_WARPS - 1) / LN_WARPS;
  const unsigned blocks = (unsigned)(want < 2048 ? want : 2048);
#define FC_LN_FWD(NV)                                                      \
  if (D <= 32 * NV) {                                                      \
    ln_fwd_kernel<T, NV><<<blocks, LN_WARPS * 32, 0, st>>>(                \
        x, gamma, beta, h, mean, rstd, rows, rpc, D, eps);                 \
    FC_CHECK();                                                            \
    return 0;                                                              \
  }
  FC_LN_FWD(4) FC_LN_FWD(8) FC_LN_FWD(12) FC_LN_FWD(16) FC_LN_FWD(24)
  FC_LN_FWD(LN_MAXV)
#undef FC_LN_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int ln_bwd(const float* dh, const T* x, const float* mean, const float* rstd,
           const float* gamma, const T* res, T* dx, long long rows, int rpc,
           int D, cudaStream_t st) {
  const unsigned blocks = (unsigned)((rows + LN_WARPS - 1) / LN_WARPS);
  ln_bwd_kernel<T><<<blocks, LN_WARPS * 32, 0, st>>>(dh, x, mean, rstd, gamma,
                                                     res, dx, rows, rpc, D);
  FC_CHECK();
  return 0;
}

// ----------------------------------------------------------- column sums --

constexpr int CS_CHUNKS = 32;   // row chunks per client in the first pass
constexpr int CS_THREADS = 256;

// out[c, col] = sum_m f(src[c, m, col]) with, optionally,
//   f *= s[(c*M + m)/seq]                       (DropPath row scale)
//   cast[c, m, col] = T(f)                      (the scaled value in T)
//   f *= (x[c, m, col] - mean[c, m]) * rstd[c, m]  (LayerNorm xhat)
// gridDim.y row chunks per client.
template <typename SrcT, typename T>
__global__ void __launch_bounds__(CS_THREADS)
colsum_partial_kernel(const SrcT* src, int M, int C, const float* s, int seq,
                      const T* x, const float* mean, const float* rstd,
                      T* cast, float* partial) {
  const int col = blockIdx.x * CS_THREADS + threadIdx.x;
  const int chunk = blockIdx.y, chunks = gridDim.y, c = blockIdx.z;
  if (col >= C) return;
  const int per = (M + chunks - 1) / chunks;
  const int r0 = chunk * per, r1 = min(M, r0 + per);
  float acc = 0.0f;
  for (int m = r0; m < r1; ++m) {
    const int irow = c * M + m;
    const long long row = irow;
    const long long off = row * C + col;
    float v = to_f(src[off]);
    if (s) v *= s[irow / seq];
    if (cast) cast[off] = from_f<T>(v);
    if (x) v *= (to_f(x[off]) - mean[row]) * rstd[row];
    acc += v;
  }
  partial[((long long)c * chunks + chunk) * C + col] = acc;
}

__global__ void colsum_final_kernel(const float* partial, int chunks, int C,
                                    float* out) {
  const int col = blockIdx.x * CS_THREADS + threadIdx.x;
  const int c = blockIdx.y;
  if (col >= C) return;
  float acc = 0.0f;
  for (int k = 0; k < chunks; ++k)
    acc += partial[((long long)c * chunks + k) * C + col];
  out[(long long)c * C + col] = acc;
}

// partial holds n * chunks * C floats.
template <typename SrcT, typename T>
int colsum(const SrcT* src, int n, int M, int C, const float* s, int seq,
           const T* x, const float* mean, const float* rstd, T* cast,
           float* partial, float* out, cudaStream_t st,
           int chunks = CS_CHUNKS) {
  const int cb = (C + CS_THREADS - 1) / CS_THREADS;
  colsum_partial_kernel<SrcT, T><<<dim3(cb, chunks, n), CS_THREADS, 0, st>>>(
      src, M, C, s, seq, x, mean, rstd, cast, partial);
  FC_CHECK();
  colsum_final_kernel<<<dim3(cb, n), CS_THREADS, 0, st>>>(partial, chunks, C,
                                                          out);
  FC_CHECK();
  return 0;
}

// ----------------------------------------------------------- elementwise --

// out = T(f32(in) * s[row / seq]) over rows of width D (s == null: cast only)
template <typename T>
__global__ void row_scale_kernel(const T* in, const float* s, int seq, int D,
                                 long long total, T* out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = to_f(in[i]);
    if (s) v *= s[(i / D) / seq];
    out[i] = from_f<T>(v);
  }
}

template <typename T>
int row_scale(const T* in, const float* s, int seq, int D, long long total,
              T* out, cudaStream_t st) {
  const long long want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < 65535 * 16 ? want : 65535 * 16);
  row_scale_kernel<T><<<blocks, 256, 0, st>>>(in, s, seq, D, total, out);
  FC_CHECK();
  return 0;
}

}  // namespace
