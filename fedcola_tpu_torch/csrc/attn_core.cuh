// Attention core forward, softmax(q.k^T).v per (item, head), shared by the
// fused attention sublayer (attn_fwd.cu, and the recompute backward of
// attn_bwd.cu off its tensor-core path) and flash attention (flash_fwd.cu).
//
// Resident (N <= 256): one block per (head, item), one warp per query row.
// The block holds the head's K and V (hd <= 64) in shared memory as f32;
// scores and softmax are f32 over the whole key range (ragged tail masked
// to -inf), P is rounded to T as the TPU kernels round it before P.V, and
// P.V accumulates in f32 and is stored as T.
//
// Streamed (N > 256, attn_streams_keys): the grid gains a query-block
// dimension, (H, items, ceil(N / AT_QR)).  A block keeps its AT_QR query
// rows in shared memory and walks the keys in chunks of AT_KC rows, one key
// a lane, so shared memory no longer grows with N (34 KB at hd = 64).  Two
// passes, as the resident kernel's two steps: pass 1 the row max and the
// sum (carried under the running max), pass 2 P = T(exp(s - max) / sum),
// written when asked, and P.V accumulated chunk by chunk in f32.  The
// chunks are loaded by the whole block between two barriers, not through a
// ring: a simple kernel first, the f32 route is the card's exactness check.
#pragma once

#include "common.cuh"

namespace {

constexpr int AT_WARPS = 8;
constexpr int AT_MAXR = 8;    // keys per lane of the resident kernels
constexpr int AT_MAXHD = 64;  // hd <= 64
constexpr int AT_RESIDENT_N = 32 * AT_MAXR;  // N the resident kernels hold
constexpr int AT_QR = 64;     // streamed: query rows a block, 8 a warp
constexpr int AT_KC = 32;     // streamed: key rows a chunk, one a lane

// Every per-head attention kernel of the port (this file, attn_fwd_core.cuh,
// attn_bwd_core.cuh, attn_bwd.cu, flash_bwd.cu) keeps a head's keys
// resident in shared memory up to AT_RESIDENT_N and streams them past it:
// the choice of kernel, made by shape alone (ops/kernels.py streams_keys).
__host__ __device__ inline bool attn_streams_keys(int N) {
  return N > AT_RESIDENT_N;
}

// Element offsets of one (item, head): rows of q/k/v start at
// item * in_item + head * hd and are in_row apart; output rows likewise.
struct CoreLayout {
  long long in_item;
  int in_row;
  long long out_item;
  int out_row;
};

// score = (q . k) * scale.  qscale != 0 first rounds q to T(q * qscale)
// (flash attention's pre-scaled q; it then passes scale = 1).  P [items, H,
// N, N] is written when not null.
template <typename T>
__global__ void __launch_bounds__(AT_WARPS * 32)
attn_core_fwd_kernel(const T* qg, const T* kg, const T* vg, T* og, T* P,
                     CoreLayout L, int N, int hd, float scale, float qscale) {
  extern __shared__ float smf[];
  const int ld = hd + 1;
  const int NP = (N + 31) / 32 * 32;
  float* Ks = smf;                            // [N][hd+1]
  float* Vs = Ks + N * ld;                    // [N][hd+1]
  float* qrow = Vs + N * ld;                  // [warps][hd]
  float* prow = qrow + AT_WARPS * AT_MAXHD;   // [warps][NP]

  const int h = blockIdx.x, H = gridDim.x;
  const long long item = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ib = item * L.in_item + (long long)h * hd;
  const long long ob = item * L.out_item + (long long)h * hd;

  for (int e = tid; e < N * hd; e += blockDim.x) {
    const int j = e / hd, d = e % hd;
    Ks[j * ld + d] = to_f(kg[ib + (long long)j * L.in_row + d]);
    Vs[j * ld + d] = to_f(vg[ib + (long long)j * L.in_row + d]);
  }
  __syncthreads();

  float* q = qrow + warp * AT_MAXHD;
  float* p = prow + warp * NP;
  for (int i = warp; i < N; i += AT_WARPS) {
    for (int d = lane; d < hd; d += 32) {
      const float qv = to_f(qg[ib + (long long)i * L.in_row + d]);
      q[d] = qscale != 0.0f ? to_f(from_f<T>(qv * qscale)) : qv;
    }
    __syncwarp();
    float sc[AT_MAXR];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < AT_MAXR; ++r) {
      const int j = lane + 32 * r;
      float v = -INFINITY;
      if (j < N) {
        float a = 0.0f;
        const float* kr = Ks + j * ld;
        for (int d = 0; d < hd; ++d) a += q[d] * kr[d];
        v = a * scale;
      }
      sc[r] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < AT_MAXR; ++r) {
      const int j = lane + 32 * r;
      sc[r] = j < N ? expf(sc[r] - mx) : 0.0f;
      sum += sc[r];
    }
    sum = warp_sum(sum);
    T* prow_out = P ? P + ((item * H + h) * N + i) * (long long)N : nullptr;
#pragma unroll
    for (int r = 0; r < AT_MAXR; ++r) {
      const int j = lane + 32 * r;
      if (j < N) {
        const T pt = from_f<T>(sc[r] / sum);
        if (prow_out) prow_out[j] = pt;
        p[j] = to_f(pt);
      }
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float o = 0.0f;
      for (int j = 0; j < N; ++j) o += p[j] * Vs[j * ld + d];
      og[ob + (long long)i * L.out_row + d] = from_f<T>(o);
    }
    __syncwarp();
  }
}

// The streamed forward: grid (H, items, ceil(N / AT_QR)), AT_WARPS warps,
// each owning AT_QR / AT_WARPS query rows of the block; arguments as
// attn_core_fwd_kernel.
template <typename T>
__global__ void __launch_bounds__(AT_WARPS * 32)
attn_core_fwd_stream_kernel(const T* qg, const T* kg, const T* vg, T* og,
                            T* P, CoreLayout L, int N, int hd, float scale,
                            float qscale) {
  constexpr int RPW = AT_QR / AT_WARPS;  // query rows a warp
  extern __shared__ float smf[];
  const int ld = hd + 1;
  float* Qs = smf;                 // [AT_QR][hd+1]
  float* Ks = Qs + AT_QR * ld;     // [AT_KC][hd+1]
  float* Vs = Ks + AT_KC * ld;     // [AT_KC][hd+1]
  float* pw = Vs + AT_KC * ld;     // [warps][AT_KC]

  const int h = blockIdx.x, H = gridDim.x;
  const long long item = blockIdx.y;
  const int q0 = blockIdx.z * AT_QR, nq = min(AT_QR, N - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ib = item * L.in_item + (long long)h * hd;
  const long long ob = item * L.out_item + (long long)h * hd;

  for (int e = tid; e < nq * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const float qv = to_f(qg[ib + (long long)(q0 + i) * L.in_row + d]);
    Qs[i * ld + d] = qscale != 0.0f ? to_f(from_f<T>(qv * qscale)) : qv;
  }
  float m[RPW], l[RPW], o[RPW][2];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY; l[r] = 0.0f; o[r][0] = 0.0f; o[r][1] = 0.0f;
  }
  float* p = pw + warp * AT_KC;

  // pass 1: row max and sum, the sum carried under the running max
  for (int j0 = 0; j0 < N; j0 += AT_KC) {
    const int kc = min(AT_KC, N - j0);
    __syncthreads();
    for (int e = tid; e < kc * hd; e += blockDim.x) {
      const int j = e / hd, d = e % hd;
      Ks[j * ld + d] = to_f(kg[ib + (long long)(j0 + j) * L.in_row + d]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      if (i >= nq) continue;
      float v = -INFINITY;
      if (lane < kc) {
        float a = 0.0f;
        const float* qr = Qs + i * ld;
        const float* kr = Ks + lane * ld;
        for (int d = 0; d < hd; ++d) a += qr[d] * kr[d];
        v = a * scale;
      }
      const float mn = fmaxf(m[r], warp_max(v));
      const float e = lane < kc ? expf(v - mn) : 0.0f;
      l[r] = l[r] * expf(m[r] - mn) + warp_sum(e);
      m[r] = mn;
    }
  }

  // pass 2: P = T(exp(s - max) / sum), written when asked; O += P . V
  for (int j0 = 0; j0 < N; j0 += AT_KC) {
    const int kc = min(AT_KC, N - j0);
    __syncthreads();
    for (int e = tid; e < kc * hd; e += blockDim.x) {
      const int j = e / hd, d = e % hd;
      const long long at = ib + (long long)(j0 + j) * L.in_row + d;
      Ks[j * ld + d] = to_f(kg[at]);
      Vs[j * ld + d] = to_f(vg[at]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      if (i >= nq) continue;
      if (lane < kc) {
        float a = 0.0f;
        const float* qr = Qs + i * ld;
        const float* kr = Ks + lane * ld;
        for (int d = 0; d < hd; ++d) a += qr[d] * kr[d];
        const T pt = from_f<T>(expf(a * scale - m[r]) / l[r]);
        if (P)
          P[((item * H + h) * N + q0 + i) * (long long)N + j0 + lane] = pt;
        p[lane] = to_f(pt);
      }
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < 2; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) {
          float a = 0.0f;
          for (int j = 0; j < kc; ++j) a += p[j] * Vs[j * ld + d];
          o[r][dd] += a;
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp * RPW + r;
    if (i >= nq) continue;
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int d = lane + 32 * dd;
      if (d < hd)
        og[ob + (long long)(q0 + i) * L.out_row + d] = from_f<T>(o[r][dd]);
    }
  }
}

__host__ __device__ inline size_t attn_core_fwd_stream_smem(int hd) {
  return (size_t)((AT_QR + 2 * AT_KC) * (hd + 1) + AT_WARPS * AT_KC) *
         sizeof(float);
}

// grid (H, items), or (H, items, ceil(N / AT_QR)) streamed; raises the
// dynamic shared-memory limit first.
template <typename T>
int attn_core_fwd(const T* q, const T* k, const T* v, T* o, T* P,
                  const CoreLayout& L, int items, int H, int N, int hd,
                  float scale, float qscale, cudaStream_t st) {
  if (N < 1 || hd > AT_MAXHD) return (int)cudaErrorInvalidValue;
  if (attn_streams_keys(N)) {
    const size_t smem = attn_core_fwd_stream_smem(hd);
    cudaFuncSetAttribute(attn_core_fwd_stream_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    FC_CHECK();
    attn_core_fwd_stream_kernel<T>
        <<<dim3(H, items, (N + AT_QR - 1) / AT_QR), AT_WARPS * 32, smem, st>>>(
            q, k, v, o, P, L, N, hd, scale, qscale);
    FC_CHECK();
    return 0;
  }
  const int NP = (N + 31) / 32 * 32;
  const size_t smem = (size_t)(2 * N * (hd + 1) + AT_WARPS * AT_MAXHD +
                               AT_WARPS * NP) * sizeof(float);
  cudaFuncSetAttribute(attn_core_fwd_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  FC_CHECK();
  attn_core_fwd_kernel<T><<<dim3(H, items), AT_WARPS * 32, smem, st>>>(
      q, k, v, o, P, L, N, hd, scale, qscale);
  FC_CHECK();
  return 0;
}

// The fused sublayer's packed layout: qkv [items, N, 3D] (q | k | v), the
// head concat cat [items, N, D].
template <typename T>
int attn_core_fwd_packed(const T* qkv, T* P, T* cat, int items, int N, int D,
                         int H, cudaStream_t st) {
  const int hd = D / H;
  const CoreLayout L = {(long long)N * 3 * D, 3 * D, (long long)N * D, D};
  return attn_core_fwd<T>(qkv, qkv + D, qkv + 2 * D, cat, P, L, items, H, N,
                          hd, 1.0f / sqrtf((float)hd), 0.0f, st);
}

}  // namespace
