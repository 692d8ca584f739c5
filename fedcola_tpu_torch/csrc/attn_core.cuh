// Attention core forward, softmax(q.k^T).v per (item, head), shared by the
// fused attention sublayer (attn_fwd.cu, and the recompute backward of
// attn_bwd.cu off its tensor-core path) and flash attention (flash_fwd.cu).
//
// One block per (head, item), one warp per query row.  The block holds the
// head's K and V (N <= 256 rows, hd <= 64) in shared memory as f32; scores
// and softmax are f32 over the whole key range (ragged tail masked to
// -inf), P is rounded to T as the TPU kernels round it before P.V, and P.V
// accumulates in f32 and is stored as T.
#pragma once

#include "common.cuh"

namespace {

constexpr int AT_WARPS = 8;
constexpr int AT_MAXR = 8;    // keys per lane: N <= 256
constexpr int AT_MAXHD = 64;  // hd <= 64

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

// grid (H, items); raises the dynamic shared-memory limit first.
template <typename T>
int attn_core_fwd(const T* q, const T* k, const T* v, T* o, T* P,
                  const CoreLayout& L, int items, int H, int N, int hd,
                  float scale, float qscale, cudaStream_t st) {
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
