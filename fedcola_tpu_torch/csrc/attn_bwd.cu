// Fused attention sublayer, backward from the saved softmax probabilities
// P and head concat cat:
//     dx = LN1-backward( dqkv . Wqkv^T ) [+ da],  and per client
//     dWproj = cat^T . da_s, dbproj, dWqkv = LN1(x)^T . dqkv, dbqkv, dLN1,
// where da_s = s_i * da is the branch gradient (s gets no gradient).
//
// Replaces the TPU kernel fedcola_tpu/ops/fused_attention.py:
// _make_bwd_save_kernel (via _bwd_save_call, residual=True on the training
// path; s=NULL gives its residual=False variant).  The second entry point,
// fc_attn_bwd_recompute, replaces _make_bwd_kernel / _bwd_one (via
// _bwd_call, the backward of the remat policies 'save_attn' and 'full'):
// no saves, no residual; it recomputes LN1, qkv, P and the head concat from
// x, and like _bwd_one keeps the recomputed P in f32 for the softmax
// gradient (delta and dS) and rounds it to T only for dV.
//
// What bounds it on the H100: ~2x the forward's FLOPs (four D-wide GEMMs,
// two of them reductions over all B*N rows of a client, plus four N x N
// products per head) against P read once; the FLOPs bound it.  On the TPU
// the per-client dW sums ride the sequential grid in VMEM scratch; here
// blocks run in no order, so every reduction over rows lives inside one
// block's loop: the dW products are GEMMs whose K dimension is the row
// axis, and the bias / LayerNorm-parameter sums go through the two-pass
// column sums of common.cuh.  No atomics: results are deterministic.
// The per-head backward runs on CUDA cores in two passes per (item, head):
// a row pass (dP, the softmax-gradient row sums, dS and dQ) and a column
// pass (dK and dV), with dS in T as the TPU kernel rounds it.
#include "attn_core.cuh"

namespace {

constexpr int AB_WARPS = 8;
constexpr int AB_MAXR = 8;    // keys per lane: N <= 256
constexpr int AB_MAXHD = 64;  // hd <= 64
constexpr int AB_RC = 32;     // rows per chunk in the column pass

// Row pass: one warp per query row i of one (item, head).
//   dP[i,j] = dO[i] . V[j];  delta_i = sum_j dP[i,j] P[i,j]
//   dS[i,j] = T(P[i,j] (dP[i,j] - delta_i));  dQ[i] = scale * dS[i] . K
// RECOMP: P[i,:] is recomputed in f32 from Q[i] and K (softmax of the
// scaled f32 scores, as attn_core_fwd computes it before rounding) instead
// of read from the saved T copy.
template <typename T, bool RECOMP>
__global__ void __launch_bounds__(AB_WARPS * 32)
attn_bwd_rows_kernel(const T* qkv, const T* P, const T* dO, T* dS,
                     float* dqkv, int N, int D, int H, float scale) {
  extern __shared__ float smf[];
  const int hd = D / H, ld = hd + 1;
  const int NP = (N + 31) / 32 * 32;
  float* Ks = smf;
  float* Vs = Ks + N * ld;
  float* orow = Vs + N * ld;                 // [warps][hd]
  float* srow = orow + AB_WARPS * AB_MAXHD;  // [warps][NP]
  float* qrow = srow + AB_WARPS * NP;        // [warps][hd] (RECOMP)

  const int h = blockIdx.x;
  const long long item = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* base = qkv + item * N * 3LL * D;
  for (int e = tid; e < N * hd; e += blockDim.x) {
    const int j = e / hd, d = e % hd;
    Ks[j * ld + d] = to_f(base[(long long)j * 3 * D + D + h * hd + d]);
    Vs[j * ld + d] = to_f(base[(long long)j * 3 * D + 2 * D + h * hd + d]);
  }
  __syncthreads();

  float* o = orow + warp * AB_MAXHD;
  float* ds = srow + warp * NP;
  float* q = qrow + warp * AB_MAXHD;
  for (int i = warp; i < N; i += AB_WARPS) {
    for (int d = lane; d < hd; d += 32) {
      o[d] = to_f(dO[(item * N + i) * D + h * hd + d]);
      if (RECOMP) q[d] = to_f(base[(long long)i * 3 * D + h * hd + d]);
    }
    __syncwarp();
    const long long prow = ((item * H + h) * N + i) * (long long)N;
    float dp[AB_MAXR], pv[AB_MAXR];
    if (RECOMP) {
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < AB_MAXR; ++r) {
        const int j = lane + 32 * r;
        float v = -INFINITY;
        if (j < N) {
          float a = 0.0f;
          const float* kr = Ks + j * ld;
          for (int d = 0; d < hd; ++d) a += q[d] * kr[d];
          v = a * scale;
        }
        pv[r] = v;
        mx = fmaxf(mx, v);
      }
      mx = warp_max(mx);
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < AB_MAXR; ++r) {
        const int j = lane + 32 * r;
        pv[r] = j < N ? expf(pv[r] - mx) : 0.0f;
        sum += pv[r];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int r = 0; r < AB_MAXR; ++r) pv[r] /= sum;
    }
    float delta = 0.0f;
#pragma unroll
    for (int r = 0; r < AB_MAXR; ++r) {
      const int j = lane + 32 * r;
      dp[r] = 0.0f;
      if (!RECOMP) pv[r] = 0.0f;
      if (j < N) {
        const float* vr = Vs + j * ld;
        float a = 0.0f;
        for (int d = 0; d < hd; ++d) a += o[d] * vr[d];
        dp[r] = a;
        if (!RECOMP) pv[r] = to_f(P[prow + j]);
        delta += a * pv[r];
      }
    }
    delta = warp_sum(delta);
#pragma unroll
    for (int r = 0; r < AB_MAXR; ++r) {
      const int j = lane + 32 * r;
      if (j < N) {
        const T st = from_f<T>(pv[r] * (dp[r] - delta));
        dS[prow + j] = st;
        ds[j] = to_f(st);
      }
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float a = 0.0f;
      for (int j = 0; j < N; ++j) a += ds[j] * Ks[j * ld + d];
      dqkv[(item * N + i) * 3LL * D + h * hd + d] = a * scale;
    }
    __syncwarp();
  }
}

// Column pass: dV[j] = sum_i P[i,j] dO[i];  dK[j] = scale * sum_i dS[i,j] Q[i].
// The [N, hd] accumulators live in shared memory, each owned by one thread;
// rows stream through in chunks of AB_RC.
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_cols_kernel(const T* qkv, const T* P, const T* dO, const T* dS,
                     float* dqkv, int N, int D, int H, float scale) {
  extern __shared__ float smf[];
  const int hd = D / H;
  const int NP = (N + 31) / 32 * 32;
  float* dV = smf;                 // [N][hd]
  float* dK = dV + N * hd;         // [N][hd]
  float* Pc = dK + N * hd;         // [RC][NP]
  float* Sc = Pc + AB_RC * NP;     // [RC][NP]
  float* Oc = Sc + AB_RC * NP;     // [RC][hd]
  float* Qc = Oc + AB_RC * hd;     // [RC][hd]

  const int h = blockIdx.x;
  const long long item = blockIdx.y;
  const int tid = threadIdx.x;
  const T* base = qkv + item * N * 3LL * D;
  const long long pbase = (item * H + h) * (long long)N * N;
  for (int e = tid; e < N * hd; e += blockDim.x) { dV[e] = 0.0f; dK[e] = 0.0f; }

  for (int i0 = 0; i0 < N; i0 += AB_RC) {
    const int rc = min(AB_RC, N - i0);
    __syncthreads();
    for (int e = tid; e < rc * N; e += blockDim.x) {
      const int ii = e / N, j = e % N;
      Pc[ii * NP + j] = to_f(P[pbase + (long long)(i0 + ii) * N + j]);
      Sc[ii * NP + j] = to_f(dS[pbase + (long long)(i0 + ii) * N + j]);
    }
    for (int e = tid; e < rc * hd; e += blockDim.x) {
      const int ii = e / hd, d = e % hd;
      const long long row = item * N + i0 + ii;
      Oc[ii * hd + d] = to_f(dO[row * D + h * hd + d]);
      Qc[ii * hd + d] = to_f(qkv[row * 3LL * D + h * hd + d]);
    }
    __syncthreads();
    for (int e = tid; e < N * hd; e += blockDim.x) {
      const int j = e / hd, d = e % hd;
      float v = dV[e], k = dK[e];
      for (int ii = 0; ii < rc; ++ii) {
        v += Pc[ii * NP + j] * Oc[ii * hd + d];
        k += Sc[ii * NP + j] * Qc[ii * hd + d];
      }
      dV[e] = v;
      dK[e] = k;
    }
  }
  __syncthreads();
  for (int e = tid; e < N * hd; e += blockDim.x) {
    const int j = e / hd, d = e % hd;
    float* row = dqkv + (item * N + j) * 3LL * D;
    row[D + h * hd + d] = dK[e] * scale;
    row[2 * D + h * hd + d] = dV[e];
  }
}

template <typename T>
int attn_bwd_impl(int n, int B, int N, int D, int H, const void* x_,
                  const float* s, const float* lns, const float* lnb,
                  const void* wqkv, const void* bqkv, const void* wproj,
                  void* P_, void* cat_, const void* da_, void* dx,
                  float* dlns, float* dlnb, float* dwqkv, float* dbqkv,
                  float* dwproj, float* dbproj, void* h_, float* mean,
                  float* rstd, void* qkv_, void* dac_, void* dO_, void* dS_,
                  float* dqkv, void* dqkvc_, float* dh, float* partial,
                  bool recompute, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const T* da = static_cast<const T*>(da_);
  T* P = static_cast<T*>(P_);
  T* cat = static_cast<T*>(cat_);
  T* h = static_cast<T*>(h_);
  T* qkv = static_cast<T*>(qkv_);
  T* dac = static_cast<T*>(dac_);
  T* dO = static_cast<T*>(dO_);
  T* dS = static_cast<T*>(dS_);
  T* dqkvc = static_cast<T*>(dqkvc_);
  const int M = B * N;
  const long long rows = (long long)n * M;
  const long long MD = (long long)M * D;
  const int hd = D / H;
  const float scale = 1.0f / sqrtf((float)hd);
  int err;

  // recompute LN1 and qkv (the only forward pieces the saves do not cover)
  // and, without saves, P (rounded to T, for dV) and the head concat
  if ((err = ln_fwd<T>(x, lns, lnb, h, mean, rstd, rows, M, D, 1e-5f, st))) return err;
  GemmArgs g = gemm_args(M, 3 * D, D);
  set_a_rows(g, h, D, MD);
  set_b_rows(g, wqkv, 3 * D, 3LL * D * D);
  set_c(g, qkv, 3 * D, 3 * MD);
  g.bias = bqkv; g.sbiasc = 3 * D;
  if ((err = gemm<T, T>(g, n, st))) return err;
  if (recompute &&
      (err = attn_core_fwd_packed<T>(qkv, P, cat, n * B, N, D, H, st))) return err;

  // branch gradient s*da (rounded to T for the products; dbproj sums it in f32)
  if ((err = row_scale<T>(da, s, N, D, rows * D, dac, st))) return err;
  if ((err = colsum<T, T>(da, n, M, D, s, N, nullptr, nullptr, nullptr,
                          nullptr, partial, dbproj, st))) return err;

  // dWproj = cat^T . dac ;  dO = T(dac . Wproj^T)
  GemmArgs w = gemm_args(D, D, M);
  set_a_cols(w, cat, D, MD);
  set_b_rows(w, dac, D, MD);
  set_c(w, dwproj, D, (long long)D * D);
  if ((err = gemm<T, float>(w, n, st))) return err;
  GemmArgs o = gemm_args(M, D, D);
  set_a_rows(o, dac, D, MD);
  set_b_cols(o, wproj, D, (long long)D * D);
  set_c(o, dO, D, MD);
  if ((err = gemm<T, T>(o, n, st))) return err;

  // per-head attention backward
  const int NP = (N + 31) / 32 * 32;
  const size_t smem_r = (size_t)(2 * N * (hd + 1) + 2 * AB_WARPS * AB_MAXHD +
                                 AB_WARPS * NP) * sizeof(float);
  auto rows_kernel = recompute ? attn_bwd_rows_kernel<T, true>
                               : attn_bwd_rows_kernel<T, false>;
  cudaFuncSetAttribute(rows_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_r);
  FC_CHECK();
  rows_kernel<<<dim3(H, n * B), AB_WARPS * 32, smem_r, st>>>(
      qkv, P, dO, dS, dqkv, N, D, H, scale);
  FC_CHECK();
  const size_t smem_c = (size_t)(2 * N * hd + 2 * AB_RC * NP + 2 * AB_RC * hd) *
                        sizeof(float);
  cudaFuncSetAttribute(attn_bwd_cols_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  FC_CHECK();
  attn_bwd_cols_kernel<T><<<dim3(H, n * B), 256, smem_c, st>>>(
      qkv, P, dO, dS, dqkv, N, D, H, scale);
  FC_CHECK();

  // dbqkv = colsum(dqkv) in f32, with the T copy for the products
  if ((err = colsum<float, T>(dqkv, n, M, 3 * D, nullptr, 1, nullptr, nullptr,
                              nullptr, dqkvc, partial, dbqkv, st))) return err;
  // dWqkv = LN1(x)^T . dqkv ;  dh = dqkv . Wqkv^T
  GemmArgs wq = gemm_args(D, 3 * D, M);
  set_a_cols(wq, h, D, MD);
  set_b_rows(wq, dqkvc, 3 * D, 3 * MD);
  set_c(wq, dwqkv, 3 * D, 3LL * D * D);
  if ((err = gemm<T, float>(wq, n, st))) return err;
  GemmArgs dhg = gemm_args(M, D, 3 * D);
  set_a_rows(dhg, dqkvc, 3 * D, 3 * MD);
  set_b_cols(dhg, wqkv, 3 * D, 3LL * D * D);
  set_c(dhg, dh, D, MD);
  if ((err = gemm<T, float>(dhg, n, st))) return err;

  // LayerNorm backward: dx (+ the identity branch da), dLN1 scale and bias
  if ((err = ln_bwd<T>(dh, x, mean, rstd, lns, s ? da : nullptr,
                       static_cast<T*>(dx), rows, M, D, st))) return err;
  if ((err = colsum<float, T>(dh, n, M, D, nullptr, 1, x, mean, rstd, nullptr,
                              partial, dlns, st))) return err;
  return colsum<float, T>(dh, n, M, D, nullptr, 1, nullptr, nullptr, nullptr,
                          nullptr, partial, dlnb, st);
}

}  // namespace

// Inputs as fc_attn_fwd, plus P [n,B,H,N,N], cat [n,B,N,D], da [n,B,N,D] (T).
// Outputs: dx [n,B,N,D] (T); dlns, dlnb [n,D]; dwqkv [n,D,3D]; dbqkv [n,3D];
// dwproj [n,D,D]; dbproj [n,D] (all f32).
// Scratch: h, dac, dO [n,B,N,D] (T); mean, rstd [n*B*N] f32;
// qkv, dqkvc [n,B,N,3D] (T); dS [n,B,H,N,N] (T); dqkv [n,B,N,3D] f32;
// dh [n,B,N,D] f32; partial [n,32,3D] f32.
extern "C" int fc_attn_bwd(int dtype, int n, int B, int N, int D, int H,
                           const void* x, const float* s, const float* lns,
                           const float* lnb, const void* wqkv,
                           const void* bqkv, const void* wproj, const void* P,
                           const void* cat, const void* da, void* dx,
                           float* dlns, float* dlnb, float* dwqkv,
                           float* dbqkv, float* dwproj, float* dbproj,
                           void* h, float* mean, float* rstd, void* qkv,
                           void* dac, void* dO, void* dS, float* dqkv,
                           void* dqkvc, float* dh, float* partial,
                           cudaStream_t st) {
  // the saves are only read on this path
  void* Pm = const_cast<void*>(P);
  void* catm = const_cast<void*>(cat);
  if (dtype == 1)
    return attn_bwd_impl<bf16>(n, B, N, D, H, x, s, lns, lnb, wqkv, bqkv,
                               wproj, Pm, catm, da, dx, dlns, dlnb, dwqkv,
                               dbqkv, dwproj, dbproj, h, mean, rstd, qkv, dac,
                               dO, dS, dqkv, dqkvc, dh, partial, false, st);
  return attn_bwd_impl<float>(n, B, N, D, H, x, s, lns, lnb, wqkv, bqkv,
                              wproj, Pm, catm, da, dx, dlns, dlnb, dwqkv,
                              dbqkv, dwproj, dbproj, h, mean, rstd, qkv, dac,
                              dO, dS, dqkv, dqkvc, dh, partial, false, st);
}

// The recompute backward (no residual, no saves): inputs x, lns, lnb, wqkv,
// bqkv, wproj, da as fc_attn_bwd; outputs as fc_attn_bwd; P [n,B,H,N,N] and
// cat [n,B,N,D] (T) become scratch, with the rest of fc_attn_bwd's.
extern "C" int fc_attn_bwd_recompute(
    int dtype, int n, int B, int N, int D, int H, const void* x,
    const float* lns, const float* lnb, const void* wqkv, const void* bqkv,
    const void* wproj, const void* da, void* dx, float* dlns, float* dlnb,
    float* dwqkv, float* dbqkv, float* dwproj, float* dbproj, void* h,
    float* mean, float* rstd, void* qkv, void* P, void* cat, void* dac,
    void* dO, void* dS, float* dqkv, void* dqkvc, float* dh, float* partial,
    cudaStream_t st) {
  if (dtype == 1)
    return attn_bwd_impl<bf16>(n, B, N, D, H, x, nullptr, lns, lnb, wqkv,
                               bqkv, wproj, P, cat, da, dx, dlns, dlnb, dwqkv,
                               dbqkv, dwproj, dbproj, h, mean, rstd, qkv, dac,
                               dO, dS, dqkv, dqkvc, dh, partial, true, st);
  return attn_bwd_impl<float>(n, B, N, D, H, x, nullptr, lns, lnb, wqkv,
                              bqkv, wproj, P, cat, da, dx, dlns, dlnb, dwqkv,
                              dbqkv, dwproj, dbproj, h, mean, rstd, qkv, dac,
                              dO, dS, dqkv, dqkvc, dh, partial, true, st);
}
