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
// gradient (delta and dS) and rounds it to T only for dV and cat.
//
// What bounds it on the H100: ~2x the forward's FLOPs (five D-wide GEMMs,
// two of them reductions over all B*N rows of a client, plus four N x N
// products per head) against P read once; the FLOPs bound it.  On the TPU
// the per-client dW sums ride the sequential grid in VMEM scratch; here
// blocks run in no order, so every reduction over rows has one owner and a
// fixed order.  No atomics: results are the same on every run.
//
// bf16 with hd in {16, 32, 64} (so D % 16 == 0), at every N, runs
// attn_bwd_sm90:
//   1. ln_fwd (LN1), then qkv = T(h.Wqkv + bqkv) on gemm_sm90.cuh's TMA +
//      wgmma mainloop, the bias added in the epilogue before rounding;
//   2. dbproj's column sums of the f32 s*da, the same pass writing dac =
//      T(s*da); dO = T(dac.Wproj^T) on the mainloop;
//   3. the per-head backward on tensor cores (attn_bwd_core.cuh): one fused
//      launch up to N = 256, past it a row and a column kernel that stream
//      the keys (the row statistics through the f32 scratch stats);
//      dq | dk | dv written straight as the bf16 dqkvc, dbqkv's f32 column
//      sums per (item, head[, query block]) into hpart, and (recompute)
//      cat; P and dS never reach device memory;
//   4. dWproj = cat^T.dac and dWqkv = h^T.dqkvc: each client's rows cut into
//      split ranges (planned by the caller from the rows and the output
//      shape alone, multiples of the 64-row K tile) whose f32 partials
//      sum_parts adds in order; dbqkv = the items of hpart in order;
//   5. dh = dqkvc.Wqkv^T (f32), ln_bwd and the dLN1 column sums.
// f32, and bf16 off that grid, run attn_bwd_impl: the same function on
// common.cuh's gemm_kernel with the per-head backward on CUDA cores in two
// passes per (item, head), a row pass (dP, delta, dS and dQ) and a column
// pass (dK and dV), dS and the f32 dqkv going through device memory; past
// N = 256 the row pass streams the keys and the column pass owns a block
// of AB_KR keys (the *_stream_kernel pair below).  The choice is made
// here, by dtype and shape alone.
#include "attn_bwd_core.cuh"
#include "attn_core.cuh"
#include "attn_sm90.cuh"

namespace {

constexpr int AB_WARPS = 8;
constexpr int AB_MAXR = 8;    // keys per lane of the resident row pass
constexpr int AB_MAXHD = 64;  // hd <= 64
constexpr int AB_RC = 32;     // rows per chunk in the column pass
constexpr int AB_KR = 32;     // streamed column pass: keys a block

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

// The streamed row pass (N > AT_RESIDENT_N): grid (H, items, ceil(N /
// AT_QR)), one warp per AT_QR / AB_WARPS query rows of the block, the keys
// and values in chunks of AT_KC rows (one a lane).  Pass 1: delta (and,
// RECOMP, the row max and sum, delta's numerator carried under the running
// max); pass 2: dS = T(P (dP - delta)) written, dQ accumulated.  Shared
// memory: the block's q and dO rows, one K and V chunk, one dS row a warp.
template <typename T, bool RECOMP>
__global__ void __launch_bounds__(AB_WARPS * 32)
attn_bwd_rows_stream_kernel(const T* qkv, const T* P, const T* dO, T* dS,
                            float* dqkv, int N, int D, int H, float scale) {
  constexpr int RPW = AT_QR / AB_WARPS;
  extern __shared__ float smf[];
  const int hd = D / H, ld = hd + 1;
  float* Qs = smf;                 // [AT_QR][hd+1]
  float* Gs = Qs + AT_QR * ld;     // [AT_QR][hd+1] (dO)
  float* Ks = Gs + AT_QR * ld;     // [AT_KC][hd+1]
  float* Vs = Ks + AT_KC * ld;     // [AT_KC][hd+1]
  float* sw = Vs + AT_KC * ld;     // [warps][AT_KC]

  const int h = blockIdx.x;
  const long long item = blockIdx.y;
  const int q0 = blockIdx.z * AT_QR, nq = min(AT_QR, N - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* base = qkv + item * N * 3LL * D;
  for (int e = tid; e < nq * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const long long row = (long long)(q0 + i);
    Qs[i * ld + d] = to_f(base[row * 3 * D + h * hd + d]);
    Gs[i * ld + d] = to_f(dO[(item * N + row) * D + h * hd + d]);
  }
  float m[RPW], l[RPW], dl[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) { m[r] = -INFINITY; l[r] = 0.0f; dl[r] = 0.0f; }
  float* ds = sw + warp * AT_KC;

  // pass 1
  for (int j0 = 0; j0 < N; j0 += AT_KC) {
    const int kc = min(AT_KC, N - j0);
    __syncthreads();
    for (int e = tid; e < kc * hd; e += blockDim.x) {
      const int j = e / hd, d = e % hd;
      const long long row = (long long)(j0 + j) * 3 * D + h * hd + d;
      Ks[j * ld + d] = to_f(base[row + D]);
      Vs[j * ld + d] = to_f(base[row + 2 * D]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      if (i >= nq) continue;
      float dp = 0.0f, s = -INFINITY;
      if (lane < kc) {
        const float* gr = Gs + i * ld;
        const float* vr = Vs + lane * ld;
        for (int d = 0; d < hd; ++d) dp += gr[d] * vr[d];
        if (RECOMP) {
          const float* qr = Qs + i * ld;
          const float* kr = Ks + lane * ld;
          float a = 0.0f;
          for (int d = 0; d < hd; ++d) a += qr[d] * kr[d];
          s = a * scale;
        }
      }
      if (RECOMP) {
        const float mn = fmaxf(m[r], warp_max(s));
        const float corr = expf(m[r] - mn);
        const float e = lane < kc ? expf(s - mn) : 0.0f;
        l[r] = l[r] * corr + warp_sum(e);
        dl[r] = dl[r] * corr + warp_sum(e * dp);
        m[r] = mn;
      } else {
        const float pv = lane < kc ? to_f(P[((item * H + h) * N + q0 + i) *
                                                (long long)N + j0 + lane])
                                   : 0.0f;
        dl[r] += warp_sum(pv * dp);
      }
    }
  }
  float delta[RPW], dq[RPW][2];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    delta[r] = RECOMP ? dl[r] / l[r] : dl[r];
    dq[r][0] = 0.0f;
    dq[r][1] = 0.0f;
  }

  // pass 2
  for (int j0 = 0; j0 < N; j0 += AT_KC) {
    const int kc = min(AT_KC, N - j0);
    __syncthreads();
    for (int e = tid; e < kc * hd; e += blockDim.x) {
      const int j = e / hd, d = e % hd;
      const long long row = (long long)(j0 + j) * 3 * D + h * hd + d;
      Ks[j * ld + d] = to_f(base[row + D]);
      Vs[j * ld + d] = to_f(base[row + 2 * D]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      if (i >= nq) continue;
      if (lane < kc) {
        const long long at =
            ((item * H + h) * N + q0 + i) * (long long)N + j0 + lane;
        const float* gr = Gs + i * ld;
        const float* vr = Vs + lane * ld;
        float dp = 0.0f;
        for (int d = 0; d < hd; ++d) dp += gr[d] * vr[d];
        float pv;
        if (RECOMP) {
          const float* qr = Qs + i * ld;
          const float* kr = Ks + lane * ld;
          float a = 0.0f;
          for (int d = 0; d < hd; ++d) a += qr[d] * kr[d];
          pv = expf(a * scale - m[r]) / l[r];
        } else {
          pv = to_f(P[at]);
        }
        const T st = from_f<T>(pv * (dp - delta[r]));
        dS[at] = st;
        ds[lane] = to_f(st);
      }
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < 2; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) {
          float a = 0.0f;
          for (int j = 0; j < kc; ++j) a += ds[j] * Ks[j * ld + d];
          dq[r][dd] += a;
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
        dqkv[(item * N + q0 + i) * 3LL * D + h * hd + d] = dq[r][dd] * scale;
    }
  }
}

// The streamed column pass: grid (H, items, ceil(N / AB_KR)), each block
// owning AB_KR keys (their dV and dK accumulators in shared memory, one
// thread an element) and reading the saved P and dS of those keys, AB_RC
// query rows at a time, as attn_bwd_cols_kernel reads the whole rows.
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_cols_stream_kernel(const T* qkv, const T* P, const T* dO,
                            const T* dS, float* dqkv, int N, int D, int H,
                            float scale) {
  extern __shared__ float smf[];
  const int hd = D / H;
  float* dV = smf;                   // [AB_KR][hd]
  float* dK = dV + AB_KR * hd;       // [AB_KR][hd]
  float* Pc = dK + AB_KR * hd;       // [AB_RC][AB_KR]
  float* Sc = Pc + AB_RC * AB_KR;    // [AB_RC][AB_KR]
  float* Oc = Sc + AB_RC * AB_KR;    // [AB_RC][hd]
  float* Qc = Oc + AB_RC * hd;       // [AB_RC][hd]

  const int h = blockIdx.x;
  const long long item = blockIdx.y;
  const int k0 = blockIdx.z * AB_KR, nk = min(AB_KR, N - k0);
  const int tid = threadIdx.x;
  const long long pbase = (item * H + h) * (long long)N * N;
  for (int e = tid; e < nk * hd; e += blockDim.x) {
    dV[e] = 0.0f;
    dK[e] = 0.0f;
  }

  for (int i0 = 0; i0 < N; i0 += AB_RC) {
    const int rc = min(AB_RC, N - i0);
    __syncthreads();
    for (int e = tid; e < rc * nk; e += blockDim.x) {
      const int ii = e / nk, jj = e % nk;
      const long long at = pbase + (long long)(i0 + ii) * N + k0 + jj;
      Pc[ii * AB_KR + jj] = to_f(P[at]);
      Sc[ii * AB_KR + jj] = to_f(dS[at]);
    }
    for (int e = tid; e < rc * hd; e += blockDim.x) {
      const int ii = e / hd, d = e % hd;
      const long long row = item * N + i0 + ii;
      Oc[ii * hd + d] = to_f(dO[row * D + h * hd + d]);
      Qc[ii * hd + d] = to_f(qkv[row * 3LL * D + h * hd + d]);
    }
    __syncthreads();
    for (int e = tid; e < nk * hd; e += blockDim.x) {
      const int j = e / hd, d = e % hd;
      float v = dV[e], k = dK[e];
      for (int ii = 0; ii < rc; ++ii) {
        v += Pc[ii * AB_KR + j] * Oc[ii * hd + d];
        k += Sc[ii * AB_KR + j] * Qc[ii * hd + d];
      }
      dV[e] = v;
      dK[e] = k;
    }
  }
  __syncthreads();
  for (int e = tid; e < nk * hd; e += blockDim.x) {
    const int j = e / hd, d = e % hd;
    float* row = dqkv + (item * N + k0 + j) * 3LL * D;
    row[D + h * hd + d] = dK[e] * scale;
    row[2 * D + h * hd + d] = dV[e];
  }
}

__host__ __device__ inline size_t attn_bwd_rows_stream_smem(int hd) {
  return (size_t)((2 * AT_QR + 2 * AT_KC) * (hd + 1) + AB_WARPS * AT_KC) *
         sizeof(float);
}
__host__ __device__ inline size_t attn_bwd_cols_stream_smem(int hd) {
  return (size_t)(2 * AB_KR * hd + 2 * AB_RC * AB_KR + 2 * AB_RC * hd) *
         sizeof(float);
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
  if (attn_streams_keys(N)) {
    const size_t smem_r = attn_bwd_rows_stream_smem(hd);
    auto rows_kernel = recompute ? attn_bwd_rows_stream_kernel<T, true>
                                 : attn_bwd_rows_stream_kernel<T, false>;
    cudaFuncSetAttribute(rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_r);
    FC_CHECK();
    rows_kernel<<<dim3(H, n * B, (N + AT_QR - 1) / AT_QR), AB_WARPS * 32,
                  smem_r, st>>>(qkv, P, dO, dS, dqkv, N, D, H, scale);
    FC_CHECK();
    const size_t smem_c = attn_bwd_cols_stream_smem(hd);
    cudaFuncSetAttribute(attn_bwd_cols_stream_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_c);
    FC_CHECK();
    attn_bwd_cols_stream_kernel<T>
        <<<dim3(H, n * B, (N + AB_KR - 1) / AB_KR), 256, smem_c, st>>>(
            qkv, P, dO, dS, dqkv, N, D, H, scale);
    FC_CHECK();
  } else {
    const int NP = (N + 31) / 32 * 32;
    const size_t smem_r = (size_t)(2 * N * (hd + 1) + 2 * AB_WARPS * AB_MAXHD +
                                   AB_WARPS * NP) * sizeof(float);
    auto rows_kernel = recompute ? attn_bwd_rows_kernel<T, true>
                                 : attn_bwd_rows_kernel<T, false>;
    cudaFuncSetAttribute(rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_r);
    FC_CHECK();
    rows_kernel<<<dim3(H, n * B), AB_WARPS * 32, smem_r, st>>>(
        qkv, P, dO, dS, dqkv, N, D, H, scale);
    FC_CHECK();
    const size_t smem_c =
        (size_t)(2 * N * hd + 2 * AB_RC * NP + 2 * AB_RC * hd) * sizeof(float);
    cudaFuncSetAttribute(attn_bwd_cols_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_c);
    FC_CHECK();
    attn_bwd_cols_kernel<T><<<dim3(H, n * B), 256, smem_c, st>>>(
        qkv, P, dO, dS, dqkv, N, D, H, scale);
    FC_CHECK();
  }

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

// The bf16 backward on the Hopper mainloop and the tensor-core head kernel
// (steps 1-5 of the note above).  rps_proj / rps_qkv: rows per split range
// of dWproj / dWqkv (multiples of 64); their partials go to wpart
// [S, n, D, D] / [S, n, D, 3D] (unused by a product with S == 1, which
// writes its gradient directly).  hpart [n*B*attn_part_rows(N), 3D] f32;
// stats [n*B, H, N, 3] f32 past N = 256 (the streamed head kernels' row
// statistics), else unused.  P is read unless recompute; cat is read, or
// written when recompute.
int attn_bwd_sm90(int n, int B, int N, int D, int H, int rps_proj,
                  int rps_qkv, const bf16* x, const float* s,
                  const float* lns, const float* lnb, const bf16* wqkv,
                  const bf16* bqkv, const bf16* wproj, const bf16* P,
                  bf16* cat, const bf16* da, bf16* dx, float* dlns,
                  float* dlnb, float* dwqkv, float* dbqkv, float* dwproj,
                  float* dbproj, bf16* h, float* mean, float* rstd, bf16* qkv,
                  bf16* dac, bf16* dO, bf16* dqkvc, float* dh, float* partial,
                  float* stats, float* hpart, float* wpart, bool recompute,
                  cudaStream_t st) {
  const int M = B * N;
  const long long rows = (long long)n * M;
  const long long MD = (long long)M * D;
  const int hd = D / H;
  const float scale = 1.0f / sqrtf((float)hd);
  const int mt = ceil_div(M, SM90_BM);
  const int kd = ceil_div(D, SM90_BK);
  int err;
  if (rps_proj <= 0 || rps_proj % SM90_BK || rps_qkv <= 0 ||
      rps_qkv % SM90_BK || !hpart)
    return (int)cudaErrorInvalidValue;

  // LN1, and qkv = T(h . Wqkv + bqkv), as the forward computes them
  if ((err = attn_ln_qkv_sm90(x, lns, lnb, wqkv, bqkv, h, mean, rstd, qkv, n,
                              M, D, st))) return err;

  // branch gradient s*da: dbproj sums it in f32 and the same pass rounds
  // it into dac for the products.  partial [n, 32, 3D] gives the D-wide
  // column sums three times the row chunks.
  const int wide = 3 * CS_CHUNKS;
  if ((err = colsum<bf16, bf16>(da, n, M, D, s, N, nullptr, nullptr, nullptr,
                                dac, partial, dbproj, st, wide))) return err;

  // dO = T(dac . Wproj^T): Wproj [D, D] is the K-major B
  Sm90Args o = {};
  if ((err = make_map(&o.a0, dac, n, M, D)) ||
      (err = make_map(&o.b0, wproj, n, D, D)))
    return err;
  o.M = M; o.N = D;
  o.k_tiles = o.tiles_per_split = kd;
  o.splits = 1;
  o.out = dO; o.out_client = MD;
  if ((err = sm90_gemm<0, 0, 0, SM90_EPI_BF16>(
           o, mt, ceil_div(D, SM90_BN), n, st))) return err;

  // per-head backward: dqkvc, hpart, (cat)
  const HeadLayout L = {(long long)N * 3 * D, 3 * D, (long long)N * D, D,
                        (long long)N * 3 * D, 3 * D};
  auto head = recompute ? attn_bwd_head<AH_RECOMP> : attn_bwd_head<AH_SAVED>;
  if ((err = head(qkv, qkv + D, qkv + 2 * D, dO, P, dqkvc, dqkvc + D,
                  dqkvc + 2 * D, cat, hpart, stats, L, n * B, H, N, hd, scale,
                  0.0f, D, st)))
    return err;
  if ((err = colsum<float, bf16>(hpart, n, B * attn_part_rows(N), 3 * D,
                                 nullptr, 1, nullptr, nullptr, nullptr,
                                 nullptr, partial, dbqkv, st))) return err;

  // dWproj = cat^T . dac [D, D] and dWqkv = h^T . dqkvc [D, 3D], K = the rows
  const bf16* lhs[2] = {cat, h};
  const bf16* rhs[2] = {dac, dqkvc};
  float* dw[2] = {dwproj, dwqkv};
  const int inner[2] = {D, 3 * D}, rps[2] = {rps_proj, rps_qkv};
  for (int p = 0; p < 2; ++p) {
    Sm90Args w = {};
    if ((err = make_map(&w.a0, lhs[p], n, M, D)) ||
        (err = make_map(&w.b0, rhs[p], n, M, inner[p])))
      return err;
    const long long DW = (long long)D * inner[p];
    w.M = D; w.N = inner[p];
    w.k_tiles = ceil_div(M, SM90_BK);
    w.tiles_per_split = rps[p] / SM90_BK;
    w.splits = ceil_div(M, rps[p]);
    if (w.splits > 1 && !wpart) return (int)cudaErrorInvalidValue;
    w.out_client = DW;
    w.out_split = n * DW;
    w.out = w.splits > 1 ? wpart : dw[p];
    if ((err = sm90_gemm<1, 1, 0, SM90_EPI_F32>(
             w, ceil_div(D, SM90_BM), ceil_div(inner[p], SM90_BN),
             n * w.splits, st))) return err;
    if (w.splits > 1 &&
        (err = sum_parts(wpart, w.splits, n * DW, dw[p], st))) return err;
  }

  // dh = dqkvc . Wqkv^T (f32): Wqkv [D, 3D] is the K-major B
  Sm90Args q = {};
  if ((err = make_map(&q.a0, dqkvc, n, M, 3 * D)) ||
      (err = make_map(&q.b0, wqkv, n, D, 3 * D)))
    return err;
  q.M = M; q.N = D;
  q.k_tiles = q.tiles_per_split = ceil_div(3 * D, SM90_BK);
  q.splits = 1;
  q.out = dh; q.out_client = MD;
  if ((err = sm90_gemm<0, 0, 0, SM90_EPI_F32>(
           q, mt, ceil_div(D, SM90_BN), n, st))) return err;

  // LayerNorm backward: dx (+ the identity branch da), dLN1 scale and bias
  if ((err = ln_bwd<bf16>(dh, x, mean, rstd, lns, s ? da : nullptr, dx, rows,
                          M, D, st))) return err;
  if ((err = colsum<float, bf16>(dh, n, M, D, nullptr, 1, x, mean, rstd,
                                 nullptr, partial, dlns, st, wide)))
    return err;
  return colsum<float, bf16>(dh, n, M, D, nullptr, 1, nullptr, nullptr,
                             nullptr, nullptr, partial, dlnb, st, wide);
}

int attn_bwd_dispatch(int dtype, int n, int B, int N, int D, int H,
                      int rps_proj, int rps_qkv, const void* x,
                      const float* s, const float* lns, const float* lnb,
                      const void* wqkv, const void* bqkv, const void* wproj,
                      void* P, void* cat, const void* da, void* dx,
                      float* dlns, float* dlnb, float* dwqkv, float* dbqkv,
                      float* dwproj, float* dbproj, void* h, float* mean,
                      float* rstd, void* qkv, void* dac, void* dO, void* dS,
                      float* dqkv, void* dqkvc, float* dh, float* partial,
                      float* stats, float* hpart, float* wpart,
                      bool recompute, cudaStream_t st) {
  if (attn_on_sm90(dtype, D, H))
    return attn_bwd_sm90(
        n, B, N, D, H, rps_proj, rps_qkv, static_cast<const bf16*>(x), s, lns,
        lnb, static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
        static_cast<const bf16*>(wproj), static_cast<const bf16*>(P),
        static_cast<bf16*>(cat), static_cast<const bf16*>(da),
        static_cast<bf16*>(dx), dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj,
        static_cast<bf16*>(h), mean, rstd, static_cast<bf16*>(qkv),
        static_cast<bf16*>(dac), static_cast<bf16*>(dO),
        static_cast<bf16*>(dqkvc), dh, partial, stats, hpart, wpart,
        recompute, st);
  if (!dS || !dqkv || !P) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return attn_bwd_impl<bf16>(n, B, N, D, H, x, s, lns, lnb, wqkv, bqkv,
                               wproj, P, cat, da, dx, dlns, dlnb, dwqkv,
                               dbqkv, dwproj, dbproj, h, mean, rstd, qkv, dac,
                               dO, dS, dqkv, dqkvc, dh, partial, recompute,
                               st);
  return attn_bwd_impl<float>(n, B, N, D, H, x, s, lns, lnb, wqkv, bqkv,
                              wproj, P, cat, da, dx, dlns, dlnb, dwqkv, dbqkv,
                              dwproj, dbproj, h, mean, rstd, qkv, dac, dO, dS,
                              dqkv, dqkvc, dh, partial, recompute, st);
}

}  // namespace

// Inputs as fc_attn_fwd, plus P [n,B,H,N,N], cat [n,B,N,D], da [n,B,N,D] (T);
// rps_proj, rps_qkv: rows per split range of the dWproj and dWqkv sums
// (Hopper path; multiples of 64).
// Outputs: dx [n,B,N,D] (T); dlns, dlnb [n,D]; dwqkv [n,D,3D]; dbqkv [n,3D];
// dwproj [n,D,D]; dbproj [n,D] (all f32).
// Scratch: h, dac, dO [n,B,N,D] (T); mean, rstd [n*B*N] f32;
// qkv, dqkvc [n,B,N,3D] (T); dh [n,B,N,D] f32; partial [n,32,3D] f32.
// gemm_kernel path only: dS [n,B,H,N,N] (T); dqkv [n,B,N,3D] f32.
// Hopper path only: stats [n*B,H,N,3] f32 past N = 256; hpart [n*B*R,3D]
// f32 (R = 1 up to N = 256, else ceil(N/128) query blocks); wpart
// [S,n,D,3D] f32 for the larger S*columns of the two products, when an
// S = ceil(B*N/rps) > 1.  Unused buffers may be NULL.
extern "C" int fc_attn_bwd(int dtype, int n, int B, int N, int D, int H,
                           int rps_proj, int rps_qkv, const void* x,
                           const float* s, const float* lns, const float* lnb,
                           const void* wqkv, const void* bqkv,
                           const void* wproj, const void* P, const void* cat,
                           const void* da, void* dx, float* dlns, float* dlnb,
                           float* dwqkv, float* dbqkv, float* dwproj,
                           float* dbproj, void* h, float* mean, float* rstd,
                           void* qkv, void* dac, void* dO, void* dS,
                           float* dqkv, void* dqkvc, float* dh, float* partial,
                           float* stats, float* hpart, float* wpart,
                           cudaStream_t st) {
  // the saves are only read on this path
  return attn_bwd_dispatch(dtype, n, B, N, D, H, rps_proj, rps_qkv, x, s, lns,
                           lnb, wqkv, bqkv, wproj, const_cast<void*>(P),
                           const_cast<void*>(cat), da, dx, dlns, dlnb, dwqkv,
                           dbqkv, dwproj, dbproj, h, mean, rstd, qkv, dac, dO,
                           dS, dqkv, dqkvc, dh, partial, stats, hpart, wpart,
                           false, st);
}

// The recompute backward (no residual, no saves): inputs x, lns, lnb, wqkv,
// bqkv, wproj, da as fc_attn_bwd; outputs as fc_attn_bwd; cat [n,B,N,D] (T)
// becomes scratch, with the rest of fc_attn_bwd's, and on the gemm_kernel
// path so does P [n,B,H,N,N] (the Hopper path keeps P on chip: NULL).
extern "C" int fc_attn_bwd_recompute(
    int dtype, int n, int B, int N, int D, int H, int rps_proj, int rps_qkv,
    const void* x, const float* lns, const float* lnb, const void* wqkv,
    const void* bqkv, const void* wproj, const void* da, void* dx,
    float* dlns, float* dlnb, float* dwqkv, float* dbqkv, float* dwproj,
    float* dbproj, void* h, float* mean, float* rstd, void* qkv, void* P,
    void* cat, void* dac, void* dO, void* dS, float* dqkv, void* dqkvc,
    float* dh, float* partial, float* stats, float* hpart, float* wpart,
    cudaStream_t st) {
  return attn_bwd_dispatch(dtype, n, B, N, D, H, rps_proj, rps_qkv, x,
                           nullptr, lns, lnb, wqkv, bqkv, wproj, P, cat, da,
                           dx, dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj, h,
                           mean, rstd, qkv, dac, dO, dS, dqkv, dqkvc, dh,
                           partial, stats, hpart, wpart, true, st);
}
