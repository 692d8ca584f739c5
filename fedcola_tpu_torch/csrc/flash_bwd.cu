// Flash attention, backward: dq, dk, dv of o = softmax(qm . k^T) . v with
// qm = T(q * scale), for every (batch, head) pair.
//
// Replaces the TPU kernel fedcola_tpu/ops/flash_attention.py: _bwd_kernel
// (via _fa_bwd): P recomputed in f32; dv = P^T . do, dp = do . v^T,
// delta = rowsum(do * (P . v)), ds = P * (dp - delta), dq = ds . k,
// dk = ds^T . qm; each result is cast to its input's dtype, and dq is then
// multiplied by scale in q's dtype (a second rounding, as _fa_bwd applies
// it after the pallas_call).
//
// What bounds it on the H100: at mome_tiny's training shape (576 pairs,
// N=197, hd=64) ~14 GFLOP against ~116 MB in bf16: the bytes, once the
// products run on tensor cores.  Two paths, chosen here by dtype and shape
// (ops/flash_attention.py uses_tensor_cores mirrors the choice):
//
//   bf16, hd in {16, 32, 64}: the per-head tensor-core backward of
//     attn_bwd_core.cuh in its flash mode, one fused launch, one block per
//     pair: q, k, v, do as padded bf16 tiles in shared memory (117 KB at
//     N=197), q pre-scaled and rounded there, every product an mma.sync,
//     no statistics through memory.  Past N = 256 its streamed row and
//     column kernels (Hopper: TMA + wgmma, attn_wgmma.cuh), the row
//     statistics through the scratch stats.
//     Rounding, where it departs from the TPU kernel: _bwd_kernel keeps P
//     and dS in f32 through every product; here they are handed on as bf16
//     A fragments (dv = T(P)^T . do, dq = T(dS) . k, dk = T(dS)^T . qm), and
//     delta is rowsum(dp * P) rather than rowsum(do * (P . v)), equal in
//     real arithmetic.  Scores, softmax, delta and every accumulator stay
//     f32.  The results stay within the bf16 tolerance (3e-2 of max|ref|)
//     of the plain version, which keeps the TPU kernel's arithmetic.
//   float32, and bf16 at any other head_dim: the CUDA-core kernels below,
//     which keep the TPU kernel's f32 P and dS.  Four [197, 64] f32
//     operands (~200 KB) leave too little of a block's 227 KB, so the
//     backward is split:
//   * a row pass (one warp per query row, the pair's K and V in shared
//     memory) computes P, o, delta and dS for its row and dq, and writes the
//     row's softmax max, sum and delta (12 bytes a row);
//   * a column pass (one warp per key row, the pair's qm and do in shared
//     memory) recomputes P and dS from those statistics in the same order
//     of operations and reduces dk and dv over the query rows.
//   Past N = 256 both passes stream: the row pass per 64 query rows, the
//   keys in chunks of 32 and three passes over them (the softmax
//   statistics, o and delta = do . o, then dS and dq); the column pass per
//   64 keys, the query rows (qm, do and their statistics) in chunks of 32.
// No atomics on either path; every result is reproducible run to run.
#include "attn_bwd_core.cuh"

namespace {

constexpr int FB_WARPS = 8;
constexpr int FB_MAXR = 8;    // rows per lane of the resident kernels
constexpr int FB_MAXHD = 64;  // hd <= 64
constexpr int FB_KR = 64;     // streamed column pass: keys a block, 8 a warp

template <typename T>
__device__ __forceinline__ float prescaled(T q, float qscale) {
  return to_f(from_f<T>(to_f(q) * qscale));
}

template <typename T>
__global__ void __launch_bounds__(FB_WARPS * 32)
flash_bwd_rows_kernel(const T* qg, const T* kg, const T* vg, const T* dog,
                      T* dq, float* stats, int N, int hd, float qscale) {
  extern __shared__ float smf[];
  const int ld = hd + 1;
  const int NP = (N + 31) / 32 * 32;
  float* Ks = smf;                              // [N][hd+1]
  float* Vs = Ks + N * ld;                      // [N][hd+1]
  float* qrow = Vs + N * ld;                    // [warps][hd]
  float* grow = qrow + FB_WARPS * FB_MAXHD;     // [warps][hd]
  float* prow = grow + FB_WARPS * FB_MAXHD;     // [warps][NP]

  const long long pair = blockIdx.x;
  const long long base = pair * N * hd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < N * hd; e += blockDim.x) {
    const int j = e / hd, d = e % hd;
    Ks[j * ld + d] = to_f(kg[base + e]);
    Vs[j * ld + d] = to_f(vg[base + e]);
  }
  __syncthreads();

  float* q = qrow + warp * FB_MAXHD;
  float* g = grow + warp * FB_MAXHD;
  float* p = prow + warp * NP;
  for (int i = warp; i < N; i += FB_WARPS) {
    for (int d = lane; d < hd; d += 32) {
      q[d] = prescaled(qg[base + (long long)i * hd + d], qscale);
      g[d] = to_f(dog[base + (long long)i * hd + d]);
    }
    __syncwarp();
    float pv[FB_MAXR], dp[FB_MAXR];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < FB_MAXR; ++r) {
      const int j = lane + 32 * r;
      float s = -INFINITY, a = 0.0f;
      if (j < N) {
        const float* kr = Ks + j * ld;
        const float* vr = Vs + j * ld;
        float sk = 0.0f;
        for (int d = 0; d < hd; ++d) sk += q[d] * kr[d];
        for (int d = 0; d < hd; ++d) a += g[d] * vr[d];
        s = sk;
      }
      pv[r] = s;
      dp[r] = a;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < FB_MAXR; ++r) {
      const int j = lane + 32 * r;
      pv[r] = j < N ? expf(pv[r] - mx) : 0.0f;
      sum += pv[r];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int r = 0; r < FB_MAXR; ++r) {
      const int j = lane + 32 * r;
      pv[r] /= sum;
      if (j < N) p[j] = pv[r];
    }
    __syncwarp();
    // o = P . V (f32) and delta = do . o
    float dl = 0.0f;
    for (int d = lane; d < hd; d += 32) {
      float o = 0.0f;
      for (int j = 0; j < N; ++j) o += p[j] * Vs[j * ld + d];
      dl += g[d] * o;
    }
    const float delta = warp_sum(dl);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < FB_MAXR; ++r) {
      const int j = lane + 32 * r;
      if (j < N) p[j] = pv[r] * (dp[r] - delta);
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float a = 0.0f;
      for (int j = 0; j < N; ++j) a += p[j] * Ks[j * ld + d];
      dq[base + (long long)i * hd + d] = from_f<T>(to_f(from_f<T>(a)) * qscale);
    }
    if (lane == 0) {
      float* st = stats + (pair * N + i) * 3;
      st[0] = mx;
      st[1] = sum;
      st[2] = delta;
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(FB_WARPS * 32)
flash_bwd_cols_kernel(const T* qg, const T* kg, const T* vg, const T* dog,
                      T* dk, T* dv, const float* stats, int N, int hd,
                      float qscale) {
  extern __shared__ float smf[];
  const int ld = hd + 1;
  const int NP = (N + 31) / 32 * 32;
  float* Qs = smf;                              // [N][hd+1] (qm)
  float* Gs = Qs + N * ld;                      // [N][hd+1] (do)
  float* sm = Gs + N * ld;                      // [NP] row max
  float* sl = sm + NP;                          // [NP] row sum
  float* sd = sl + NP;                          // [NP] row delta
  float* krow = sd + NP;                        // [warps][hd]
  float* vrow = krow + FB_WARPS * FB_MAXHD;     // [warps][hd]
  float* prow = vrow + FB_WARPS * FB_MAXHD;     // [warps][NP]
  float* srow = prow + FB_WARPS * NP;           // [warps][NP]

  const long long pair = blockIdx.x;
  const long long base = pair * N * hd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < N * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    Qs[i * ld + d] = prescaled(qg[base + e], qscale);
    Gs[i * ld + d] = to_f(dog[base + e]);
  }
  for (int i = tid; i < N; i += blockDim.x) {
    const float* st = stats + (pair * N + i) * 3;
    sm[i] = st[0];
    sl[i] = st[1];
    sd[i] = st[2];
  }
  __syncthreads();

  float* kk = krow + warp * FB_MAXHD;
  float* vv = vrow + warp * FB_MAXHD;
  float* p = prow + warp * NP;
  float* s = srow + warp * NP;
  for (int j = warp; j < N; j += FB_WARPS) {
    for (int d = lane; d < hd; d += 32) {
      kk[d] = to_f(kg[base + (long long)j * hd + d]);
      vv[d] = to_f(vg[base + (long long)j * hd + d]);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < FB_MAXR; ++r) {
      const int i = lane + 32 * r;
      if (i < N) {
        const float* qr = Qs + i * ld;
        const float* gr = Gs + i * ld;
        float sk = 0.0f, a = 0.0f;
        for (int d = 0; d < hd; ++d) sk += qr[d] * kk[d];
        for (int d = 0; d < hd; ++d) a += gr[d] * vv[d];
        const float pij = expf(sk - sm[i]) / sl[i];
        p[i] = pij;
        s[i] = pij * (a - sd[i]);
      }
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float av = 0.0f, ak = 0.0f;
      for (int i = 0; i < N; ++i) {
        av += p[i] * Gs[i * ld + d];
        ak += s[i] * Qs[i * ld + d];
      }
      dv[base + (long long)j * hd + d] = from_f<T>(av);
      dk[base + (long long)j * hd + d] = from_f<T>(ak);
    }
    __syncwarp();
  }
}

// The streamed row pass (N > AT_RESIDENT_N): grid (pairs, ceil(N /
// AT_QR)), a warp per AT_QR / FB_WARPS query rows, K and V in chunks of
// AT_KC rows, one key a lane.  Three passes over the keys: the row max and
// sum (carried under the running max); P = exp(s - max) / sum in f32 and
// o = P . v, so delta = do . o as the resident kernel forms it; dS = P (dp
// - delta) and dq.  Writes the row's max, sum and delta to stats.
template <typename T>
__global__ void __launch_bounds__(FB_WARPS * 32)
flash_bwd_rows_stream_kernel(const T* qg, const T* kg, const T* vg,
                             const T* dog, T* dq, float* stats, int N, int hd,
                             float qscale) {
  constexpr int RPW = AT_QR / FB_WARPS;
  extern __shared__ float smf[];
  const int ld = hd + 1;
  float* Qs = smf;                 // [AT_QR][hd+1] (qm)
  float* Gs = Qs + AT_QR * ld;     // [AT_QR][hd+1] (do)
  float* Ks = Gs + AT_QR * ld;     // [AT_KC][hd+1]
  float* Vs = Ks + AT_KC * ld;     // [AT_KC][hd+1]
  float* pw = Vs + AT_KC * ld;     // [warps][AT_KC]

  const long long pair = blockIdx.x;
  const long long base = pair * N * hd;
  const int q0 = blockIdx.y * AT_QR, nq = min(AT_QR, N - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < nq * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const long long at = base + (long long)(q0 + i) * hd + d;
    Qs[i * ld + d] = prescaled(qg[at], qscale);
    Gs[i * ld + d] = to_f(dog[at]);
  }
  float m[RPW], l[RPW], a2[RPW][2];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY; l[r] = 0.0f; a2[r][0] = 0.0f; a2[r][1] = 0.0f;
  }
  float* p = pw + warp * AT_KC;
  // a chunk of K (and V) rows into shared memory, between two barriers
  auto load = [&](int j0, int kc, bool with_v) {
    __syncthreads();
    for (int e = tid; e < kc * hd; e += blockDim.x) {
      const int j = e / hd, d = e % hd;
      const long long at = base + (long long)(j0 + j) * hd + d;
      Ks[j * ld + d] = to_f(kg[at]);
      if (with_v) Vs[j * ld + d] = to_f(vg[at]);
    }
    __syncthreads();
  };
  auto score = [&](int i, int j) {
    const float* qr = Qs + i * ld;
    const float* kr = Ks + j * ld;
    float a = 0.0f;
    for (int d = 0; d < hd; ++d) a += qr[d] * kr[d];
    return a;
  };

  // pass 1: max and sum
  for (int j0 = 0; j0 < N; j0 += AT_KC) {
    const int kc = min(AT_KC, N - j0);
    load(j0, kc, false);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      if (i >= nq) continue;
      const float s = lane < kc ? score(i, lane) : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(s));
      const float e = lane < kc ? expf(s - mn) : 0.0f;
      l[r] = l[r] * expf(m[r] - mn) + warp_sum(e);
      m[r] = mn;
    }
  }
  // pass 2: o = P . v (a2 holds it)
  for (int j0 = 0; j0 < N; j0 += AT_KC) {
    const int kc = min(AT_KC, N - j0);
    load(j0, kc, true);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      if (i >= nq) continue;
      if (lane < kc) p[lane] = expf(score(i, lane) - m[r]) / l[r];
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < 2; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) {
          float o = 0.0f;
          for (int j = 0; j < kc; ++j) o += p[j] * Vs[j * ld + d];
          a2[r][dd] += o;
        }
      }
      __syncwarp();
    }
  }
  float delta[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp * RPW + r;
    float dl = 0.0f;
    if (i < nq) {
#pragma unroll
      for (int dd = 0; dd < 2; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) dl += Gs[i * ld + d] * a2[r][dd];
      }
    }
    delta[r] = warp_sum(dl);
    a2[r][0] = 0.0f;
    a2[r][1] = 0.0f;
  }
  // pass 3: dS = P (dp - delta), dq = dS . k (a2 holds it)
  for (int j0 = 0; j0 < N; j0 += AT_KC) {
    const int kc = min(AT_KC, N - j0);
    load(j0, kc, true);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      if (i >= nq) continue;
      if (lane < kc) {
        const float* gr = Gs + i * ld;
        const float* vr = Vs + lane * ld;
        float dp = 0.0f;
        for (int d = 0; d < hd; ++d) dp += gr[d] * vr[d];
        const float pv = expf(score(i, lane) - m[r]) / l[r];
        p[lane] = pv * (dp - delta[r]);
      }
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < 2; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) {
          float a = 0.0f;
          for (int j = 0; j < kc; ++j) a += p[j] * Ks[j * ld + d];
          a2[r][dd] += a;
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp * RPW + r;
    if (i >= nq) continue;
    const long long row = (long long)(q0 + i);
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int d = lane + 32 * dd;
      if (d < hd)
        dq[base + row * hd + d] =
            from_f<T>(to_f(from_f<T>(a2[r][dd])) * qscale);
    }
    if (lane == 0) {
      float* st = stats + (pair * N + row) * 3;
      st[0] = m[r];
      st[1] = l[r];
      st[2] = delta[r];
    }
  }
}

// The streamed column pass: grid (pairs, ceil(N / FB_KR)), a warp per
// FB_KR / FB_WARPS keys of the block (their k and v rows in shared
// memory), the query rows' qm, do and statistics in chunks of AT_KC, one
// query a lane: P and dS recomputed as the resident column pass does,
// dk and dv accumulated in registers.
template <typename T>
__global__ void __launch_bounds__(FB_WARPS * 32)
flash_bwd_cols_stream_kernel(const T* qg, const T* kg, const T* vg,
                             const T* dog, T* dk, T* dv, const float* stats,
                             int N, int hd, float qscale) {
  constexpr int RPW = FB_KR / FB_WARPS;
  extern __shared__ float smf[];
  const int ld = hd + 1;
  float* Kb = smf;                 // [FB_KR][hd+1]
  float* Vb = Kb + FB_KR * ld;     // [FB_KR][hd+1]
  float* Qs = Vb + FB_KR * ld;     // [AT_KC][hd+1] (qm)
  float* Gs = Qs + AT_KC * ld;     // [AT_KC][hd+1] (do)
  float* sm = Gs + AT_KC * ld;     // [AT_KC] row max
  float* sl = sm + AT_KC;          // [AT_KC] row sum
  float* sd = sl + AT_KC;          // [AT_KC] row delta
  float* pw = sd + AT_KC;          // [warps][AT_KC]
  float* sw = pw + FB_WARPS * AT_KC;  // [warps][AT_KC]

  const long long pair = blockIdx.x;
  const long long base = pair * N * hd;
  const int k0 = blockIdx.y * FB_KR, nk = min(FB_KR, N - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < nk * hd; e += blockDim.x) {
    const int j = e / hd, d = e % hd;
    const long long at = base + (long long)(k0 + j) * hd + d;
    Kb[j * ld + d] = to_f(kg[at]);
    Vb[j * ld + d] = to_f(vg[at]);
  }
  float av[RPW][2], ak[RPW][2];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    av[r][0] = av[r][1] = 0.0f;
    ak[r][0] = ak[r][1] = 0.0f;
  }
  float* p = pw + warp * AT_KC;
  float* s = sw + warp * AT_KC;
  for (int i0 = 0; i0 < N; i0 += AT_KC) {
    const int qc = min(AT_KC, N - i0);
    __syncthreads();
    for (int e = tid; e < qc * hd; e += blockDim.x) {
      const int i = e / hd, d = e % hd;
      const long long at = base + (long long)(i0 + i) * hd + d;
      Qs[i * ld + d] = prescaled(qg[at], qscale);
      Gs[i * ld + d] = to_f(dog[at]);
    }
    for (int i = tid; i < qc; i += blockDim.x) {
      const float* st = stats + (pair * N + i0 + i) * 3;
      sm[i] = st[0];
      sl[i] = st[1];
      sd[i] = st[2];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int j = warp * RPW + r;
      if (j >= nk) continue;
      if (lane < qc) {
        const float* qr = Qs + lane * ld;
        const float* gr = Gs + lane * ld;
        const float* kr = Kb + j * ld;
        const float* vr = Vb + j * ld;
        float sk = 0.0f, a = 0.0f;
        for (int d = 0; d < hd; ++d) sk += qr[d] * kr[d];
        for (int d = 0; d < hd; ++d) a += gr[d] * vr[d];
        const float pij = expf(sk - sm[lane]) / sl[lane];
        p[lane] = pij;
        s[lane] = pij * (a - sd[lane]);
      }
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < 2; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) {
          float x = 0.0f, y = 0.0f;
          for (int i = 0; i < qc; ++i) {
            x += p[i] * Gs[i * ld + d];
            y += s[i] * Qs[i * ld + d];
          }
          av[r][dd] += x;
          ak[r][dd] += y;
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int j = warp * RPW + r;
    if (j >= nk) continue;
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int d = lane + 32 * dd;
      if (d < hd) {
        const long long at = base + (long long)(k0 + j) * hd + d;
        dv[at] = from_f<T>(av[r][dd]);
        dk[at] = from_f<T>(ak[r][dd]);
      }
    }
  }
}

__host__ __device__ inline size_t flash_bwd_rows_stream_smem(int hd) {
  return (size_t)((2 * AT_QR + 2 * AT_KC) * (hd + 1) + FB_WARPS * AT_KC) *
         sizeof(float);
}
__host__ __device__ inline size_t flash_bwd_cols_stream_smem(int hd) {
  return (size_t)((2 * FB_KR + 2 * AT_KC) * (hd + 1) + 3 * AT_KC +
                  2 * FB_WARPS * AT_KC) *
         sizeof(float);
}

template <typename T>
int flash_bwd_impl(int pairs, int N, int hd, float qscale, const void* q_,
                   const void* k_, const void* v_, const void* do_, void* dq,
                   void* dk, void* dv, float* stats, cudaStream_t st) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dO = static_cast<const T*>(do_);
  if (attn_streams_keys(N)) {
    const size_t smem_r = flash_bwd_rows_stream_smem(hd);
    cudaFuncSetAttribute(flash_bwd_rows_stream_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_r);
    FC_CHECK();
    flash_bwd_rows_stream_kernel<T>
        <<<dim3(pairs, (N + AT_QR - 1) / AT_QR), FB_WARPS * 32, smem_r, st>>>(
            q, k, v, dO, static_cast<T*>(dq), stats, N, hd, qscale);
    FC_CHECK();
    const size_t smem_c = flash_bwd_cols_stream_smem(hd);
    cudaFuncSetAttribute(flash_bwd_cols_stream_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_c);
    FC_CHECK();
    flash_bwd_cols_stream_kernel<T>
        <<<dim3(pairs, (N + FB_KR - 1) / FB_KR), FB_WARPS * 32, smem_c, st>>>(
            q, k, v, dO, static_cast<T*>(dk), static_cast<T*>(dv), stats, N,
            hd, qscale);
    FC_CHECK();
    return 0;
  }
  const int NP = (N + 31) / 32 * 32;
  const size_t smem_r = (size_t)(2 * N * (hd + 1) + 2 * FB_WARPS * FB_MAXHD +
                                 FB_WARPS * NP) * sizeof(float);
  cudaFuncSetAttribute(flash_bwd_rows_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_r);
  FC_CHECK();
  flash_bwd_rows_kernel<T><<<pairs, FB_WARPS * 32, smem_r, st>>>(
      q, k, v, dO, static_cast<T*>(dq), stats, N, hd, qscale);
  FC_CHECK();
  const size_t smem_c = (size_t)(2 * N * (hd + 1) + 3 * NP +
                                 2 * FB_WARPS * FB_MAXHD + 2 * FB_WARPS * NP) *
                        sizeof(float);
  cudaFuncSetAttribute(flash_bwd_cols_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  FC_CHECK();
  flash_bwd_cols_kernel<T><<<pairs, FB_WARPS * 32, smem_c, st>>>(
      q, k, v, dO, static_cast<T*>(dk), static_cast<T*>(dv), stats, N, hd,
      qscale);
  FC_CHECK();
  return 0;
}

}  // namespace

// q, k, v, do, dq, dk, dv [pairs, N, hd] (T), contiguous; qscale as
// fc_flash_fwd.  hd <= 64, any N.  Scratch: stats [pairs, N, 3] f32 on the
// CUDA-core path and, past N = 256, on the tensor-core path (the resident
// tensor-core kernel does not read the pointer).
extern "C" int fc_flash_bwd(int dtype, int pairs, int N, int hd, float qscale,
                            const void* q, const void* k, const void* v,
                            const void* dout, void* dq, void* dk, void* dv,
                            float* stats, cudaStream_t st) {
  if (dtype == 1 && (hd == 16 || hd == 32 || hd == 64)) {
    const long long item = (long long)N * hd;
    const HeadLayout L = {item, hd, item, hd, item, hd};
    return attn_bwd_head<AH_FLASH>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), nullptr,
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        nullptr, nullptr, stats, L, pairs, 1, N, hd, 1.0f, qscale, 0, st);
  }
  if (dtype == 1)
    return flash_bwd_impl<bf16>(pairs, N, hd, qscale, q, k, v, dout, dq, dk,
                                dv, stats, st);
  return flash_bwd_impl<float>(pairs, N, hd, qscale, q, k, v, dout, dq, dk,
                               dv, stats, st);
}
