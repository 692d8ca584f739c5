// Fused MLP, backward (recomputes LN2, fc1 and GELU from x):
//     do_s = s_i * do;  pre = LN2(x) . W1 + b1;  dh = do_s . W2^T
//     dpre = dh * (Phi(pre) + pre * phi(pre));  dhn = dpre . W1^T
//     dx = LN2-backward(dhn) [+ do];  per client dW1, db1, dW2, db2, dLN2.
//
// Replaces the TPU kernels of fedcola_tpu/ops/fused_mlp.py:
//   fc_mlp_bwd          _make_ln_item_bwd_kernel (via _ln_item_bwd_call),
//                       residual=True on the training path;
//   fc_mlp_bwd_nores    its residual=False variant, the backward of
//                       fused_mlp_sublayer_items under the remat policies
//                       (s=NULL: the branch gradient is do itself and dx has
//                       no identity term);
//   fc_mlp_ln_bwd_rows  _ln_bwd_kernel (via _ln_bwd_call, "mlp_ln_bwd_rows"):
//                       fc_mlp_bwd_nores on x [n, rows, D], one item of
//                       `rows` tokens per client;
//   fc_mlp_bwd_rows     _bwd_kernel (via _bwd_call, "mlp_bwd_rows"): no LN,
//                       so fc1 reads x, dx = dpre . W1^T is accumulated in
//                       f32 and rounded to T once (as _bwd_math), and there
//                       is no LN backward and no dLN2.
// The rows-mode Pallas calls pad rows to their 256-row tile (the zero rows
// add nothing: their do is zero); here every edge is masked instead.
//
// What bounds it on the H100: 10*rows*D*F FLOPs per client (fc1
// recomputed, dh, dW1, dW2, dx; ~112 GFLOP at the main-path shape), two of
// the five products the weight gradients that reduce over all rows of a
// client.  The TPU kernel carries those sums across its sequential grid in
// VMEM and keeps pre and dh on chip.
//
// bf16 with D and F multiples of 8 (every model on the fused route) runs
// mlp_bwd_sm90, on gemm_sm90.cuh's TMA + wgmma mainloop:
//   1. ln_fwd (LN2 only) and row_scale (do_s);
//   2. the dual product: one block owns a 128-row x 128-column tile of
//      [rows, F] and runs pre = h.W1 + b1 and dh = do_s.W2^T into two
//      accumulators; its epilogue computes the GELU backward in f32 and
//      writes hg = T(GELU(pre)), dprec = T(dpre) and the f32 column sums
//      of dpre over its rows.  pre and dh never reach device memory;
//   3. dW1 = h^T.dprec and dW2 = hg^T.do_s: each client's rows are cut into
//      S ranges (planned by the caller from rows, D and F only, each a
//      multiple of the 64-row K tile) so that 128 x 128 output tiles x S
//      ranges fill the SMs; each (tile, range) block writes an f32 partial
//      and sum_parts adds the S partials in order, as it adds db1's row
//      tiles.  No atomics: every result is the same on every run, and the
//      item and rows entry points with the same rows per client agree
//      bitwise;
//   4. dhn = dprec.W1^T (f32, then ln_bwd and the dLN column sums), or,
//      without LN, dx rounded to T in the epilogue.
// f32, and bf16 with D or F off the 8 grid (TMA needs 16-byte row
// strides), run mlp_bwd_impl: the same function on common.cuh's
// gemm_kernel, with pre and dh in f32 device memory.  The choice is made
// here, by dtype and shape alone.
#include "gemm_sm90.cuh"

namespace {

// hg = T(GELU(pre));  dpre = dh * GELU'(pre) written over dh (f32) and as T
template <typename T>
__global__ void gelu_bwd_kernel(const float* pre, float* dh, T* hg, T* dprec,
                                long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const float p = pre[i];
    const float cdf = 0.5f * (1.0f + erff(p * 0.7071067811865475f));
    const float pdf = expf(-0.5f * p * p) * 0.3989422804014327f;
    hg[i] = from_f<T>(p * cdf);
    const float d = dh[i] * (cdf + p * pdf);
    dh[i] = d;
    dprec[i] = from_f<T>(d);
  }
}

// fc1's input, LN2(x) into h (x itself when lns is NULL), and the branch
// gradient dos = T(s * do) (a cast when s is NULL).
template <typename T>
int bwd_prologue(const T* x, const float* s, const float* lns,
                 const float* lnb, const T* dout, T* h, float* mean,
                 float* rstd, T* dos, long long rows, int M, int N, int D,
                 const T** a, cudaStream_t st) {
  int err;
  *a = x;
  if (lns) {
    if ((err = ln_fwd<T>(x, lns, lnb, h, mean, rstd, rows, M, D, 1e-5f,
                         st))) return err;
    *a = h;
  }
  return row_scale<T>(dout, s, N, D, rows * D, dos, st);
}

// dx = LN2-backward(dhn) [+ do];  dlns, dlnb: column sums of dhn * xhat
// and dhn.
template <typename T>
int ln2_bwd(const float* dhn, const T* x, const float* mean,
            const float* rstd, const float* lns, const T* res, T* dx,
            float* dlns, float* dlnb, float* partial, int n, int M, int D,
            cudaStream_t st) {
  int err;
  if ((err = ln_bwd<T>(dhn, x, mean, rstd, lns, res, dx, (long long)n * M, M,
                       D, st))) return err;
  if ((err = colsum<float, T>(dhn, n, M, D, nullptr, 1, x, mean, rstd,
                              nullptr, partial, dlns, st))) return err;
  return colsum<float, T>(dhn, n, M, D, nullptr, 1, nullptr, nullptr,
                          nullptr, nullptr, partial, dlnb, st);
}

template <typename T>
int mlp_bwd_impl(int n, int B, int N, int D, int F, const void* x_,
                 const float* s, const float* lns, const float* lnb,
                 const void* w1, const void* b1, const void* w2,
                 const void* do_, void* dx, float* dlns, float* dlnb,
                 float* dw1, float* db1, float* dw2, float* db2, void* h_,
                 float* mean, float* rstd, void* dos_, float* pre, float* dhid,
                 void* hg_, void* dprec_, float* dhn, float* partial,
                 cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const T* dout = static_cast<const T*>(do_);
  T* h = static_cast<T*>(h_);
  T* dos = static_cast<T*>(dos_);
  T* hg = static_cast<T*>(hg_);
  T* dprec = static_cast<T*>(dprec_);
  const int M = B * N;
  const long long rows = (long long)n * M;
  const long long MD = (long long)M * D, MF = (long long)M * F;
  int err;
  if (!pre || !dhid) return (int)cudaErrorInvalidValue;

  const T* a;
  if ((err = bwd_prologue<T>(x, s, lns, lnb, dout, h, mean, rstd, dos, rows,
                             M, N, D, &a, st))) return err;

  // pre = h . W1 + b1 (f32);  dh = dos . W2^T (f32)
  GemmArgs gp = gemm_args(M, F, D);
  set_a_rows(gp, a, D, MD);
  set_b_rows(gp, w1, F, (long long)D * F);
  set_c(gp, pre, F, MF);
  gp.bias = b1; gp.sbiasc = F;
  if ((err = gemm<T, float>(gp, n, st))) return err;
  GemmArgs gd = gemm_args(M, F, D);
  set_a_rows(gd, dos, D, MD);
  set_b_cols(gd, w2, D, (long long)F * D);
  set_c(gd, dhid, F, MF);
  if ((err = gemm<T, float>(gd, n, st))) return err;

  const long long total = rows * F;
  const long long want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < 65535 * 16 ? want : 65535 * 16);
  gelu_bwd_kernel<T><<<blocks, 256, 0, st>>>(pre, dhid, hg, dprec, total);
  FC_CHECK();

  // db1 = colsum(dpre);  dW1 = h^T . dpre;  dW2 = GELU(pre)^T . dos;  db2
  if ((err = colsum<float, T>(dhid, n, M, F, nullptr, 1, nullptr, nullptr,
                              nullptr, nullptr, partial, db1, st))) return err;
  GemmArgs w1g = gemm_args(D, F, M);
  set_a_cols(w1g, a, D, MD);
  set_b_rows(w1g, dprec, F, MF);
  set_c(w1g, dw1, F, (long long)D * F);
  if ((err = gemm<T, float>(w1g, n, st))) return err;
  GemmArgs w2g = gemm_args(F, D, M);
  set_a_cols(w2g, hg, F, MF);
  set_b_rows(w2g, dos, D, MD);
  set_c(w2g, dw2, D, (long long)F * D);
  if ((err = gemm<T, float>(w2g, n, st))) return err;
  if ((err = colsum<T, T>(dos, n, M, D, nullptr, 1, nullptr, nullptr, nullptr,
                          nullptr, partial, db2, st))) return err;

  // dhn = dpre . W1^T;  LayerNorm backward (+ the identity branch do).
  // Without LN it is dx itself, rounded to T in the GEMM's epilogue.
  GemmArgs gn = gemm_args(M, D, F);
  set_a_rows(gn, dprec, F, MF);
  set_b_cols(gn, w1, F, (long long)D * F);
  if (!lns) {
    set_c(gn, dx, D, MD);
    return gemm<T, T>(gn, n, st);
  }
  set_c(gn, dhn, D, MD);
  if ((err = gemm<T, float>(gn, n, st))) return err;
  return ln2_bwd<T>(dhn, x, mean, rstd, lns, s ? dout : nullptr,
                    static_cast<T*>(dx), dlns, dlnb, partial, n, M, D, st);
}

// The bf16 backward on the Hopper mainloop (steps 1-4 of the note above).
// rps: rows per split range of the weight-gradient products (a multiple of
// 64); S = ceil(M / rps) ranges, whose partials go to wpart [S, n, D*F]
// (unused when S == 1: the products then write dw1 / dw2 directly).
int mlp_bwd_sm90(int n, int B, int N, int D, int F, int rps, const bf16* x,
                 const float* s, const float* lns, const float* lnb,
                 const bf16* w1, const bf16* b1, const bf16* w2,
                 const bf16* dout, bf16* dx, float* dlns, float* dlnb,
                 float* dw1, float* db1, float* dw2, float* db2, bf16* h,
                 float* mean, float* rstd, bf16* dos, bf16* hg, bf16* dprec,
                 float* dhn, float* partial, float* db1part, float* wpart,
                 cudaStream_t st) {
  const int M = B * N;
  const long long rows = (long long)n * M;
  const long long DF = (long long)D * F;
  if (rps <= 0 || rps % SM90_BK) return (int)cudaErrorInvalidValue;
  const int splits = ceil_div(M, rps);
  if (splits > 1 && !wpart) return (int)cudaErrorInvalidValue;
  const int mt = ceil_div(M, SM90_BM);
  int err;

  const bf16* a;
  if ((err = bwd_prologue<bf16>(x, s, lns, lnb, dout, h, mean, rstd, dos,
                                rows, M, N, D, &a, st))) return err;

  // the dual product: hg, dprec and db1's per-tile column sums
  Sm90Args g = {};
  if ((err = make_map(&g.a0, a, n, M, D)) || (err = make_map(&g.b0, w1, n, D, F)) ||
      (err = make_map(&g.a1, dos, n, M, D)) || (err = make_map(&g.b1, w2, n, F, D)))
    return err;
  g.M = M; g.N = F;
  g.k_tiles = g.tiles_per_split = ceil_div(D, SM90_BK);
  g.splits = 1;
  g.bias = b1; g.hg = hg; g.dprec = dprec; g.colsum = db1part; g.clients = n;
  if ((err = sm90_gemm<0, 1, 0, SM90_EPI_GELU_BWD>(
           g, mt, ceil_div(F, SM90_BN), n, st))) return err;
  if ((err = sum_parts(db1part, mt, (long long)n * F, db1, st))) return err;

  // dW1 = h^T . dprec [D, F] and dW2 = hg^T . dos [F, D], K = the rows
  Sm90Args w = {};
  w.k_tiles = ceil_div(M, SM90_BK);
  w.tiles_per_split = rps / SM90_BK;
  w.splits = splits;
  w.out_client = DF;
  w.out_split = n * DF;
  const bf16* lhs[2] = {a, hg};
  const bf16* rhs[2] = {dprec, dos};
  float* dw[2] = {dw1, dw2};
  const int outer[2] = {D, F}, inner[2] = {F, D};
  for (int p = 0; p < 2; ++p) {
    if ((err = make_map(&w.a0, lhs[p], n, M, outer[p])) ||
        (err = make_map(&w.b0, rhs[p], n, M, inner[p])))
      return err;
    w.M = outer[p]; w.N = inner[p];
    w.out = splits > 1 ? wpart : dw[p];
    if ((err = sm90_gemm<1, 1, 0, SM90_EPI_F32>(
             w, ceil_div(outer[p], SM90_BM), ceil_div(inner[p], SM90_BN),
             n * splits, st))) return err;
    if (splits > 1 &&
        (err = sum_parts(wpart, splits, n * DF, dw[p], st))) return err;
  }
  if ((err = colsum<bf16, bf16>(dos, n, M, D, nullptr, 1, nullptr, nullptr,
                                nullptr, nullptr, partial, db2, st)))
    return err;

  // dhn = dprec . W1^T (W1 [D, F] is the K-major B), or dx without LN
  Sm90Args q = {};
  if ((err = make_map(&q.a0, dprec, n, M, F)) ||
      (err = make_map(&q.b0, w1, n, D, F)))
    return err;
  q.M = M; q.N = D;
  q.k_tiles = q.tiles_per_split = ceil_div(F, SM90_BK);
  q.splits = 1;
  q.out_client = (long long)M * D;
  const int nt = ceil_div(D, SM90_BN);
  if (!lns) {
    q.out = dx;
    return sm90_gemm<0, 0, 0, SM90_EPI_BF16>(q, mt, nt, n, st);
  }
  q.out = dhn;
  if ((err = sm90_gemm<0, 0, 0, SM90_EPI_F32>(q, mt, nt, n, st))) return err;
  return ln2_bwd<bf16>(dhn, x, mean, rstd, lns, s ? dout : nullptr, dx, dlns,
                       dlnb, partial, n, M, D, st);
}

}  // namespace

// Inputs as fc_mlp_fwd (no b2), plus do [n,B,N,D] (T); rps: rows per split
// range of the weight-gradient sums (bf16 path; a multiple of 64).
// Outputs: dx [n,B,N,D] (T); dlns, dlnb [n,D]; dw1 [n,D,F]; db1 [n,F];
// dw2 [n,F,D]; db2 [n,D] (all f32).
// Scratch: h, dos [n,B,N,D] (T); mean, rstd [n*B*N] f32; hg, dprec
// [n,B,N,F] (T); dhn [n,B,N,D] f32; partial [n,32,D] f32 (the D-wide
// column sums; [n,32,max(F,D)] on the gemm_kernel path, which also sums
// db1 through it).  gemm_kernel path only: pre, dhid [n,B,N,F] f32.
// Hopper path only: db1part [ceil(B*N/128),n,F] f32; wpart [S,n,D,F] f32
// when S = ceil(B*N/rps) > 1.  Unused buffers may be NULL.
extern "C" int fc_mlp_bwd(int dtype, int n, int B, int N, int D, int F,
                          int rps, const void* x, const float* s,
                          const float* lns, const float* lnb, const void* w1,
                          const void* b1, const void* w2, const void* dout,
                          void* dx, float* dlns, float* dlnb, float* dw1,
                          float* db1, float* dw2, float* db2, void* h,
                          float* mean, float* rstd, void* dos, float* pre,
                          float* dhid, void* hg, void* dprec, float* dhn,
                          float* partial, float* db1part, float* wpart,
                          cudaStream_t st) {
  if (sm90_takes(dtype, D, F))
    return mlp_bwd_sm90(
        n, B, N, D, F, rps, static_cast<const bf16*>(x), s, lns, lnb,
        static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(w2), static_cast<const bf16*>(dout),
        static_cast<bf16*>(dx), dlns, dlnb, dw1, db1, dw2, db2,
        static_cast<bf16*>(h), mean, rstd, static_cast<bf16*>(dos),
        static_cast<bf16*>(hg), static_cast<bf16*>(dprec), dhn, partial,
        db1part, wpart, st);
  if (dtype == 1)
    return mlp_bwd_impl<bf16>(n, B, N, D, F, x, s, lns, lnb, w1, b1, w2, dout,
                              dx, dlns, dlnb, dw1, db1, dw2, db2, h, mean,
                              rstd, dos, pre, dhid, hg, dprec, dhn, partial,
                              st);
  return mlp_bwd_impl<float>(n, B, N, D, F, x, s, lns, lnb, w1, b1, w2, dout,
                             dx, dlns, dlnb, dw1, db1, dw2, db2, h, mean,
                             rstd, dos, pre, dhid, hg, dprec, dhn, partial,
                             st);
}

// The residual=False variant: fc_mlp_bwd without s.
extern "C" int fc_mlp_bwd_nores(int dtype, int n, int B, int N, int D, int F,
                                int rps, const void* x, const float* lns,
                                const float* lnb, const void* w1,
                                const void* b1, const void* w2,
                                const void* dout, void* dx, float* dlns,
                                float* dlnb, float* dw1, float* db1,
                                float* dw2, float* db2, void* h, float* mean,
                                float* rstd, void* dos, float* pre,
                                float* dhid, void* hg, void* dprec,
                                float* dhn, float* partial, float* db1part,
                                float* wpart, cudaStream_t st) {
  return fc_mlp_bwd(dtype, n, B, N, D, F, rps, x, nullptr, lns, lnb, w1, b1,
                    w2, dout, dx, dlns, dlnb, dw1, db1, dw2, db2, h, mean,
                    rstd, dos, pre, dhid, hg, dprec, dhn, partial, db1part,
                    wpart, st);
}

// Rows mode: x, do [n,rows,D] (T); w1, b1, w2 as fc_mlp_bwd.
// Outputs: dx [n,rows,D] (T); dw1 [n,D,F]; db1 [n,F]; dw2 [n,F,D];
// db2 [n,D] (f32).  Scratch as fc_mlp_bwd with B=1, N=rows.
extern "C" int fc_mlp_bwd_rows(int dtype, int n, int rows, int D, int F,
                               int rps, const void* x, const void* w1,
                               const void* b1, const void* w2,
                               const void* dout, void* dx, float* dw1,
                               float* db1, float* dw2, float* db2, void* dos,
                               float* pre, float* dhid, void* hg, void* dprec,
                               float* partial, float* db1part, float* wpart,
                               cudaStream_t st) {
  return fc_mlp_bwd(dtype, n, 1, rows, D, F, rps, x, nullptr, nullptr,
                    nullptr, w1, b1, w2, dout, dx, nullptr, nullptr, dw1, db1,
                    dw2, db2, nullptr, nullptr, nullptr, dos, pre, dhid, hg,
                    dprec, nullptr, partial, db1part, wpart, st);
}

// Rows mode with LN2: fc_mlp_bwd_nores with B=1, N=rows.
extern "C" int fc_mlp_ln_bwd_rows(int dtype, int n, int rows, int D, int F,
                                  int rps, const void* x, const float* lns,
                                  const float* lnb, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* dout, void* dx, float* dlns,
                                  float* dlnb, float* dw1, float* db1,
                                  float* dw2, float* db2, void* h,
                                  float* mean, float* rstd, void* dos,
                                  float* pre, float* dhid, void* hg,
                                  void* dprec, float* dhn, float* partial,
                                  float* db1part, float* wpart,
                                  cudaStream_t st) {
  return fc_mlp_bwd_nores(dtype, n, 1, rows, D, F, rps, x, lns, lnb, w1, b1,
                          w2, dout, dx, dlns, dlnb, dw1, db1, dw2, db2, h,
                          mean, rstd, dos, pre, dhid, hg, dprec, dhn, partial,
                          db1part, wpart, st);
}

// Test only (no path calls it): c[i] = A[i] . B[i] in f32 on the Hopper
// mainloop, for the four operand layouts.  ta = 0: a is [n, M, K]
// (K-major), ta = 1: a is [n, K, M] (MN-major, as h in h^T.dprec);
// tb = 0: b is [n, N, K] (K-major, as W in x.W^T), tb = 1: b is [n, K, N]
// (MN-major, as W in x.W).  c is [n, M, N] f32.  The contiguous dimension
// of each operand must be a multiple of 8, and N even.
extern "C" int fc_sm90_gemm_test(int ta, int tb, int n, int M, int N, int K,
                                 const void* a, const void* b, float* c,
                                 cudaStream_t st) {
  Sm90Args g = {};
  int err;
  if ((err = ta ? make_map(&g.a0, a, n, K, M) : make_map(&g.a0, a, n, M, K)) ||
      (err = tb ? make_map(&g.b0, b, n, K, N) : make_map(&g.b0, b, n, N, K)))
    return err;
  g.M = M; g.N = N;
  g.k_tiles = g.tiles_per_split = ceil_div(K, SM90_BK);
  g.splits = 1;
  g.out = c;
  g.out_client = (long long)M * N;
  const int mt = ceil_div(M, SM90_BM), nt = ceil_div(N, SM90_BN);
  if (ta && tb) return sm90_gemm<1, 1, 0, SM90_EPI_F32>(g, mt, nt, n, st);
  if (ta) return sm90_gemm<1, 0, 0, SM90_EPI_F32>(g, mt, nt, n, st);
  if (tb) return sm90_gemm<0, 1, 0, SM90_EPI_F32>(g, mt, nt, n, st);
  return sm90_gemm<0, 0, 0, SM90_EPI_F32>(g, mt, nt, n, st);
}
