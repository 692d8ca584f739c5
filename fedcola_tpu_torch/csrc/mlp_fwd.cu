// Fused MLP, forward:
//     out = [x + s_i *] ( GELU( LN2(x) . W1 + b1 ) . W2 + b2 )
// with exact-erf GELU (the TPU kernel uses the Abramowitz-Stegun erf,
// |err| < 1.5e-7; CUDA has erff).
//
// Replaces the TPU kernels of fedcola_tpu/ops/fused_mlp.py:
//   fc_mlp_fwd          _make_ln_item_fwd_kernel (via _ln_item_fwd_call):
//                       residual=True on the training path (s given),
//                       residual=False in eval (s=NULL);
//   fc_mlp_ln_fwd_rows  _ln_fwd_kernel (via _ln_fwd_call, "mlp_ln_fwd_rows"):
//                       the same function without residual on x [n, rows, D],
//                       i.e. one item of `rows` tokens per client;
//   fc_mlp_fwd_rows     _fwd_kernel (via _fwd_call, "mlp_fwd_rows"): no LN,
//                       fc1 reads x itself.
// The rows-mode Pallas calls pad rows to their 512-row tile; here every
// edge is masked, so any rows >= 1 runs unpadded.
//
// What bounds it on the H100: 4*rows*D*4D FLOPs per client (~45 GFLOP at
// the main-path shape, 18,912 rows) on the tensor cores; bytes are x in,
// out out and the weights.  The TPU kernel keeps the [rows, 4D] hidden
// activation in VMEM; this first version writes it once to device memory
// in T (116 MB at the main-path shape, n=2) between the two mma.sync GEMMs
// of common.cuh.  Keeping it on chip (fc1 -> fc2 through shared memory) is
// later work.
#include "common.cuh"

namespace {

template <typename T>
int mlp_fwd_impl(int n, int B, int N, int D, int F, const void* x_,
                 const float* s, const float* lns, const float* lnb,
                 const void* w1, const void* b1, const void* w2,
                 const void* b2, void* out, void* h_, float* mean,
                 float* rstd, void* hid, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* h = static_cast<T*>(h_);
  const int M = B * N;
  const long long rows = (long long)n * M;
  int err;
  const void* a = x_;  // fc1's input: LN2(x), or x when lns is NULL
  if (lns) {
    if ((err = ln_fwd<T>(x, lns, lnb, h, mean, rstd, rows, M, D, 1e-5f,
                         st))) return err;
    a = h;
  }

  GemmArgs g1 = gemm_args(M, F, D);
  set_a_rows(g1, a, D, (long long)M * D);
  set_b_rows(g1, w1, F, (long long)D * F);
  set_c(g1, hid, F, (long long)M * F);
  g1.bias = b1; g1.sbiasc = F;
  g1.gelu = 1;
  if ((err = gemm<T, T>(g1, n, st))) return err;

  GemmArgs g2 = gemm_args(M, D, F);
  set_a_rows(g2, hid, F, (long long)M * F);
  set_b_rows(g2, w2, D, (long long)F * D);
  set_c(g2, out, D, (long long)M * D);
  g2.bias = b2; g2.sbiasc = D;
  if (s) { g2.res = x; g2.s = s; g2.seq = N; }
  return gemm<T, T>(g2, n, st);
}

}  // namespace

// x [n,B,N,D] (T); s [n,B] f32 or NULL; lns/lnb [n,D] f32 (NULL: no LN,
// as fc_mlp_fwd_rows runs it); w1 [n,D,F], b1 [n,F], w2 [n,F,D], b2 [n,D]
// (T).  Output out [n,B,N,D] (T).
// Scratch: h [n,B,N,D] (T), mean/rstd [n*B*N] f32, hid [n,B,N,F] (T).
extern "C" int fc_mlp_fwd(int dtype, int n, int B, int N, int D, int F,
                          const void* x, const float* s, const float* lns,
                          const float* lnb, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out, void* h,
                          float* mean, float* rstd, void* hid,
                          cudaStream_t st) {
  if (dtype == 1)
    return mlp_fwd_impl<bf16>(n, B, N, D, F, x, s, lns, lnb, w1, b1, w2, b2,
                              out, h, mean, rstd, hid, st);
  return mlp_fwd_impl<float>(n, B, N, D, F, x, s, lns, lnb, w1, b1, w2, b2,
                             out, h, mean, rstd, hid, st);
}

// Rows mode: x [n,rows,D] (T); w1..b2 as fc_mlp_fwd.  Output out
// [n,rows,D] (T).  Scratch: hid [n,rows,F] (T).
extern "C" int fc_mlp_fwd_rows(int dtype, int n, int rows, int D, int F,
                               const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out,
                               void* hid, cudaStream_t st) {
  return fc_mlp_fwd(dtype, n, 1, rows, D, F, x, nullptr, nullptr, nullptr,
                    w1, b1, w2, b2, out, nullptr, nullptr, nullptr, hid, st);
}

// Rows mode with LN2: as fc_mlp_fwd with B=1, N=rows and s=NULL.
extern "C" int fc_mlp_ln_fwd_rows(int dtype, int n, int rows, int D, int F,
                                  const void* x, const float* lns,
                                  const float* lnb, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* h,
                                  float* mean, float* rstd, void* hid,
                                  cudaStream_t st) {
  return fc_mlp_fwd(dtype, n, 1, rows, D, F, x, nullptr, lns, lnb, w1, b1,
                    w2, b2, out, h, mean, rstd, hid, st);
}
