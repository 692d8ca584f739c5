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
// What bounds it on the H100: 4*rows*D*F FLOPs per client (89 GFLOP at the
// main-path shape, n=2, 18,912 rows, D=384, F=1536) on the tensor cores,
// 0.09 ms at the bf16 peak; the bytes that must move (x in, out out, the
// weights) are a third of that.  The TPU kernel keeps the [rows, F] hidden
// activation in VMEM between its two products.
//
// bf16 with D and F multiples of 8 (every model on the fused route) runs
// mlp_fwd_sm90, three launches on the caller's stream:
//   1. ln_fwd (LN2 in f32, rounded to bf16), or nothing without LN;
//   2. fc1 on gemm_sm90.cuh's TMA + wgmma mainloop with the EPI_GELU
//      epilogue: hid = T(gelu_erf(acc + b1)), the erf of common.cuh, so
//      this path and gemm_kernel's agree.  With K = D (six 64-deep steps a
//      128 x 128 tile) the tile is bound by that epilogue, not by its
//      products;
//   3. fc2 on the mainloop (K = F) with the EPI_RES epilogue: acc + b2 and,
//      with s, the residual x + s_i * (acc + b2) in f32, rounded once.
// hid makes one round trip through device memory (116 MB written and read
// at the shape above, about 0.07 ms of HBM time beside a 0.09 ms FLOP
// bound).  Keeping it on chip would take a 128 x F f32 accumulator a block
// (or fc2 partial sums over fc1's column tiles) next to the fc1 tile, which
// does not fit the 232 registers of a consumer thread.
// float32, and bf16 off that grid (TMA needs 16-byte row strides), run
// mlp_fwd_impl: the same function on common.cuh's gemm_kernel.  The choice
// is made here, by dtype and shape alone (ops/fused_mlp.py uses_sm90
// mirrors it).
#include "gemm_sm90.cuh"

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

// The bf16 forward on the Hopper mainloop (steps 1-3 of the note above).
int mlp_fwd_sm90(int n, int B, int N, int D, int F, const bf16* x,
                 const float* s, const float* lns, const float* lnb,
                 const bf16* w1, const bf16* b1, const bf16* w2,
                 const bf16* b2, bf16* out, bf16* h, float* mean, float* rstd,
                 bf16* hid, cudaStream_t st) {
  const int M = B * N;
  int err;
  const bf16* a = x;  // fc1's input: LN2(x), or x when lns is NULL
  if (lns) {
    if ((err = ln_fwd<bf16>(x, lns, lnb, h, mean, rstd, (long long)n * M, M,
                            D, 1e-5f, st))) return err;
    a = h;
  }
  Sm90Args g1 = {};
  g1.out = hid; g1.bias = b1;
  if ((err = sm90_linear<SM90_EPI_GELU>(g1, a, w1, n, M, D, F, st)))
    return err;
  Sm90Args g2 = {};
  g2.out = out; g2.bias = b2;
  if (s) { g2.res = x; g2.s = s; g2.seq = N; }
  return sm90_linear<SM90_EPI_RES>(g2, hid, w2, n, M, F, D, st);
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
  if (sm90_takes(dtype, D, F))
    return mlp_fwd_sm90(
        n, B, N, D, F, static_cast<const bf16*>(x), s, lns, lnb,
        static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
        static_cast<bf16*>(out), static_cast<bf16*>(h), mean, rstd,
        static_cast<bf16*>(hid), st);
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

// Test only (no path calls it): out[i] = EPI(a[i] . w[i]) in bf16 on the
// Hopper mainloop for the two forward epilogues.  a [n, M, K], w [n, K, N],
// bias [n, N], out [n, M, N] (bf16); K and N multiples of 8.  epi = 0:
// EPI_GELU.  epi = 1: EPI_RES with the residual res [n, M, N] (bf16) and the
// row scales s [n * M / seq] (f32), or s = NULL for acc + bias alone.
extern "C" int fc_sm90_epilogue_test(int epi, int n, int M, int N, int K,
                                     int seq, const void* a, const void* w,
                                     const void* bias, const void* res,
                                     const float* s, void* out,
                                     cudaStream_t st) {
  Sm90Args g = {};
  g.out = out;
  g.bias = static_cast<const bf16*>(bias);
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* wp = static_cast<const bf16*>(w);
  if (epi == 0) return sm90_linear<SM90_EPI_GELU>(g, ap, wp, n, M, K, N, st);
  if (s) { g.res = static_cast<const bf16*>(res); g.s = s; g.seq = seq; }
  return sm90_linear<SM90_EPI_RES>(g, ap, wp, n, M, K, N, st);
}
