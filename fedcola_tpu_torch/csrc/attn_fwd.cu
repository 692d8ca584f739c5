// Fused attention sublayer, forward:
//     out = [x + s_i *] proj( MHA( LN1(x) ) )      (+ saved P and head concat)
//
// Replaces the TPU kernels fedcola_tpu/ops/fused_attention.py:
// _make_fwd_save_kernel (via _fwd_save_call, training with residual=True)
// and _make_fwd_kernel (via _fwd_call, eval: no saves, no residual); the
// latter is the save=0 / s=NULL flag variant of this entry point.
//
// What bounds it on the H100: at the main-path shape (n=2 clients, B=96,
// N=197, D=384, H=6) the two projections are ~26 GFLOP of bf16 tensor-core
// work, the N x N attention core ~11 GFLOP, and the saved probabilities
// P [n,B,H,N,N] (89 MB in bf16) dominate the bytes; the roofline bound is
// the FLOPs.  This first version is simple: LN1 writes its normalised rows,
// the qkv and proj products run on the mma.sync GEMM of common.cuh, and the
// attention core runs on CUDA cores, one block per (client, item, head)
// holding that head's K and V (N <= 256) in shared memory.  Fusing the
// whole sublayer into one kernel with wgmma/TMA is later work.
#include "attn_core.cuh"

namespace {

template <typename T>
int attn_fwd_impl(int n, int B, int N, int D, int H, const void* x_,
                  const float* s, const float* lns, const float* lnb,
                  const void* wqkv, const void* bqkv, const void* wproj,
                  const void* bproj, void* out, void* P, void* cat_, void* h_,
                  float* mean, float* rstd, void* qkv_, int save,
                  cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* h = static_cast<T*>(h_);
  T* qkv = static_cast<T*>(qkv_);
  T* cat = static_cast<T*>(cat_);
  const int M = B * N;
  const long long rows = (long long)n * M;
  int err;
  if ((err = ln_fwd<T>(x, lns, lnb, h, mean, rstd, rows, M, D, 1e-5f, st))) return err;

  GemmArgs g = gemm_args(M, 3 * D, D);
  set_a_rows(g, h, D, (long long)M * D);
  set_b_rows(g, wqkv, 3 * D, 3LL * D * D);
  set_c(g, qkv, 3 * D, 3LL * M * D);
  g.bias = bqkv; g.sbiasc = 3 * D;
  if ((err = gemm<T, T>(g, n, st))) return err;

  if ((err = attn_core_fwd_packed<T>(qkv, save ? static_cast<T*>(P) : nullptr,
                                     cat, n * B, N, D, H, st))) return err;

  GemmArgs p = gemm_args(M, D, D);
  set_a_rows(p, cat, D, (long long)M * D);
  set_b_rows(p, wproj, D, (long long)D * D);
  set_c(p, out, D, (long long)M * D);
  p.bias = bproj; p.sbiasc = D;
  if (s) { p.res = x; p.s = s; p.seq = N; }
  return gemm<T, T>(p, n, st);
}

}  // namespace

// x [n,B,N,D] (T); s [n,B] f32 or NULL (no residual); lns/lnb [n,D] f32;
// wqkv [n,D,3D], bqkv [n,3D], wproj [n,D,D], bproj [n,D] (T).
// Outputs: out [n,B,N,D]; P [n,B,H,N,N] when save; cat [n,B,N,D].
// Scratch: h [n,B,N,D] (T), mean/rstd [n*B*N] f32, qkv [n,B,N,3D] (T).
// dtype: 0 = float32, 1 = bfloat16.  Returns the first CUDA error, or 0.
extern "C" int fc_attn_fwd(int dtype, int n, int B, int N, int D, int H,
                           const void* x, const float* s, const float* lns,
                           const float* lnb, const void* wqkv,
                           const void* bqkv, const void* wproj,
                           const void* bproj, void* out, void* P, void* cat,
                           void* h, float* mean, float* rstd, void* qkv,
                           int save, cudaStream_t st) {
  if (dtype == 1)
    return attn_fwd_impl<bf16>(n, B, N, D, H, x, s, lns, lnb, wqkv, bqkv,
                               wproj, bproj, out, P, cat, h, mean, rstd, qkv,
                               save, st);
  return attn_fwd_impl<float>(n, B, N, D, H, x, s, lns, lnb, wqkv, bqkv,
                              wproj, bproj, out, P, cat, h, mean, rstd, qkv,
                              save, st);
}
