// Fused attention sublayer, forward:
//     out = [x + s_i *] proj( MHA( LN1(x) ) )      (+ saved P and head concat)
//
// Replaces the TPU kernels fedcola_tpu/ops/fused_attention.py:
// _make_fwd_save_kernel (via _fwd_save_call, training with residual=True)
// and _make_fwd_kernel (via _fwd_call, eval: no saves, no residual); the
// latter is the save=0 / s=NULL flag variant of this entry point.
//
// What bounds it on the H100: at the main-path shape (n=2 clients, B=96,
// N=197, D=384, H=6) the qkv and proj products are 45 GFLOP of bf16
// tensor-core work and the N x N attention core 11 GFLOP, 0.06 ms at the
// bf16 peak; the saved probabilities P [n,B,H,N,N] (89 MB in bf16) dominate
// the bytes, 0.04 ms of HBM time.  The TPU kernel holds an item's qkv and
// its heads' scores in VMEM; here the pieces are launches on the caller's
// stream and qkv and cat make one round trip through device memory.
//
// bf16 with head_dim 16, 32 or 64 (every model on the fused route), at
// every N, runs attn_fwd_sm90, four launches:
//   1. ln_fwd (LN1 in f32, rounded to bf16) and
//   2. qkv = T(h . Wqkv + bqkv) on gemm_sm90.cuh's TMA + wgmma mainloop:
//      the backward's first two launches (attn_sm90.cuh holds them for both);
//   3. the per-head forward of attn_fwd_core.cuh in the packed layout, one
//      block per (item, head) on mma.sync (per (item, head, 128 queries),
//      keys streamed, past N = 256): scores and softmax in f32, P rounded
//      after normalisation (two passes over the keys), written when
//      saving, cat = T(P . V).  The P stores bound this step when saving;
//   4. proj on the mainloop with the EPI_RES epilogue: acc + bproj and,
//      with s, x + s_i * (acc + bproj) in f32, rounded once.
// float32, and bf16 off that grid, run attn_fwd_impl: the same function on
// common.cuh's gemm_kernel with the attention core on CUDA cores
// (attn_core.cuh: one block per (item, head), one warp per query row; past
// N = 256 one block per (item, head, 64 queries), keys streamed).  The
// choice is made here, by dtype and shape alone (ops/fused_attention.py
// uses_sm90 mirrors it).
#include "attn_fwd_core.cuh"
#include "attn_sm90.cuh"

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

// The bf16 forward on the Hopper mainloop and the tensor-core head kernel
// (steps 1-4 of the note above).
int attn_fwd_sm90(int n, int B, int N, int D, int H, const bf16* x,
                  const float* s, const float* lns, const float* lnb,
                  const bf16* wqkv, const bf16* bqkv, const bf16* wproj,
                  const bf16* bproj, bf16* out, bf16* P, bf16* cat, bf16* h,
                  float* mean, float* rstd, bf16* qkv, int save,
                  cudaStream_t st) {
  const int M = B * N;
  int err;
  if ((err = attn_ln_qkv_sm90(x, lns, lnb, wqkv, bqkv, h, mean, rstd, qkv, n,
                              M, D, st))) return err;
  if ((err = attn_fwd_head_packed(qkv, save ? P : nullptr, cat, n * B, N, D,
                                  H, st))) return err;
  Sm90Args p = {};
  p.out = out; p.bias = bproj;
  if (s) { p.res = x; p.s = s; p.seq = N; }
  return sm90_linear<SM90_EPI_RES>(p, cat, wproj, n, M, D, D, st);
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
  if (attn_on_sm90(dtype, D, H))
    return attn_fwd_sm90(
        n, B, N, D, H, static_cast<const bf16*>(x), s, lns, lnb,
        static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
        static_cast<const bf16*>(wproj), static_cast<const bf16*>(bproj),
        static_cast<bf16*>(out), static_cast<bf16*>(P),
        static_cast<bf16*>(cat), static_cast<bf16*>(h), mean, rstd,
        static_cast<bf16*>(qkv), save, st);
  if (dtype == 1)
    return attn_fwd_impl<bf16>(n, B, N, D, H, x, s, lns, lnb, wqkv, bqkv,
                               wproj, bproj, out, P, cat, h, mean, rstd, qkv,
                               save, st);
  return attn_fwd_impl<float>(n, B, N, D, H, x, s, lns, lnb, wqkv, bqkv,
                              wproj, bproj, out, P, cat, h, mean, rstd, qkv,
                              save, st);
}
