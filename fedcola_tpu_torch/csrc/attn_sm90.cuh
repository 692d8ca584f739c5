// What the bf16 attention sublayer's forward (attn_fwd.cu) and backward
// (attn_bwd.cu) share on their Hopper path: the choice of that path, and
// its first two launches, LN1 and the qkv product.
#pragma once

#include "gemm_sm90.cuh"

namespace {

// The choice of path: bf16 on the per-head tensor-core kernels' grid
// (head_dim 16, 32 or 64, which puts D on TMA's 8-element grid too), at
// every N: the head kernels keep the keys resident up to N = 256 and
// stream them past it.
inline bool attn_on_sm90(int dtype, int D, int H) {
  const int hd = D / H;
  return dtype == 1 && D % 8 == 0 && (hd == 16 || hd == 32 || hd == 64);
}

// h = T(LN1(x)) with its mean and rstd, then qkv = T(h . Wqkv + bqkv) on
// the TMA + wgmma mainloop, the bias added in the epilogue before rounding.
// x, h [n, M, D]; qkv [n, M, 3D].
inline int attn_ln_qkv_sm90(const bf16* x, const float* lns, const float* lnb,
                            const bf16* wqkv, const bf16* bqkv, bf16* h,
                            float* mean, float* rstd, bf16* qkv, int n, int M,
                            int D, cudaStream_t st) {
  int err;
  if ((err = ln_fwd<bf16>(x, lns, lnb, h, mean, rstd, (long long)n * M, M, D,
                          1e-5f, st))) return err;
  Sm90Args g = {};
  g.out = qkv; g.bias = bqkv;
  return sm90_linear<SM90_EPI_BF16>(g, h, wqkv, n, M, D, 3 * D, st);
}

}  // namespace
