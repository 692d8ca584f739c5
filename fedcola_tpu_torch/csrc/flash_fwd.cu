// Flash attention, forward:  o = softmax( T(q * scale) . k^T ) . v  for every
// (batch, head) pair, all leading axes merged into `pairs` (the client axis
// of a client-stacked group folds in as the JAX package's vmap does).
//
// Replaces the TPU kernel fedcola_tpu/ops/flash_attention.py: _fwd_kernel
// (via _fa_fwd): f32 scores of the pre-scaled q (rounded to q's dtype, as
// _fa_fwd rounds q * scale before the pallas_call), f32 softmax, P rounded
// to v's dtype, P.v accumulated in f32 and stored in q's dtype.  Used by
// the MAT blocks whose width is off the fused kernels' 128 grid (mome_tiny,
// D=192, H=3, hd=64) on both stacks and in central eval.
//
// What bounds it on the H100: at mome_tiny's training shape (576 pairs,
// N=197, hd=64) the 4*N^2*hd products per pair are ~5.7 GFLOP against
// ~58 MB of q, k, v and o in bf16, so the bytes bound it once the products
// run on tensor cores.  Two paths, chosen here by dtype and shape
// (ops/flash_attention.py uses_tensor_cores mirrors the choice):
//   bf16, hd in {16, 32, 64}: the per-head tensor-core forward of
//     attn_fwd_core.cuh (one block per pair, padded bf16 tiles, mma.sync,
//     two passes over the keys so that P is rounded after normalisation as
//     the TPU kernel rounds it);
//   float32, and bf16 at any other head_dim: the CUDA-core attention core
//     of attn_core.cuh (one warp per query row, K and V in shared memory as
//     f32).
// Each keeps the keys resident up to N = 256 and streams them past it
// (a block per 128 or 64 queries; ops/kernels.py streams_keys); the bf16
// streamed kernel is the Hopper one of attn_wgmma.cuh (TMA + wgmma).  The
// flash route sends N > 1024 to plain attention before any launch
// (ops/flash_attention.py), as the JAX package does.
#include "attn_fwd_core.cuh"

namespace {

template <typename T>
int flash_fwd_impl(int pairs, int N, int hd, float qscale, const void* q,
                   const void* k, const void* v, void* o, cudaStream_t st) {
  const CoreLayout L = {(long long)N * hd, hd, (long long)N * hd, hd};
  return attn_core_fwd<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                          static_cast<const T*>(v), static_cast<T*>(o),
                          nullptr, L, pairs, 1, N, hd, 1.0f, qscale, st);
}

}  // namespace

// q, k, v, o [pairs, N, hd] (T), contiguous; qscale = the softmax scale
// hd^-0.5 as a value of T (the TPU code multiplies q by scale cast to q's
// dtype).  hd <= 64, any N.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int fc_flash_fwd(int dtype, int pairs, int N, int hd, float qscale,
                            const void* q, const void* k, const void* v,
                            void* o, cudaStream_t st) {
  if (dtype == 1 && attn_fwd_head_takes(N, hd)) {
    const CoreLayout L = {(long long)N * hd, hd, (long long)N * hd, hd};
    return attn_fwd_head(static_cast<const bf16*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<bf16*>(o),
                         nullptr, L, pairs, 1, N, hd, 1.0f, qscale, st);
  }
  if (dtype == 1)
    return flash_fwd_impl<bf16>(pairs, N, hd, qscale, q, k, v, o, st);
  return flash_fwd_impl<float>(pairs, N, hd, qscale, q, k, v, o, st);
}

// Test only: the tensor-core forward core in the fused sublayer's packed
// layout, bf16: qkv [items, N, 3D] -> P [items, H, N, N] and cat [items, N,
// D], as attn_core_fwd_packed (tests/test_torch_port_cuda.py).
extern "C" int fc_attn_fwd_core_test(int items, int N, int D, int H,
                                     const void* qkv, void* P, void* cat,
                                     cudaStream_t st) {
  return attn_fwd_head_packed(static_cast<const bf16*>(qkv),
                              static_cast<bf16*>(P), static_cast<bf16*>(cat),
                              items, N, D, H, st);
}
