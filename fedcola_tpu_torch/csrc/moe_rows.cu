// The MoE layer's dispatch and combine (ops/moe_gemm.py): the row moves
// between token order and the routed experts' buffer, forward and backward.
//
// It replaces no TPU kernel: the JAX package has no MoE layer.  The
// buffer [cap, D] holds the groups' rows one after the other, each group
// padded to whole 128-row tiles, from the offsets poff[G + 1] (int32, on
// the device); pair_row[P] (int64, P = tokens * k) gives the buffer row of
// each token-expert pair, or cap where the pair's expert is not held here,
// and row_pair[cap] the pair of each row, or P on a padding row.  cap is
// the most rows any routing can ask; a routing fills about one row in
// eight of it (each token on 6 experts, about 0.77 of them held).  The
// host never learns the routing, so each grid is sized for the most and
// its warps walk the rows or tokens that exist: nothing past poff[G] is
// read or written, and a pair whose expert is not held reads no memory.
//
//   dispatch fwd  xp[r] = x[row_pair[r] / k] on a live row, 0 on a padding
//                 row of [0, poff[G]) (the grouped GEMM's weight
//                 gradients sum over a group's padding)
//   combine fwd   out[t] = sum_j w[t, j] * yp[pair_row[t k + j]], float32
//   dispatch bwd  dx[t] = T(sum_j dxp[pair_row[t k + j]])
//   combine bwd   dyp[r] = T(w[p] * dout[p / k]) on a live row (p its
//                 pair), 0 on a padding row; dw[t, j] = yp[row] . dout[t]
//
// The forward sums and the dispatch backward follow the plain versions'
// arithmetic op for op: slot by slot in slot order, the first slot's term
// taken as it is, each multiply and add rounded on its own (__fmul_rn,
// __fadd_rn: nothing contracted into an fma), an unheld slot's term the
// product of its weight with 0.0f, as the plain versions' zero row gives.
// So xp, the combine, dx and dyp equal the plain versions bit for bit; dw
// sums in another order, the same on every run.  Every output element has
// one writer: no atomics.
//
// What bounds it: bytes, at about one flop a byte.  An image step of the
// Moonlight cell (18,912 tokens, D 2048, about 15k live rows) moves about
// 0.7 GB a layer-step through the four kernels (1.1 GB with the remat
// recompute's second forward), against about 35 GB for the PyTorch passes
// over all cap rows that they replace.  What the design does about it: a
// warp owns a row or a token (a 2048-wide row is 256 16-byte vectors, 8 a
// lane), so every load and store is a 16-byte vector on neighbouring
// addresses; the per-token kernels keep a token's k slot rows and weights
// in the warp's lanes (k <= 32) and read them with shuffles; persistent
// blocks, one wave of them, walk the rows or tokens with a stride.
#include "common.cuh"

namespace {

constexpr int MR_WARPS = 8, MR_THREADS = 32 * MR_WARPS;
constexpr unsigned MR_FULL = 0xffffffffu;

inline int mr_sms() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks for `items` rows or tokens, a warp each: at most one wave.
inline int mr_blocks(long long items) {
  const long long want = (items + MR_WARPS - 1) / MR_WARPS;
  const long long most = 8LL * mr_sms();
  return (int)(want < most ? want : most);
}

__device__ __forceinline__ int mr_warp() {
  return blockIdx.x * MR_WARPS + (threadIdx.x >> 5);
}

__device__ __forceinline__ int mr_warps() { return gridDim.x * MR_WARPS; }

// 8 bf16 (16 bytes) to f32, exactly
__device__ __forceinline__ void load_bf16x8(const bf16* p, float* d) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

// 8 f32 rounded to nearest even, as a cast to bf16
__device__ __forceinline__ void store_bf16x8(bf16* p, const float* s) {
  __align__(16) __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ void load_f32x8(const float* p, float* d) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__device__ __forceinline__ void store_f32x8(float* p, const float* s) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(s[4], s[5], s[6], s[7]);
}

__device__ __forceinline__ void zero_row(bf16* row, int vecs, int lane) {
  for (int c = lane; c < vecs; c += 32)
    reinterpret_cast<uint4*>(row)[c] = make_uint4(0u, 0u, 0u, 0u);
}

// Rows [0, poff[G]) of xp: a live row its token's row of x, a padding row
// zeros.
__global__ void __launch_bounds__(MR_THREADS)
    moe_dispatch_fwd_kernel(const bf16* __restrict__ x,
                            const long long* __restrict__ row_pair,
                            const int* __restrict__ poff, int G, int k,
                            long long P, int D, bf16* __restrict__ xp) {
  const int lane = threadIdx.x & 31, vecs = D / 8, live = poff[G];
  for (int r = mr_warp(); r < live; r += mr_warps()) {
    const long long p = row_pair[r];
    bf16* dst = xp + (long long)r * D;
    if (p < P) {
      const uint4* src = reinterpret_cast<const uint4*>(x + (p / k) * D);
#pragma unroll 4
      for (int c = lane; c < vecs; c += 32)
        reinterpret_cast<uint4*>(dst)[c] = src[c];
    } else {
      zero_row(dst, vecs, lane);
    }
  }
}

// A token's slot sum over buffer rows, slot by slot, into f32:
// WEIGHTED: sum_j w_j * rows[row_j] (the combine), else sum_j rows[row_j]
// (the dispatch's backward).  Lane j < k holds slot j's row and weight;
// a lane's 8-element vectors step by 32, all lanes through every step so
// that the shuffles see the whole warp.
template <bool WEIGHTED, typename OutT>
__global__ void __launch_bounds__(MR_THREADS)
    moe_slot_sum_kernel(const bf16* __restrict__ rows,
                        const float* __restrict__ w,
                        const long long* __restrict__ pair_row, int tokens,
                        int k, int D, int cap, OutT* __restrict__ out) {
  const int lane = threadIdx.x & 31, vecs = D / 8;
  for (int t = mr_warp(); t < tokens; t += mr_warps()) {
    const long long p0 = (long long)t * k;
    int row = cap;
    float wt = 0.0f;
    if (lane < k) {
      row = (int)pair_row[p0 + lane];
      if (WEIGHTED) wt = w[p0 + lane];
    }
    OutT* o = out + (long long)t * D;
    for (int c0 = 0; c0 < vecs; c0 += 32) {
      const int c = c0 + lane;
      float acc[8];
      for (int j = 0; j < k; ++j) {
        const int r = __shfl_sync(MR_FULL, row, j);
        const float wj = WEIGHTED ? __shfl_sync(MR_FULL, wt, j) : 0.0f;
        if (c >= vecs) continue;
        float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (r < cap) load_bf16x8(rows + (long long)r * D + 8 * c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float term = WEIGHTED ? __fmul_rn(v[e], wj) : v[e];
          acc[e] = j ? __fadd_rn(acc[e], term) : term;
        }
      }
      if (c >= vecs) continue;
      if constexpr (std::is_same<OutT, float>::value)
        store_f32x8(o + 8 * c, acc);
      else
        store_bf16x8(o + 8 * c, acc);
    }
  }
}

// The combine's backward in one pass.  A warp takes a token's held slots
// in turn: the pair's row of dyp, T(w * dout[t]), and dw[t, j] =
// yp[row] . dout[t] (each lane's products in order, then the warp's
// butterfly: the same tree on every run), 0 for an unheld slot.  Then the
// padding rows of [0, poff[G]), zeros.
__global__ void __launch_bounds__(MR_THREADS)
    moe_combine_bwd_kernel(const float* __restrict__ dout,
                           const float* __restrict__ w,
                           const bf16* __restrict__ yp,
                           const long long* __restrict__ pair_row,
                           const long long* __restrict__ row_pair,
                           const int* __restrict__ poff, int G, int tokens,
                           int k, int D, int cap, bf16* __restrict__ dyp,
                           float* __restrict__ dw) {
  const int lane = threadIdx.x & 31, vecs = D / 8;
  const long long P = (long long)tokens * k;
  for (int t = mr_warp(); t < tokens; t += mr_warps()) {
    const float* d = dout + (long long)t * D;
    for (int j = 0; j < k; ++j) {
      const long long p = (long long)t * k + j;
      const int r = (int)pair_row[p];  // one address across the warp
      float part = 0.0f;
      if (r < cap) {
        const float wj = w[p];
        const bf16* y = yp + (long long)r * D;
        bf16* g = dyp + (long long)r * D;
#pragma unroll 4
        for (int c = lane; c < vecs; c += 32) {
          float dv[8], yv[8], gv[8];
          load_f32x8(d + 8 * c, dv);
          load_bf16x8(y + 8 * c, yv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            part = fmaf(yv[e], dv[e], part);
            gv[e] = __fmul_rn(dv[e], wj);
          }
          store_bf16x8(g + 8 * c, gv);
        }
      }
      part = warp_sum(part);  // r is the same in every lane
      if (lane == 0) dw[p] = part;
    }
  }
  const int live = poff[G];
  for (int r = mr_warp(); r < live; r += mr_warps())
    if (row_pair[r] >= P) zero_row(dyp + (long long)r * D, vecs, lane);
}

}  // namespace

// Dispatch forward: x [tokens, D] (bf16) -> rows [0, poff[G]) of xp
// [cap, D]; rows past poff[G] are not written.
extern "C" int fc_moe_dispatch_fwd(int tokens, int k, int D, int G, int cap,
                                   const void* x, const long long* row_pair,
                                   const int* poff, void* xp,
                                   cudaStream_t st) {
  if (cap < 1) return 0;
  moe_dispatch_fwd_kernel<<<mr_blocks(cap), MR_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), row_pair, poff, G, k,
      (long long)tokens * k, D, static_cast<bf16*>(xp));
  FC_CHECK();
  return 0;
}

// Combine forward: yp [cap, D] (bf16), w [tokens, k] (float32) -> out
// [tokens, D] (float32).
extern "C" int fc_moe_combine_fwd(int tokens, int k, int D, int cap,
                                  const void* yp, const float* w,
                                  const long long* pair_row, float* out,
                                  cudaStream_t st) {
  if (tokens < 1) return 0;
  moe_slot_sum_kernel<true, float><<<mr_blocks(tokens), MR_THREADS, 0, st>>>(
      static_cast<const bf16*>(yp), w, pair_row, tokens, k, D, cap, out);
  FC_CHECK();
  return 0;
}

// Dispatch backward: dxp [cap, D] (bf16) -> dx [tokens, D] (bf16).
extern "C" int fc_moe_dispatch_bwd(int tokens, int k, int D, int cap,
                                   const void* dxp,
                                   const long long* pair_row, void* dx,
                                   cudaStream_t st) {
  if (tokens < 1) return 0;
  moe_slot_sum_kernel<false, bf16><<<mr_blocks(tokens), MR_THREADS, 0, st>>>(
      static_cast<const bf16*>(dxp), nullptr, pair_row, tokens, k, D, cap,
      static_cast<bf16*>(dx));
  FC_CHECK();
  return 0;
}

// Combine backward: dout [tokens, D] (float32), w [tokens, k], the
// forward's yp [cap, D] (bf16) -> rows [0, poff[G]) of dyp [cap, D] (bf16)
// and dw [tokens, k] (float32).
extern "C" int fc_moe_combine_bwd(int tokens, int k, int D, int G, int cap,
                                  const float* dout, const float* w,
                                  const void* yp, const long long* pair_row,
                                  const long long* row_pair, const int* poff,
                                  void* dyp, float* dw, cudaStream_t st) {
  if (tokens < 1 && cap < 1) return 0;
  const long long items = tokens > cap ? tokens : cap;
  moe_combine_bwd_kernel<<<mr_blocks(items), MR_THREADS, 0, st>>>(
      dout, w, static_cast<const bf16*>(yp), pair_row, row_pair, poff, G,
      tokens, k, D, cap, static_cast<bf16*>(dyp), dw);
  FC_CHECK();
  return 0;
}
