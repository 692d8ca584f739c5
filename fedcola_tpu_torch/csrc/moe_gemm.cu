// The routed experts' grouped GEMM (ops/moe_gemm.py): every row of the
// expert buffer through its group's SiLU-GLU expert, forward and backward,
// on the Hopper mainloop of gemm_sm90.cuh (TMA ring, wgmma on two consumer
// warpgroups, one producer warp; its consume() and operand layouts).
//
// It replaces no TPU kernel: the JAX package has no MoE layer.  A group is
// one (client, held expert) pair; the buffer [cap, D] holds the groups'
// rows one after the other, each group padded with zero rows to whole
// 128-row tiles, from the offsets poff[G + 1] (int32, multiples of 128).
// The offsets are read on the device, by every block: the host never learns
// the routing, so the launch grid is sized for the most any routing can
// ask (cap rows) and each persistent block walks the tiles that exist.
//
//   forward   h = silu(x . gate_e) * (x . up_e)   one dual product (two
//                                                 accumulators), SiLU-mul
//                                                 epilogue; g and u kept
//                                                 (rounded) for training
//             y = h . down_e
//   backward  dh = dy . down_eᵀ, with dg = dh u silu'(g), du = dh silu(g)
//                                and h = silu(g) u in its epilogue
//             dx = dg . gate_eᵀ + du . up_eᵀ      two products, one
//                                                 accumulator
//             dW = xᵀ . dg, xᵀ . du, hᵀ . dy      per group, over its rows
//
// Row products (MOE_ROWS) tile the buffer's rows: a row tile lies in one
// group (the padding), whose weights its B tiles come from (the group is
// the third coordinate of the weights' 3-D maps).  Weight gradients
// (MOE_WGRAD) tile each group's [M, N] output and reduce over the group's
// rows, its padding adding zeros; a group with no rows writes zeros.  Every
// output element has one writer and a fixed order of accumulation, so the
// results repeat bit for bit.  bf16 operands, f32 accumulators; the
// epilogues round to bf16 (the weight gradients stay f32).
//
// What bounds it: at the traffic's shapes (D 2048, F 1408, about 1,800
// rows a group in an image step) the products are compute-bound (about
// 800 FLOP a byte of weights), so the design keeps the fused route's
// tensor-core mainloop; a text step's groups of about 360 rows give three
// row tiles a group, and the weight reads bound it.
#include "gemm_sm90.cuh"

namespace {

enum { MOE_ROWS = 0, MOE_WGRAD = 1 };
enum { MOE_EPI_SWIGLU = 0, MOE_EPI_OUT = 1, MOE_EPI_SWIGLU_BWD = 2,
       MOE_EPI_CHAIN = 3 };

struct MoeArgs {
  CUtensorMap a0, b0;  // the product (the first of two)
  CUtensorMap a1, b1;  // the second: SWIGLU's up, CHAIN's du . upᵀ
  const int* poff;     // [G + 1] the groups' first buffer rows
  int G;
  int M, N;            // WGRAD: a group's output; ROWS: N output columns
  int m_tiles, n_tiles;
  int k_tiles;         // ROWS: 64-deep K tiles
  int out_f32;         // OUT, CHAIN: float32 (1) or bf16 (0) output
  void* out;           // ROWS: [cap, N]; WGRAD: [G, M, N] float32
  bf16* h;             // SWIGLU, SWIGLU_BWD: T(silu(g) u) [cap, N]
  bf16* g_out;         // SWIGLU: T(g), T(u) [cap, N], or null (not kept)
  bf16* u_out;
  const bf16* g_in;    // SWIGLU_BWD: the kept T(g), T(u)
  const bf16* u_in;
  bf16* dg;            // SWIGLU_BWD: T(dg), T(du) [cap, N]
  bf16* du;
};

struct MoeTile {
  int m0, n0, grp, kb, iters;
};

template <int MODE>
__device__ __forceinline__ int moe_tiles(const MoeArgs& g) {
  if (MODE == MOE_ROWS) return (g.poff[g.G] / SM90_BM) * g.n_tiles;
  return g.G * g.m_tiles * g.n_tiles;
}

// Tile t: x (N tile) fastest.  ROWS: then the buffer's row tile, whose
// group is found from the offsets; WGRAD: then the output's row tile, then
// the group, whose rows are the reduction (kb: its first row).
template <int MODE>
__device__ __forceinline__ MoeTile moe_tile(const MoeArgs& g, int t) {
  MoeTile u;
  const int rest = t / g.n_tiles;
  u.n0 = (t % g.n_tiles) * SM90_BN;
  if (MODE == MOE_ROWS) {
    u.m0 = rest * SM90_BM;
    int grp = 0;
    while (grp + 1 < g.G && g.poff[grp + 1] <= u.m0) ++grp;
    u.grp = grp;
    u.kb = 0;
    u.iters = g.k_tiles;
  } else {
    u.m0 = (rest % g.m_tiles) * SM90_BM;
    u.grp = rest / g.m_tiles;
    u.kb = g.poff[u.grp];
    u.iters = (g.poff[u.grp + 1] - u.kb) / SM90_BK;
  }
  return u;
}

__device__ __forceinline__ float silu_f(float v) {
  return v / (1.0f + expf(-v));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// TA = MODE: the row products' A is the buffer, K-major; the weight
// gradients' A is the buffer transposed, MN-major.  TB0 / TB1: the B
// operands of the two products are MN-major (W as stored, [in, out]) or
// K-major (Wᵀ).
template <int MODE, int TB0, int TB1, int EPI>
__global__ void __launch_bounds__(SM90_THREADS, 1)
moe_gemm_kernel(const __grid_constant__ MoeArgs g) {
  constexpr int TA = MODE == MOE_WGRAD;
  constexpr bool kTwo = EPI == MOE_EPI_SWIGLU || EPI == MOE_EPI_CHAIN;
  constexpr int kProducts = kTwo ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + SM90_STAGES * SM90_STAGE_BYTES;
  const uint32_t empty = full + 8 * SM90_STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SM90_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int total = moe_tiles<MODE>(g);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const MoeTile u = moe_tile<MODE>(g, t);
        for (int i = 0; i < kProducts * u.iters; ++i, ++it) {
          const int st = it % SM90_STAGES;
          if (it >= SM90_STAGES)
            mbar_wait(empty + 8 * st, ((it / SM90_STAGES) - 1) & 1);
          const uint32_t fb = full + 8 * st;
          mbar_expect_tx(fb, SM90_STAGE_BYTES);
          const uint32_t a = ring + st * SM90_STAGE_BYTES;
          const int k0 = u.kb + (i % u.iters) * SM90_BK;
          const bool second = i >= u.iters;
          if (MODE == MOE_ROWS) {
            load_operand<0>(a, second ? &g.a1 : &g.a0, fb, u.m0, k0, 0);
            if (second)
              load_operand<TB1>(a + SM90_TILE_BYTES, &g.b1, fb, u.n0, k0,
                                u.grp);
            else
              load_operand<TB0>(a + SM90_TILE_BYTES, &g.b0, fb, u.n0, k0,
                                u.grp);
          } else {
            load_operand<1>(a, &g.a0, fb, u.m0, k0, 0);
            load_operand<1>(a + SM90_TILE_BYTES, &g.b0, fb, u.n0, k0, 0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const MoeTile u = moe_tile<MODE>(g, t);
    const int row0 = u.m0 + 64 * wg + 16 * warp + (lane >> 2);
    const int col0 = u.n0 + 2 * (lane & 3);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    consume<TA, TB0>(acc, ring, full, empty, it, it + u.iters, wg, lane);
    it += u.iters;
    if constexpr (EPI == MOE_EPI_CHAIN) {
      consume<0, TB1>(acc, ring, full, empty, it, it + u.iters, wg, lane);
      it += u.iters;
    }
    const int rows = MODE == MOE_WGRAD ? g.M : 0x7fffffff;
    const long long base =
        MODE == MOE_WGRAD ? (long long)u.grp * g.M * g.N : 0;

    if constexpr (EPI == MOE_EPI_SWIGLU) {
      float acc2[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc2[i] = 0.0f;
      consume<0, TB1>(acc2, ring, full, empty, it, it + u.iters, wg, lane);
      it += u.iters;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + 8 * hh, col = col0 + 8 * j;
          if (col >= g.N) continue;
          const float g0 = acc[4 * j + 2 * hh], g1 = acc[4 * j + 2 * hh + 1];
          const float u0 = acc2[4 * j + 2 * hh], u1 = acc2[4 * j + 2 * hh + 1];
          const long long off = (long long)r * g.N + col;
          if (g.g_out) {
            store_bf16x2(g.g_out + off, g0, g1);
            store_bf16x2(g.u_out + off, u0, u1);
          }
          store_bf16x2(g.h + off, silu_f(g0) * u0, silu_f(g1) * u1);
        }
    } else if constexpr (EPI == MOE_EPI_SWIGLU_BWD) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + 8 * hh, col = col0 + 8 * j;
          if (col >= g.N) continue;
          const long long off = (long long)r * g.N + col;
          const float2 gv =
              unpack_bf16x2(*reinterpret_cast<const uint32_t*>(g.g_in + off));
          const float2 uv =
              unpack_bf16x2(*reinterpret_cast<const uint32_t*>(g.u_in + off));
          float dgv[2], duv[2], hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gg = e ? gv.y : gv.x, uu = e ? uv.y : uv.x;
            const float dh = acc[4 * j + 2 * hh + e];
            const float sig = 1.0f / (1.0f + expf(-gg));
            dgv[e] = dh * uu * sig * (1.0f + gg * (1.0f - sig));
            duv[e] = dh * gg * sig;
            hv[e] = gg * sig * uu;
          }
          store_bf16x2(g.dg + off, dgv[0], dgv[1]);
          store_bf16x2(g.du + off, duv[0], duv[1]);
          store_bf16x2(g.h + off, hv[0], hv[1]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + 8 * hh, col = col0 + 8 * j;
          if (r >= rows || col >= g.N) continue;
          const long long off = base + (long long)r * g.N + col;
          const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
          if (g.out_f32)
            *reinterpret_cast<float2*>(static_cast<float*>(g.out) + off) =
                make_float2(v0, v1);
          else
            store_bf16x2(static_cast<bf16*>(g.out) + off, v0, v1);
        }
    }
  }
}

template <int MODE, int TB0, int TB1, int EPI>
int moe_gemm(const MoeArgs& g, long long max_tiles, cudaStream_t st) {
  auto kern = moe_gemm_kernel<MODE, TB0, TB1, EPI>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SM90_SMEM);
  FC_CHECK();
  const int blocks = (int)(max_tiles < sm_count() ? max_tiles : sm_count());
  if (blocks < 1) return 0;
  kern<<<blocks, SM90_THREADS, SM90_SMEM, st>>>(g);
  FC_CHECK();
  return 0;
}

// Maps over a row-major buffer [rows, cols] (one "client") and over the
// groups' weights [G, rows, cols].
inline int buffer_map(CUtensorMap* m, const void* p, int rows, int cols) {
  return make_map(m, p, 1, rows, cols);
}

}  // namespace

// Forward.  xp [cap, D] (bf16, zero padding rows), wg / wu [G, D, F],
// wd [G, F, D] (bf16), poff [G + 1] (int32, on the device).  Outputs
// y [cap, D] (float32 when out_f32, else bf16), the scratch h [cap, F]
// (bf16) and, for training, g and u [cap, F] (bf16; null in evaluation).
// Rows past poff[G] are not written.
extern "C" int fc_moe_gemm_fwd(int G, int cap, int D, int F, int out_f32,
                               const void* xp, const void* wg,
                               const void* wu, const void* wd,
                               const int* poff, void* y, void* h, void* g_,
                               void* u_, cudaStream_t st) {
  int err;
  MoeArgs a = {};
  if ((err = buffer_map(&a.a0, xp, cap, D)) ||
      (err = make_map(&a.b0, wg, G, D, F)) ||
      (err = make_map(&a.b1, wu, G, D, F)))
    return err;
  a.a1 = a.a0;
  a.poff = poff;
  a.G = G;
  a.N = F;
  a.n_tiles = ceil_div(F, SM90_BN);
  a.k_tiles = ceil_div(D, SM90_BK);
  a.h = static_cast<bf16*>(h);
  a.g_out = static_cast<bf16*>(g_);
  a.u_out = static_cast<bf16*>(u_);
  if ((err = moe_gemm<MOE_ROWS, 1, 1, MOE_EPI_SWIGLU>(
           a, (long long)(cap / SM90_BM) * a.n_tiles, st)))
    return err;

  MoeArgs b = {};
  if ((err = buffer_map(&b.a0, h, cap, F)) ||
      (err = make_map(&b.b0, wd, G, F, D)))
    return err;
  b.poff = poff;
  b.G = G;
  b.N = D;
  b.n_tiles = ceil_div(D, SM90_BN);
  b.k_tiles = ceil_div(F, SM90_BK);
  b.out = y;
  b.out_f32 = out_f32;
  return moe_gemm<MOE_ROWS, 1, 0, MOE_EPI_OUT>(
      b, (long long)(cap / SM90_BM) * b.n_tiles, st);
}

// Backward.  dy [cap, D], the forward's xp, weights and kept g, u (bf16),
// poff.  Outputs dx [cap, D], the scratch dg, du, h [cap, F] (bf16) and
// the weight gradients dwg, dwu [G, D, F] and dwd [G, F, D] (float32).
extern "C" int fc_moe_gemm_bwd(int G, int cap, int D, int F, const void* dy,
                               const void* xp, const void* wg,
                               const void* wu, const void* wd,
                               const void* g_, const void* u_,
                               const int* poff, void* dx, void* dg,
                               void* du, void* h, float* dwg, float* dwu,
                               float* dwd, cudaStream_t st) {
  int err;
  const long long row_tiles = cap / SM90_BM;
  // dh = dy . wdᵀ (wd [G, F, D]: K-major), the SiLU-mul backward after it
  MoeArgs a = {};
  if ((err = buffer_map(&a.a0, dy, cap, D)) ||
      (err = make_map(&a.b0, wd, G, F, D)))
    return err;
  a.poff = poff;
  a.G = G;
  a.N = F;
  a.n_tiles = ceil_div(F, SM90_BN);
  a.k_tiles = ceil_div(D, SM90_BK);
  a.g_in = static_cast<const bf16*>(g_);
  a.u_in = static_cast<const bf16*>(u_);
  a.dg = static_cast<bf16*>(dg);
  a.du = static_cast<bf16*>(du);
  a.h = static_cast<bf16*>(h);
  if ((err = moe_gemm<MOE_ROWS, 0, 0, MOE_EPI_SWIGLU_BWD>(
           a, row_tiles * a.n_tiles, st)))
    return err;

  // dx = dg . wgᵀ + du . wuᵀ (wg, wu [G, D, F]: K-major)
  MoeArgs b = {};
  if ((err = buffer_map(&b.a0, dg, cap, F)) ||
      (err = make_map(&b.b0, wg, G, D, F)) ||
      (err = buffer_map(&b.a1, du, cap, F)) ||
      (err = make_map(&b.b1, wu, G, D, F)))
    return err;
  b.poff = poff;
  b.G = G;
  b.N = D;
  b.n_tiles = ceil_div(D, SM90_BN);
  b.k_tiles = ceil_div(F, SM90_BK);
  b.out = dx;
  if ((err = moe_gemm<MOE_ROWS, 0, 0, MOE_EPI_CHAIN>(
           b, row_tiles * b.n_tiles, st)))
    return err;

  // each group's weight gradients over its rows: Aᵀ . B, both MN-major
  const struct {
    const void *a, *b;
    int M, N;
    float* out;
  } wgrads[3] = {{h, dy, F, D, dwd}, {xp, dg, D, F, dwg}, {xp, du, D, F, dwu}};
  for (const auto& w : wgrads) {
    MoeArgs c = {};
    if ((err = buffer_map(&c.a0, w.a, cap, w.M)) ||
        (err = buffer_map(&c.b0, w.b, cap, w.N)))
      return err;
    c.poff = poff;
    c.G = G;
    c.M = w.M;
    c.N = w.N;
    c.m_tiles = ceil_div(w.M, SM90_BM);
    c.n_tiles = ceil_div(w.N, SM90_BN);
    c.out = w.out;
    c.out_f32 = 1;
    if ((err = moe_gemm<MOE_WGRAD, 1, 0, MOE_EPI_OUT>(
             c, (long long)G * c.m_tiles * c.n_tiles, st)))
      return err;
  }
  return 0;
}
