// A bf16 GEMM mainloop for Hopper (sm_90a): TMA loads into a ring of
// shared-memory stages, wgmma on two consumer warpgroups, one producer
// warp.  Every D-wide product of the bf16 fused route runs on it: the
// forwards (mlp_fwd.cu: fc1 with the GELU epilogue, fc2 with the residual
// join; attn_fwd.cu: qkv and proj) and the backwards (mlp_bwd.cu,
// attn_bwd.cu).  float32, and shapes off TMA's grid, stay on common.cuh's
// gemm_kernel.
//
// Block shape.  One persistent block per SM walks 128 x 128 output tiles
// (of one client, and of one split range of K where the caller splits the
// reduction): warpgroup w (w = 0, 1) owns rows 64w..64w+63 and issues
// wgmma.m64n128k16 (bf16 in, f32 accumulators in registers: 64 a thread).
// 128 columns keep two accumulators (the dual product below) within the
// 232 registers a consumer thread gets, and give 128 x 128 x 64 products
// per 32 KB stage (64 FLOP per byte loaded from L2).  Warpgroup 2 is the
// producer: `setmaxnreg` drops it to 40 registers and raises the consumers
// to 232 (128*40 + 256*232 = 384*168, the launch budget).  One of its
// threads issues the TMA loads; the others idle.
//
// Pipeline.  SM90_STAGES stages of A (128 x 64) and B (64 x 128) tiles in
// dynamic shared memory, each with a `full` mbarrier (the producer's
// expect_tx; TMA completes it with the bytes) and an `empty` one (one
// arrival per consumer warp once its wgmma group has retired; one group
// stays in flight while the next is issued).  A tile walks K in 64-deep
// steps; the dual product runs two such mainloops, one after the other,
// through the same ring into two accumulators.  The ring runs on from one
// tile to the next, so the producer loads the next tile while the
// consumers run the epilogue.
//
// Operand layouts.  Every TMA box is 64 x 64 bf16 (8 KB) under the
// 128-byte swizzle, so one box row is one swizzle row:
//   K-major  (the operand's K axis is contiguous in memory): a 128-row tile
//            is two boxes one above the other, [128][64] with 128-byte rows.
//            wgmma descriptor: SBO = 1024 B (the next 8-row group), LBO
//            unused; the k16 step advances the start address by 32 B.
//   MN-major (M or N contiguous: W in x.W, both operands of A^T.B): a tile
//            is two boxes side by side, each [64 k-rows][64 mn], so
//            LBO = 8192 B (the next 64 columns of M or N), SBO = 1024 B
//            (the next 8 k-rows); the k16 step advances by 16 rows = 2048 B,
//            and the wgmma transpose bit is set.
// Every tensor map is 3-D, [clients, rows, cols]: a tile that runs past a
// client's last row reads TMA's zero fill, never the next client's rows.
// The row stride must be a multiple of 16 bytes, so the inner dimension
// of every operand must be a multiple of 8 (the callers choose
// common.cuh's gemm_kernel otherwise).
//
// Epilogues read the accumulator fragments (row = 16*warp + lane/4 [+8],
// col = 8j + 2*(lane%4) [+1]) and store to (row, col) themselves, masking
// the ragged M edge and whole pairs past N, which is even on every path
// (the residual's read with them):
//   EPI_F32 / EPI_BF16  the sum, as f32 or (after an optional bias) as bf16;
//   EPI_GELU            T(gelu_erf(acc + bias)), the MLP's hidden activation;
//   EPI_RES             T(acc + bias), or T(x + s[row / seq] * (acc + bias))
//                       in f32 with one rounding where s is given: the
//                       sublayers' residual join, as gemm_kernel's tail;
//   EPI_GELU_BWD        the dual product's GELU backward (mlp_bwd.cu).
// A tile with few K steps (K = D = 384 is six) is bound by its epilogue,
// the erf above all: the ring runs on into the next tile's loads meanwhile,
// but both consumer warpgroups leave the tensor cores idle for its length.
#pragma once

#include <cuda.h>
#include "common.cuh"

namespace {

constexpr int SM90_BM = 128, SM90_BN = 128, SM90_BK = 64;
constexpr int SM90_STAGES = 6;
constexpr int SM90_THREADS = 384;      // 2 consumer warpgroups + producer
constexpr int SM90_BOX_BYTES = 64 * 64 * 2;
constexpr int SM90_TILE_BYTES = 2 * SM90_BOX_BYTES;   // A or B of a stage
constexpr int SM90_STAGE_BYTES = 2 * SM90_TILE_BYTES;
constexpr int SM90_RED_FLOATS = 8 * SM90_BN;         // per-warp column sums
constexpr int SM90_SMEM = 1024 /* alignment slack */ +
                          SM90_STAGES * SM90_STAGE_BYTES +
                          2 * SM90_STAGES * 8 + SM90_RED_FLOATS * 4;

enum { SM90_EPI_F32 = 0, SM90_EPI_BF16 = 1, SM90_EPI_GELU_BWD = 2,
       SM90_EPI_GELU = 3, SM90_EPI_RES = 4 };

// Everything a launch needs; passed by value as a __grid_constant__ so the
// tensor maps live in parameter space, where TMA can read them.
struct Sm90Args {
  CUtensorMap a0, b0;  // the product (the first of the two for the dual)
  CUtensorMap a1, b1;  // the dual product's second
  int M, N;            // output rows and columns of one client
  int m_tiles, n_tiles, tiles;  // set by sm90_gemm
  int k_tiles;         // 64-deep K tiles of the whole reduction
  int tiles_per_split; // K tiles of one split range
  int splits;          // a tile's z index = client * splits + split
  void* out;           // all but EPI_GELU_BWD: out[split][client][M][N]
  long long out_client, out_split;  // element strides (row stride is N)
  const bf16* bias;    // [clients, N]: EPI_GELU_BWD's and EPI_GELU's b1;
                       // EPI_BF16 and EPI_RES add it before rounding when
                       // not null
  const bf16* res;     // EPI_RES with s: the residual x, laid out like out
  const float* s;      // EPI_RES: row scale s[(client * M + row) / seq], or
  int seq;             // null (then no residual and seq is not read)
  bf16* hg;            // T(GELU(pre))        [clients, M, N]
  bf16* dprec;         // T(dh * GELU'(pre))  [clients, M, N]
  float* colsum;       // f32 column sums of dpre per row tile
                       // [ceil(M/128), clients, N]
  int clients;
};

// ------------------------------------------------------------ host side --

using EncodeTiledFn = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over a row-major bf16 tensor [clients, rows, cols], 64 x 64
// boxes, 128-byte swizzle, zero fill out of bounds.
inline int make_map(CUtensorMap* m, const void* ptr, int clients,
                    long long rows, long long cols) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)clients};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * 2),
                                 (cuuint64_t)(rows * cols * 2)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------- device side --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.  A phase that
// never completes (a lost arrival or a wrong byte count) traps after about
// ten seconds instead of hanging the card: the launch then reports an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// TMA: one 64 x 64 box at (col, row, client) into shared memory, completing
// `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int client) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(client)
      : "memory");
}

// One operand tile of a stage: 128 along M (or N) by 64 along K.
template <int MN_MAJOR>
__device__ __forceinline__ void load_operand(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int mn0, int k0,
                                             int client) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (MN_MAJOR)
      tma_load(dst + i * SM90_BOX_BYTES, map, bar, mn0 + 64 * i, k0, client);
    else
      tma_load(dst + i * SM90_BOX_BYTES, map, bar, k0, mn0 + 64 * i, client);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// The descriptor of k16 step kk of a 64-deep tile at `tile`.
template <int MN_MAJOR>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int kk) {
  return MN_MAJOR ? sw128_desc(tile + kk * 2048, SM90_BOX_BYTES, 1024)
                  : sw128_desc(tile + kk * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define FC_ACC8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] += A(64 x 16) . B(16 x 128); TA / TB: operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, %66, %67;\n"
      "}\n"
      : FC_ACC8(0), FC_ACC8(8), FC_ACC8(16), FC_ACC8(24), FC_ACC8(32),
        FC_ACC8(40), FC_ACC8(48), FC_ACC8(56)
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}
#undef FC_ACC8

// Consume ring iterations [it0, it1) into acc.  Warpgroup wg reads box wg
// of the A tile (its 64 rows) and all of the B tile.  One wgmma group stays
// in flight while the next is issued; a stage goes back to the producer
// once the group that read it has retired.
template <int TA, int TB>
__device__ __forceinline__ void consume(float (&acc)[64], uint32_t ring,
                                        uint32_t full, uint32_t empty,
                                        int it0, int it1, int wg, int lane) {
  for (int it = it0; it < it1; ++it) {
    const int st = it % SM90_STAGES;
    mbar_wait(full + 8 * st, (it / SM90_STAGES) & 1);
    const uint32_t a = ring + st * SM90_STAGE_BYTES + wg * SM90_BOX_BYTES;
    const uint32_t b = ring + st * SM90_STAGE_BYTES + SM90_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SM90_BK / 16; ++kk)
      wgmma_m64n128k16<TA, TB>(acc, operand_desc<TA>(a, kk),
                               operand_desc<TB>(b, kk));
    wgmma_commit();
    wgmma_wait<1>();
    if (it > it0 && lane == 0)
      mbar_arrive(empty + 8 * ((it - 1) % SM90_STAGES));
  }
  wgmma_wait<0>();
  if (it1 > it0 && lane == 0)
    mbar_arrive(empty + 8 * ((it1 - 1) % SM90_STAGES));
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Tile t of a launch: x (N tile) fastest, then y (M tile), then z =
// client * splits + split, the order a plain grid would run them in.
struct Sm90Tile {
  int m0, n0, c, split, kb, iters, m_tile;
};

__device__ __forceinline__ Sm90Tile sm90_tile(const Sm90Args& g, int t) {
  Sm90Tile u;
  const int nx = t % g.n_tiles, rest = t / g.n_tiles;
  u.m_tile = rest % g.m_tiles;
  const int z = rest / g.m_tiles;
  u.c = z / g.splits;
  u.split = z % g.splits;
  u.m0 = u.m_tile * SM90_BM;
  u.n0 = nx * SM90_BN;
  u.kb = u.split * g.tiles_per_split;
  u.iters = min(u.kb + g.tiles_per_split, g.k_tiles) - u.kb;  // per product
  return u;
}

// C(c) = A(c) . B(c) over the K tiles of each tile's split, then the
// epilogue EPI.  TA, TB0: operand MN-major; TB1 is the dual product's
// second B (the dual's A operands are both K-major).  Persistent: block b
// takes tiles b, b + gridDim.x, ...; the ring's iteration count runs on
// across tiles, so the producer fills the next tile's stages while the
// consumers run this tile's epilogue.
template <int TA, int TB0, int TB1, int EPI>
__global__ void __launch_bounds__(SM90_THREADS, 1)
sm90_gemm_kernel(const __grid_constant__ Sm90Args g) {
  constexpr bool kDual = EPI == SM90_EPI_GELU_BWD;
  constexpr int kProducts = kDual ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + SM90_STAGES * SM90_STAGE_BYTES;
  const uint32_t empty = full + 8 * SM90_STAGES;
  float* red = reinterpret_cast<float*>(smem_raw + (empty - raw) +
                                        8 * SM90_STAGES);

  if (threadIdx.x == 0) {
    for (int s = 0; s < SM90_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const Sm90Tile u = sm90_tile(g, t);
        for (int i = 0; i < kProducts * u.iters; ++i, ++it) {
          const int st = it % SM90_STAGES;
          if (it >= SM90_STAGES)
            mbar_wait(empty + 8 * st, ((it / SM90_STAGES) - 1) & 1);
          const uint32_t fb = full + 8 * st;
          mbar_expect_tx(fb, SM90_STAGE_BYTES);
          const uint32_t a = ring + st * SM90_STAGE_BYTES;
          const int k0 = (u.kb + i % u.iters) * SM90_BK;
          if (i < u.iters) {
            load_operand<TA>(a, &g.a0, fb, u.m0, k0, u.c);
            load_operand<TB0>(a + SM90_TILE_BYTES, &g.b0, fb, u.n0, k0, u.c);
          } else {
            load_operand<0>(a, &g.a1, fb, u.m0, k0, u.c);
            load_operand<TB1>(a + SM90_TILE_BYTES, &g.b1, fb, u.n0, k0, u.c);
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int it = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const Sm90Tile u = sm90_tile(g, t);
      const int row0 = u.m0 + 64 * wg + 16 * warp + (lane >> 2);
      const int col0 = u.n0 + 2 * (lane & 3);
      // What the epilogue reads (the thread's bias pairs, its residual
      // pairs and row scales) is asked for before the mainloop, so that it
      // arrives under the products: eight consumer warps an SM hide no
      // load latency in the epilogue itself.  N is even on every path, so
      // a pair never straddles the edge.
      constexpr bool kBias = EPI == SM90_EPI_BF16 || EPI == SM90_EPI_GELU ||
                             EPI == SM90_EPI_RES;
      constexpr bool kRes = EPI == SM90_EPI_RES;
      const long long base = (long long)u.split * g.out_split +
                             (long long)u.c * g.out_client;
      uint32_t bpk[kBias ? 16 : 1], xpk[kRes ? 32 : 1];
      float sv[2] = {0.0f, 0.0f};
      if constexpr (kBias) {
        if (g.bias) {
          const bf16* bias = g.bias + (long long)u.c * g.N;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = col0 + 8 * j;
            bpk[j] = col < g.N
                         ? *reinterpret_cast<const uint32_t*>(bias + col)
                         : 0u;
          }
        }
      }
      if constexpr (kRes) {
        if (g.s) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 8 * h;
            if (r < g.M) sv[h] = g.s[((long long)u.c * g.M + r) / g.seq];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int col = col0 + 8 * j;
              xpk[2 * j + h] =
                  (r < g.M && col < g.N)
                      ? *reinterpret_cast<const uint32_t*>(
                            g.res + base + (long long)r * g.N + col)
                      : 0u;
            }
          }
        }
      }

      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      consume<TA, TB0>(acc, ring, full, empty, it, it + u.iters, wg, lane);
      it += u.iters;

      if constexpr (!kDual) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 8 * h, col = col0 + 8 * j;
            if (r >= g.M || col >= g.N) continue;
            float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            if constexpr (kBias) {
              if (g.bias) {
                const float2 b = unpack_bf16x2(bpk[j]);
                v0 += b.x;
                v1 += b.y;
              }
            }
            if constexpr (EPI == SM90_EPI_GELU) {
              v0 = gelu_erf(v0);
              v1 = gelu_erf(v1);
            }
            if constexpr (kRes) {
              if (g.s) {
                const float2 x = unpack_bf16x2(xpk[2 * j + h]);
                v0 = x.x + sv[h] * v0;
                v1 = x.y + sv[h] * v1;
              }
            }
            const long long off = base + (long long)r * g.N + col;
            if (EPI == SM90_EPI_F32) {
              *reinterpret_cast<float2*>(static_cast<float*>(g.out) + off) =
                  make_float2(v0, v1);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(g.out) +
                                                 off) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
      } else {
        float acc2[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc2[i] = 0.0f;
        consume<0, TB1>(acc2, ring, full, empty, it, it + u.iters, wg, lane);
        it += u.iters;
        // pre = acc + b1;  hg = T(GELU(pre));  dpre = dh * GELU'(pre), as
        // gelu_bwd_kernel computes them; column sums of dpre over the
        // tile's rows in a fixed order: the thread's two rows, the eight
        // row groups of the warp by shuffles, the eight warps in red[].
        const bf16* bias = g.bias + (long long)u.c * g.N;
        const long long cbase = (long long)u.c * g.M * g.N;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = col0 + 8 * j;
          float sum[2] = {0.0f, 0.0f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 8 * h;
            float d[2], hgv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = acc[4 * j + 2 * h + e] +
                              (col + e < g.N ? to_f(bias[col + e]) : 0.0f);
              const float cdf = 0.5f * (1.0f + erff(p * 0.7071067811865475f));
              const float pdf = expf(-0.5f * p * p) * 0.3989422804014327f;
              hgv[e] = p * cdf;
              d[e] = acc2[4 * j + 2 * h + e] * (cdf + p * pdf);
            }
            if (r < g.M) {
              sum[0] += d[0];
              sum[1] += d[1];
              const long long off = cbase + (long long)r * g.N + col;
              if (col + 1 < g.N) {
                *reinterpret_cast<__nv_bfloat162*>(g.hg + off) =
                    __floats2bfloat162_rn(hgv[0], hgv[1]);
                *reinterpret_cast<__nv_bfloat162*>(g.dprec + off) =
                    __floats2bfloat162_rn(d[0], d[1]);
              } else if (col < g.N) {
                g.hg[off] = __float2bfloat16(hgv[0]);
                g.dprec[off] = __float2bfloat16(d[0]);
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = sum[e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 4)
              red[(4 * wg + warp) * SM90_BN + 8 * j + 2 * lane + e] = v;
          }
        }
        consumer_sync();
        if (threadIdx.x < SM90_BN && u.n0 + threadIdx.x < g.N) {
          float v = 0.0f;
#pragma unroll
          for (int w = 0; w < 8; ++w) v += red[w * SM90_BN + threadIdx.x];
          g.colsum[((long long)u.m_tile * g.clients + u.c) * g.N + u.n0 +
                   threadIdx.x] = v;
        }
        consumer_sync();  // red[] is free for the next tile
      }
    }
  }
}

inline int ceil_div(long long a, int b) { return (int)((a + b - 1) / b); }

inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Launch over m_tiles x n_tiles x z tiles (z = clients * splits), one
// persistent block per SM at most.
template <int TA, int TB0, int TB1, int EPI>
int sm90_gemm(Sm90Args g, int m_tiles, int n_tiles, int z, cudaStream_t st) {
  g.m_tiles = m_tiles;
  g.n_tiles = n_tiles;
  g.tiles = m_tiles * n_tiles * z;
  auto kern = sm90_gemm_kernel<TA, TB0, TB1, EPI>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SM90_SMEM);
  FC_CHECK();
  const int blocks = g.tiles < sm_count() ? g.tiles : sm_count();
  kern<<<blocks, SM90_THREADS, SM90_SMEM, st>>>(g);
  FC_CHECK();
  return 0;
}

// Whether the mainloop takes a product: bf16 (dtype code 1) operands whose
// contiguous dimensions d0, d1 are multiples of 8 (16-byte row strides).
inline bool sm90_takes(int dtype, int d0, int d1) {
  return dtype == 1 && d0 % 8 == 0 && d1 % 8 == 0;
}

// C(c) = EPI(A(c) . W(c)) for rows A [n, M, K] and weights W [n, K, C] in
// the [in, out] layout (the MN-major B): every forward product, and the
// attention backward's recomputed qkv.  g carries the epilogue's own fields (out,
// bias, res, s, seq); out is [n, M, C].
template <int EPI>
int sm90_linear(Sm90Args g, const bf16* a, const bf16* w, int n, int M, int K,
                int C, cudaStream_t st) {
  int err;
  if ((err = make_map(&g.a0, a, n, M, K)) ||
      (err = make_map(&g.b0, w, n, K, C)))
    return err;
  g.M = M; g.N = C;
  g.k_tiles = g.tiles_per_split = ceil_div(K, SM90_BK);
  g.splits = 1;
  g.out_client = (long long)M * C;
  return sm90_gemm<0, 1, 0, EPI>(g, ceil_div(M, SM90_BM),
                                 ceil_div(C, SM90_BN), n, st);
}

// out[i] = parts[0][i] + parts[1][i] + ... in that order (no atomics, so
// the split-row sums are the same on every run); total % 4 == 0.
__global__ void sum_parts_kernel(const float4* parts, int P, long long total4,
                                 float4* out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total4; i += (long long)gridDim.x * blockDim.x) {
    float4 a = parts[i];
    for (int p = 1; p < P; ++p) {
      const float4 b = parts[p * total4 + i];
      a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
    }
    out[i] = a;
  }
}

inline int sum_parts(const float* parts, int P, long long total, float* out,
                     cudaStream_t st) {
  const long long total4 = total / 4;
  const long long want = (total4 + 255) / 256;
  const unsigned blocks = (unsigned)(want < 65535 * 8 ? want : 65535 * 8);
  sum_parts_kernel<<<blocks, 256, 0, st>>>(
      reinterpret_cast<const float4*>(parts), P, total4,
      reinterpret_cast<float4*>(out));
  FC_CHECK();
  return 0;
}

}  // namespace
