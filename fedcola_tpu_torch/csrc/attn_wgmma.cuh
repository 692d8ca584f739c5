// Building blocks of the streamed per-head attention kernels on Hopper
// (attn_fwd_core.cuh and attn_bwd_core.cuh past AT_RESIDENT_N keys): TMA
// maps over one head's rows, the ring's constants and the release of its
// stages, wgmma.m64nNk16 in the two forms those kernels use, and
// shared-memory access to 128-byte swizzled tiles.
//
// Block shape.  A block owns AS_QB = 128 rows (queries; the column pass:
// keys) as two warpgroups of 64 rows, and the streamed operand comes
// through a ring of AS_ST stages of TMA boxes, each stage with a `full`
// mbarrier (expect_tx; TMA completes it with the bytes; gemm_sm90.cuh's
// helpers) and a counter of the warps done with it (as_release): the last
// of the eight to let go of a stage issues its refill, so no warp is set
// aside to load, no thread waits for another to let go, and the registers
// of a ninth warp go to the products (a block of 9 warps gets 168 a thread,
// of 8 warps 255; two blocks an SM 96 and 128).  Every tile is a 64-column
// bf16 TMA box under the 128-byte swizzle (gemm_sm90.cuh's layouts), 64
// rows (the column pass's query chunks: AS_QC = 32) of one head, its
// columns from the head's first, so a box row holds the head's hd values
// and, past them at hd < 64, the next columns of the row or TMA's zero
// fill.  Those extra columns are read only by products whose output
// columns past hd are discarded (P.V, dS.K, P^T.dO, dS^T.Q) and never by a
// product that reduces over the head dim (Q.K^T, dO.V^T take hd / 16 k16
// steps), so they change no stored value.
//
// Products.  Every N^2 product is wgmma.m64nNk16 (bf16 in, f32
// accumulators: N / 2 a thread, row 16 * warp + lane / 4 [+ 8], column
// 8j + 2 (lane % 4) [+ 1] in d[4j + 2h + e], the mma.sync layout of
// attn_mma.cuh tile by tile; N = 64, or 32 for the column pass's S^T and
// dP^T), starting from zero through the scale-d predicate:
//   SS  both operands K-major tiles in shared memory: S = Q.K^T,
//       dP = dO.V^T, S^T = K.Q^T, dP^T = V.dO^T;
//   RS  A from registers, B an MN-major tile (the transpose bit): the
//       rounded accumulator of one product is, 16 keys at a time, the A
//       fragment of the next (P.V, dS.K, P^T.dO, dS^T.Q), so P and dS
//       stay in registers.
// Each batch of products is committed and waited for in full before its
// accumulators are read: with a group left in flight across the
// elementwise work, ptxas serialises every wgmma of the kernel (C7514 /
// C7515, "non wgmma instructions reading / defining accumulator
// registers"), which measured slower than waiting.  The overlap of the
// exp2 with the tensor cores comes from the other warpgroups on the SM.
#pragma once

#include "attn_core.cuh"
#include "attn_mma.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int AS_ST = 4;                 // ring stages
constexpr int AS_THREADS = 256;          // two warpgroups
constexpr uint32_t AS_BOX = 64 * 64 * 2; // one 64 x 64 bf16 box, bytes

// One operand of a head kernel: row r of head h of item i starts at
// element i * item + r * row + col + h * hd of ptr; `width` elements of a
// row lie from ptr's row start (the map's first dimension).  The packed
// qkv layout is one map (width 3D) with col 0, D, 2D for q, k, v.
struct AsSrc {
  const bf16* ptr;
  long long item;
  int row, width, col;
};

// A map over [items][N][width] with the given element strides, boxes of
// `rows` x 64, 128-byte swizzle, zero fill past every edge.
inline int as_map(CUtensorMap* m, const AsSrc& s, int N, int items,
                  int rows = 64) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)s.width, (cuuint64_t)N,
                              (cuuint64_t)items};
  const cuuint64_t strides[2] = {(cuuint64_t)s.row * 2,
                                 (cuuint64_t)s.item * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<bf16*>(s.ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A map and the column of head 0's first element in it.
struct AsMap {
  CUtensorMap map;
  int col;
};

// Everything a streamed launch needs, passed by value as a
// __grid_constant__ so that the maps live in parameter space.
struct AsFwdArgs {
  AsMap q, k, v;
  CUtensorMap p;         // P [items * H][N][N] (tiles: as_p_tiles)
  bf16* o;               // o / cat rows at item * o_item + r * o_row
  long long o_item;
  int o_row;
  bf16* P;               // [items, H, N, N], or null (not saved)
  int N, H;
  float c2, qscale;      // c2 = scale * log2(e); qscale != 0: flash's q
};

struct AsBwdArgs {
  AsMap q, k, v, o;      // o: dO; 64-row boxes
  AsMap qc, oc;          // q and dO in the column kernel's AS_QC-row boxes
  CUtensorMap p, pc;     // saved P in tiles (as_p_tiles): 64 and AS_QC rows
  const bf16* P;         // saved P [items, H, N, N] (mode AH_SAVED)
  bf16 *dq, *dk, *dv;    // rows at item * g_item + r * g_row (head 0)
  long long g_item;
  int g_row;
  bf16* cat;             // mode AH_RECOMP: rows as dO's
  long long o_item;
  int o_row;
  float* part;           // column sums [items * nqb, 3, H * hd], or null
  float* stats;          // [items, H, N, 3]: row max * c2, 1 / sum, delta
  int N, H;
  float scale, qscale, c2;
};

// Whether P [items * H, N, N] moves in whole TMA tiles: its rows must start
// on 16-byte boundaries, so N % 8 == 0 (and P itself 16-byte aligned).
// Otherwise the kernels read and write P element by element from the
// fragments: the second path, chosen here by shape alone.
inline bool as_p_tiles(const void* P, int N) {
  return P && N % 8 == 0 && (reinterpret_cast<uintptr_t>(P) & 15) == 0;
}

// ---------------------------------------------------------- device side --

#define AS_ACC32                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define AS_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

// d = (acc ? d : 0) + A(64 x 16) . B(16 x 64), both K-major tiles in
// shared memory.  The accumulator starts from zero through wgmma's scale-d
// predicate, not through moves into its registers.
__device__ __forceinline__ void as_wgmma_ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AS_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : AS_ACC32
      : "l"(da), "l"(db), "r"(acc));
}

// d = (acc ? d : 0) + A(64 x 16, registers) . B(16 x 64), B an MN-major
// tile.
__device__ __forceinline__ void as_wgmma_rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AS_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : AS_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#define AS_ACC16                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define AS_D16                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// The m64n32k16 forms (16 accumulators a thread), for the column kernel's
// 32-query chunks.
__device__ __forceinline__ void as_wgmma_ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " AS_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : AS_ACC16
      : "l"(da), "l"(db), "r"(acc));
}
#undef AS_ACC16
#undef AS_D16
#undef AS_ACC32
#undef AS_D32

// The compiler sees a wgmma's operands as consumed when it is issued;
// these keep them live, unmoved, until after the wait.
template <int R>
__device__ __forceinline__ void as_keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void as_keep(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d = A . B^T over the head dim (KS k16 steps): A the warpgroup's 64-row
// box, B a 64-row box, both K-major; issued, not committed.
template <int KS, int R>
__device__ __forceinline__ void as_issue_ss(float (&d)[R], uint32_t a,
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    as_wgmma_ss(d, operand_desc<0>(a, kk), operand_desc<0>(b, kk), kk);
}

// d = (acc ? d : 0) + A . Z over 16 K rows of Z (K k16 steps), A the
// fragments a[kk] in registers, Z a box read MN-major; issued, not
// committed.
template <int K>
__device__ __forceinline__ void as_issue_rs(float (&d)[32],
                                            const uint32_t (&a)[K][4],
                                            uint32_t z, int acc) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    as_wgmma_rs(d, a[kk], operand_desc<1>(z, kk), acc || kk);
}

// The A fragments of a 64-row accumulator after rounding to bf16: k16
// step kk holds columns 16kk..16kk+15 (ah_as_a, tile by tile).
template <int K>
__device__ __forceinline__ void as_frag(const float (&x)[8 * K],
                                        uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[kk][q] = ah_pack(x[8 * kk + 2 * q], x[8 * kk + 2 * q + 1]);
}

// Columns at or past N of a 64-column accumulator whose first column is
// c0 (this thread's: c0 + 8j + 2t [+1]) become -inf.
__device__ __forceinline__ void as_mask_cols(float (&s)[32], int c0, int N) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (c0 + 8 * j + e >= N) {
        s[4 * j + e] = -INFINITY;
        s[4 * j + 2 + e] = -INFINITY;
      }
}

// This warp is done with the tile of a ring stage (its wgmma reads retired,
// its own reads taken): counts it at the stage's counter `cnt` and returns,
// in every lane, whether it was the last of the block's eight warps, which
// then refills the stage.  No thread waits for another to let go of a
// stage, so no warp is set aside to load.
__device__ __forceinline__ bool as_release(uint32_t cnt, int lane) {
  uint32_t last = 0;
  __syncwarp();
  if (lane == 0) {
    uint32_t old;
    asm volatile("atom.shared.add.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "r"(cnt) : "memory");
    last = old == 7;
    if (last) {
      asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(cnt) : "memory");
      __threadfence_block();
    }
  }
  return __shfl_sync(0xffffffffu, last, 0) != 0;
}

__device__ __forceinline__ void as_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void as_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of element (r, c) of a 64 x 64 bf16 box under the 128-byte
// swizzle: 16-byte chunk c / 8 of row r is stored at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t as_sw(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ uint32_t as_ld32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float as_ld_bf16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ float as_ld_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void as_st32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void as_st_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// In place T(x * qscale) over `bytes` of bf16 at addr, 16 bytes a thread
// at a time from `first`, stepping by `step` threads: flash attention's
// pre-scaled q, rounded before any product.
__device__ __forceinline__ void as_prescale(uint32_t addr, int bytes,
                                            float qscale, int first,
                                            int step) {
  for (int o = first * 16; o < bytes; o += step * 16) {
    uint32_t w[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(addr + o) : "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16x2(w[i]);
      w[i] = ah_pack(f.x * qscale, f.y * qscale);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr + o),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]) : "memory");
  }
}

// TMA store of one 64 x 64 box from shared memory, in the thread's bulk
// group.
__device__ __forceinline__ void as_tma_store(const CUtensorMap* map,
                                             uint32_t src, int col, int row,
                                             int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(z)
      : "memory");
}
__device__ __forceinline__ void as_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void as_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void as_bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Store a 64 x 64 accumulator's first HD columns, times `scale`, as bf16
// at rows r0 and r0 + 8 (when < N) of `out`, and add each column's f32
// values over the warp's 16 rows into red[0..HD) (one writer a column).
// TWICE rounds the accumulator to bf16 before the product and the product
// again (flash attention's dq).  ah_store's arithmetic, tile by tile.
template <int HD, bool TWICE = false>
__device__ __forceinline__ void as_store(const float (&acc)[32], float scale,
                                         bf16* out, int row_stride, int r0,
                                         int N, int lane, float* red) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    float v0 = acc[4 * nt], v1 = acc[4 * nt + 1], v2 = acc[4 * nt + 2],
          v3 = acc[4 * nt + 3];
    if (TWICE) {
      v0 = to_f(from_f<bf16>(v0)); v1 = to_f(from_f<bf16>(v1));
      v2 = to_f(from_f<bf16>(v2)); v3 = to_f(from_f<bf16>(v3));
    }
    v0 *= scale; v1 *= scale; v2 *= scale; v3 *= scale;
    const int col = nt * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r0 * row_stride +
                                         col) = __floats2bfloat162_rn(v0, v1);
    if (r0 + 8 < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(r0 + 8) * row_stride +
                                         col) = __floats2bfloat162_rn(v2, v3);
    if (red) {
      float c0 = v0 + v2, c1 = v1 + v3;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c0 += __shfl_xor_sync(0xffffffffu, c0, o);
        c1 += __shfl_xor_sync(0xffffffffu, c1, o);
      }
      if (lane < 4) { red[col] = c0; red[col + 1] = c1; }
    }
  }
}

}  // namespace
