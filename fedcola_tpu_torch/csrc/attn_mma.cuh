// Building blocks of the per-head attention kernels on tensor cores
// (attn_fwd_core.cuh, attn_bwd_core.cuh): bf16 [rows, HD] tiles of one
// head in shared memory, mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by
// ldmatrix, and the store of a 16 x HD accumulator.
//
// Tile layout.  A tile is row-major with HD bf16 a row plus AH_PAD = 8
// elements (16 bytes) of padding, so that the eight rows of an ldmatrix
// phase fall into eight different 16-byte bank groups, and a step of 16
// columns is an immediate offset of 32 bytes on the lane's address.  (An
// unpadded XOR-swizzled layout was tried for two blocks an SM: it needs a
// register per swizzled address, which spilled the 64-wide backward at 128
// registers, and two 8-warp blocks measured no faster than one of 13
// warps.)
#pragma once

#include "common.cuh"

namespace {

// Element offsets of one (item, head): row r of q/k/v is at
// item * in_item + head * hd + r * in_row from its base pointer; dO and cat
// rows likewise through do_*, the dq/dk/dv rows through dq_*.
struct HeadLayout {
  long long in_item;
  int in_row;
  long long do_item;
  int do_row;
  long long dq_item;
  int dq_row;
};

__device__ __forceinline__ uint32_t ah_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ah_cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void ah_cp_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int AH_PAD = 8;  // bf16 elements of padding a shared-memory row

// The streamed kernels (N > AT_RESIDENT_N, attn_wgmma.cuh): a block owns
// AS_QB query rows (the column pass: key rows), and the other operand
// streams through a ring of AS_KC-row chunks (the column pass: AS_QC).
constexpr int AS_QB = 128;
constexpr int AS_KC = 64;
constexpr int AS_QC = 32;

// Element offset in a tile of the 16-byte piece `piece` of row `row`.
template <int HD>
__device__ __forceinline__ int ah_at(int row, int piece) {
  return row * (HD + AH_PAD) + piece * 8;
}

// Byte offsets of this lane's ldmatrix row within a 16-row block, for the
// first 16 columns: the A operand (and the transposed B operand) takes rows
// l%8 + 8*((l/8)%2) at piece l/16; the plain B operand rows l%8 + 8*(l/16)
// at piece (l/8)%2.
template <int HD>
__device__ __forceinline__ uint32_t ah_a_off(int lane) {
  return 2u * ah_at<HD>((lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4);
}
template <int HD>
__device__ __forceinline__ uint32_t ah_b_off(int lane) {
  return 2u * ah_at<HD>((lane & 7) + (lane >> 4) * 8, (lane >> 3) & 1);
}

// Four 8x8 bf16 matrices; lane l gives the address of row l%8 of matrix
// l/8 and receives, of matrix m, elements (row l/4, cols 2(l%4), +1) in
// r[m]; the .trans form receives (rows 2(l%4), +1, col l/4) instead.
__device__ __forceinline__ void ah_ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ah_ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ uint32_t ah_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two 16 x 8 accumulator tiles side by side (16 x 16), rounded to bf16, are
// the A fragment of the next product.
__device__ __forceinline__ void ah_as_a(const float (&c)[2][4],
                                        uint32_t (&a)[4]) {
  a[0] = ah_pack(c[0][0], c[0][1]);
  a[1] = ah_pack(c[0][2], c[0][3]);
  a[2] = ah_pack(c[1][0], c[1][1]);
  a[3] = ah_pack(c[1][2], c[1][3]);
}

// Copy rows [0, N) of one head's [N, HD] operand from global memory into a
// tile with cp.async (16 bytes a piece) and zero rows [N, NP).  `src` is
// row 0; rows are `row_stride` elements apart.
template <int HD>
__device__ __forceinline__ void ah_load_tile(bf16* tile, const bf16* src,
                                             int row_stride, int N, int NP,
                                             int tid, int nthr) {
  constexpr int CPR = HD / 8;  // 16-byte pieces a row
  for (int e = tid; e < NP * CPR; e += nthr) {
    const int r = e / CPR, c = e % CPR;
    bf16* dst = tile + ah_at<HD>(r, c);
    if (r < N)
      ah_cp16(ah_smem(dst), src + (long long)r * row_stride + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// tile = T(tile * qscale) on the pieces this thread copied in
// ah_load_tile (after its cp.async wait, before the block's barrier):
// flash attention's pre-scaled q, rounded to bf16 before any product.
template <int HD>
__device__ __forceinline__ void ah_prescale_tile(bf16* tile, float qscale,
                                                 int N, int tid, int nthr) {
  constexpr int CPR = HD / 8;
  for (int e = tid; e < N * CPR; e += nthr) {
    __nv_bfloat162* p =
        reinterpret_cast<__nv_bfloat162*>(tile + ah_at<HD>(e / CPR, e % CPR));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      p[i] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
    }
  }
}

// s = A1 . X^T and dp = A2 . Y^T for one 16 x 16 chunk.  A2 is a 16 x hd A
// fragment in registers; A1 is read from shared memory at a1addr (the
// lane's A-operand offset folded in) k16 step by k16 step, which keeps the
// recompute kernel within 128 registers.  xaddr / yaddr address 16 rows of
// the shared tiles X and Y with the lane's B-operand offset folded in.  S
// selects whether s is computed at all.
template <int KS, bool S>
__device__ __forceinline__ void ah_chunk(uint32_t a1addr,
                                         const uint32_t (&a2)[KS][4],
                                         uint32_t xaddr, uint32_t yaddr,
                                         float (&s)[2][4], float (&dp)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) { s[i][c] = 0.0f; dp[i][c] = 0.0f; }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[4];
    if (S) {
      uint32_t a1[4];
      ah_ldsm(a1, a1addr + ks * 32);
      ah_ldsm(b, xaddr + ks * 32);
      mma_bf16(s[0], a1, &b[0]);
      mma_bf16(s[1], a1, &b[2]);
    }
    ah_ldsm(b, yaddr + ks * 32);
    mma_bf16(dp[0], a2[ks], &b[0]);
    mma_bf16(dp[1], a2[ks], &b[2]);
  }
}

// s = A . X^T for one 16 x 16 chunk, A a 16 x hd fragment in registers.
template <int KS>
__device__ __forceinline__ void ah_scores(const uint32_t (&a)[KS][4],
                                          uint32_t xaddr, float (&s)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[4];
    ah_ldsm(b, xaddr + ks * 32);
    mma_bf16(s[0], a[ks], &b[0]);
    mma_bf16(s[1], a[ks], &b[2]);
  }
}

// Keys j0, j0 + 1, j0 + 8, j0 + 9 of a 16 x 16 score chunk (this thread's
// columns): those at or past N score -inf.  Only the last chunk needs it.
__device__ __forceinline__ void ah_mask_keys(float (&s)[2][4], int j0, int N) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + nt * 8 + (c & 1) >= N) s[nt][c] = -INFINITY;
}

// exp(scale * x) as exp2(c2 * x), c2 = scale * log2(e): one fma and one
// ex2 an element where the scores are exponentiated.
constexpr float AH_LOG2E = 1.4426950408889634f;

// acc[16 x HD] += A(16 x 16) . Z(16 rows x HD), Z a shared tile at zaddr
// (the lane's transposed-operand offset folded in).
template <int HD>
__device__ __forceinline__ void ah_accumulate(float (&acc)[HD / 8][4],
                                              const uint32_t (&a)[4],
                                              uint32_t zaddr) {
#pragma unroll
  for (int d2 = 0; d2 < HD / 16; ++d2) {
    uint32_t b[4];
    ah_ldsm_t(b, zaddr + d2 * 32);
    mma_bf16(acc[2 * d2], a, &b[0]);
    mma_bf16(acc[2 * d2 + 1], a, &b[2]);
  }
}

// Store the thread's part of a 16 x HD accumulator, times `scale`, as bf16
// at rows r0 and r0 + 8 (when < N) of `out`, and add the f32 values to
// red[0..HD) (column sums over the 16 rows, one writer per column).  TWICE
// rounds the accumulator to bf16 before the product and the product again
// (flash attention's dq = T(T(ds . k) * scale)).
template <int HD, bool TWICE = false>
__device__ __forceinline__ void ah_store(const float (&acc)[HD / 8][4],
                                         float scale, bf16* out, int row_stride,
                                         int r0, int N, int lane, float* red) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    float v0 = acc[nt][0], v1 = acc[nt][1], v2 = acc[nt][2], v3 = acc[nt][3];
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
