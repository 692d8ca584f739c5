// Attention core backward per (item, head) on tensor cores, bf16:
//     dP = dO . V^T;  P saved (bf16) or recomputed, the f32 softmax of
//     scale * Q . K^T;  delta = rowsum(dP o P);  dS = T(P o (dP - delta));
//     dQ = scale * dS . K;  dK = scale * dS^T . Q;  dV = T(P)^T . dO;
//     recompute only: cat = T(T(P) . V).
// The per-head half of the fused attention backward (attn_bwd.cu: the TPU
// kernels _make_bwd_save_kernel and _bwd_one of
// fedcola_tpu/ops/fused_attention.py run it between their D-wide products).
// It takes a HeadLayout description of where the q/k/v, dO and output rows
// lie, so a caller with unpacked [pairs, N, hd] tensors can use it too.
//
// One block per (head, item), one fused launch: Q, K, V and dO of the head
// ([N, hd], N <= 256, hd in {16, 32, 64}) are copied once into shared
// memory as bf16 (cp.async, 16 bytes a thread; rows N..NP-1 zeroed, NP = N
// rounded up to 16), and P and dS never leave the SM: they are built in
// registers in the accumulator layout of one product and handed on as the
// A operand of the next.
//
// Tensor-core route: mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by
// ldmatrix, not wgmma.  N = 197 pads to 208 rows here against 256 for
// wgmma's 64-row tiles (N = 40 to 48 against 64), and mma.sync's
// accumulator fragment is, after rounding, exactly its A fragment, which is
// what lets P and dS stay in registers; the transposed operands (K and V in
// dS.K and P.V, Q and dO in dS^T.Q and P^T.dO) come from ldmatrix.trans on
// the same row-major tiles.  The four N x N x hd products are small (23
// GFLOP a call at the main path's shape), so the lower mma.sync rate costs
// little.
//
// No atomics, so every reduction has one owner and a fixed order:
//   rows     each warp owns 16-query blocks.  Pass 1 walks the keys in
//            16-wide chunks for the row statistics (recompute: running max
//            and sum of the online softmax, with delta's numerator carried
//            under the same rescaling; saved P: delta alone).  Pass 2 walks
//            them again, forms P and dS in f32, rounds them and accumulates
//            dQ (and cat) for its rows.  The statistics go to shared memory.
//   columns  each warp then owns 16-key blocks and walks the queries,
//            computing the transposed tiles S^T = K.Q^T and dP^T = V.dO^T
//            directly (no register transpose), P^T and dS^T from the stored
//            row statistics, and accumulates dK and dV for its keys.
// The S and dP products are therefore done up to three times; that is the
// price of dQ, dK and dV each having one writer.  Padded keys get P = 0
// (score -inf) and padded queries have dO = 0 and a zero 1/sum, so they add
// nothing to any sum.
//
// Column sums (the bias gradient): the f32 dQ, dK, dV values before
// rounding are summed over each block's 16 rows by shuffles, over the
// blocks in order through shared memory, and written to part [items, 3,
// H*hd]; the caller adds the items of a client in a fixed order.
#pragma once

#include "common.cuh"

namespace {

// Warps a block: one per 16-row block up to this many (N = 197 is 13
// blocks), bounded by the registers a thread needs.
template <bool RECOMP> constexpr int ah_maxw() { return RECOMP ? 13 : 16; }
constexpr int AH_PAD = 8;    // bf16 elements of padding a shared-memory row

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

// s = A1 . X^T and dp = A2 . Y^T for one 16 x 16 chunk.  A2 is a 16 x hd A
// fragment in registers; A1 is read from shared memory at a1addr (the
// lane's A-operand offset folded in) k16 step by k16 step, which keeps the
// recompute kernel within 128 registers.  xaddr / yaddr address 16 rows of
// the row-major shared tiles X and Y (hd contiguous) with the lane's
// B-operand offset folded in.  S selects whether s is computed at all.
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

// acc[16 x HD] += A(16 x 16) . Z(16 rows x HD), Z row-major in shared
// memory at zaddr (the lane's transposed-operand offset folded in).
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
// red[0..HD) (column sums over the 16 rows, one writer per column).
template <int HD>
__device__ __forceinline__ void ah_store(const float (&acc)[HD / 8][4],
                                         float scale, bf16* out, int row_stride,
                                         int r0, int N, int lane, float* red) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const float v0 = acc[nt][0] * scale, v1 = acc[nt][1] * scale;
    const float v2 = acc[nt][2] * scale, v3 = acc[nt][3] * scale;
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

// grid (H, items), 32 * min(ah_maxw(), ceil(N / 16)) threads.  P [items, H,
// N, N] is read when !RECOMP; cat is written when RECOMP.  part may be null.
template <int HD, bool RECOMP>
__global__ void __launch_bounds__(ah_maxw<RECOMP>() * 32, 1)
attn_bwd_head_kernel(const bf16* qg, const bf16* kg, const bf16* vg,
                     const bf16* dog, const bf16* P, bf16* dqg, bf16* dkg,
                     bf16* dvg, bf16* catg, float* part, HeadLayout L, int N,
                     float scale) {
  constexpr int LD = HD + AH_PAD;  // elements a shared row
  constexpr int KS = HD / 16;      // k16 steps over the head dim
  constexpr int DT = HD / 8;       // n8 tiles over the head dim
  extern __shared__ __align__(16) uint8_t ah_raw[];
  const int nblk = (N + 15) / 16, NP = nblk * 16;
  bf16* Qs = reinterpret_cast<bf16*>(ah_raw);
  bf16* Ks = Qs + NP * LD;
  bf16* Vs = Ks + NP * LD;
  bf16* Os = Vs + NP * LD;
  float* st_m = reinterpret_cast<float*>(Os + NP * LD);  // row max
  float* st_il = st_m + NP;                              // 1 / row sum
  float* st_dl = st_il + NP;                             // delta
  float* red = st_dl + NP;                               // [3][nblk][HD]

  const int h = blockIdx.x, H = gridDim.x;
  const long long item = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long ib = item * L.in_item + (long long)h * HD;
  const long long ob = item * L.do_item + (long long)h * HD;
  const long long pbase = (item * H + h) * (long long)N * N;

  // ---- Q, K, V, dO into shared memory ----
  constexpr int CPR = HD / 8;  // 16-byte pieces a row
  for (int e = tid; e < NP * CPR; e += nthr) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const int so = r * LD + c;
    if (r < N) {
      const long long gi = ib + (long long)r * L.in_row + c;
      ah_cp16(ah_smem(Qs + so), qg + gi);
      ah_cp16(ah_smem(Ks + so), kg + gi);
      ah_cp16(ah_smem(Vs + so), vg + gi);
      ah_cp16(ah_smem(Os + so), dog + ob + (long long)r * L.do_row + c);
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(Qs + so) = z;
      *reinterpret_cast<uint4*>(Ks + so) = z;
      *reinterpret_cast<uint4*>(Vs + so) = z;
      *reinterpret_cast<uint4*>(Os + so) = z;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // byte offsets of this lane's ldmatrix row: the A operand (and the
  // transposed B operand) take rows l%8 + 8*((l/8)%2) at columns 8*(l/16);
  // the plain B operand takes rows l%8 + 8*(l/16) at columns 8*((l/8)%2)
  const uint32_t a_off =
      2u * (((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
  const uint32_t b_off =
      2u * (((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8);
  const uint32_t q_sm = ah_smem(Qs), k_sm = ah_smem(Ks), v_sm = ah_smem(Vs),
                 o_sm = ah_smem(Os);
  constexpr uint32_t BLK = 16 * LD * 2;  // bytes of 16 shared rows

  // ---- rows: statistics, dQ (and cat) ----
  for (int rb = warp; rb < nblk; rb += nwarps) {
    uint32_t oa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ah_ldsm(oa[ks], o_sm + rb * BLK + a_off + ks * 32);
    const uint32_t qa = q_sm + rb * BLK + a_off;
    const int r0 = rb * 16 + g;  // this thread's rows: r0 and r0 + 8
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float dl[2] = {0.0f, 0.0f};

    // pass 1
    for (int jb = 0; jb < nblk; ++jb) {
      float s[2][4], dp[2][4];
      ah_chunk<KS, RECOMP>(qa, oa, k_sm + jb * BLK + b_off,
                           v_sm + jb * BLK + b_off, s, dp);
      if (RECOMP) {
        float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = jb * 16 + nt * 8 + 2 * t + (c & 1);
            s[nt][c] = j < N ? s[nt][c] * scale : -INFINITY;
            cm[c >> 1] = fmaxf(cm[c >> 1], s[nt][c]);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
          cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
          const float mn = fmaxf(m[r], cm[r]);
          const float corr = expf(m[r] - mn);
          l[r] *= corr;
          dl[r] *= corr;
          m[r] = mn;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e = expf(s[nt][c] - m[c >> 1]);
            l[c >> 1] += e;
            dl[c >> 1] += e * dp[nt][c];
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = r0 + 8 * (c >> 1);
            const int j = jb * 16 + nt * 8 + 2 * t + (c & 1);
            if (i < N && j < N)
              dl[c >> 1] += to_f(P[pbase + (long long)i * N + j]) * dp[nt][c];
          }
      }
    }
    float il[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
      if (RECOMP) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        il[r] = 1.0f / l[r];
        delta[r] = dl[r] * il[r];
      } else {
        il[r] = 0.0f;
        delta[r] = dl[r];
      }
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r0 + 8 * r;
        st_m[i] = m[r];
        st_il[i] = i < N ? il[r] : 0.0f;
        st_dl[i] = delta[r];
      }
    }

    // pass 2
    float dq[DT][4], cat[DT][4];
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) { dq[nt][c] = 0.0f; cat[nt][c] = 0.0f; }
    for (int jb = 0; jb < nblk; ++jb) {
      float s[2][4], dp[2][4];
      ah_chunk<KS, RECOMP>(qa, oa, k_sm + jb * BLK + b_off,
                           v_sm + jb * BLK + b_off, s, dp);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = r0 + 8 * (c >> 1);
          const int j = jb * 16 + nt * 8 + 2 * t + (c & 1);
          float p;
          if (RECOMP)
            p = j < N ? expf(s[nt][c] * scale - m[c >> 1]) * il[c >> 1] : 0.0f;
          else
            p = (i < N && j < N) ? to_f(P[pbase + (long long)i * N + j]) : 0.0f;
          s[nt][c] = p;
          dp[nt][c] = p * (dp[nt][c] - delta[c >> 1]);
        }
      uint32_t a[4];
      ah_as_a(dp, a);
      ah_accumulate<HD>(dq, a, k_sm + jb * BLK + a_off);
      if (RECOMP) {
        ah_as_a(s, a);
        ah_accumulate<HD>(cat, a, v_sm + jb * BLK + a_off);
      }
    }
    ah_store<HD>(dq, scale, dqg + item * L.dq_item + (long long)h * HD,
                 L.dq_row, r0, N, lane, part ? red + rb * HD : nullptr);
    if (RECOMP)
      ah_store<HD>(cat, 1.0f, catg + ob, L.do_row, r0, N, lane, nullptr);
  }
  __syncthreads();

  // ---- columns: dK and dV ----
  for (int cb = warp; cb < nblk; cb += nwarps) {
    uint32_t va[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ah_ldsm(va[ks], v_sm + cb * BLK + a_off + ks * 32);
    const uint32_t ka = k_sm + cb * BLK + a_off;
    const int j0 = cb * 16 + g;  // this thread's keys: j0 and j0 + 8
    float dk[DT][4], dv[DT][4];
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) { dk[nt][c] = 0.0f; dv[nt][c] = 0.0f; }
    for (int ib2 = 0; ib2 < nblk; ++ib2) {
      float sT[2][4], dpT[2][4];
      ah_chunk<KS, RECOMP>(ka, va, q_sm + ib2 * BLK + b_off,
                           o_sm + ib2 * BLK + b_off, sT, dpT);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + 8 * (c >> 1);
          const int i = ib2 * 16 + nt * 8 + 2 * t + (c & 1);
          float p;
          if (RECOMP)
            p = j < N ? expf(sT[nt][c] * scale - st_m[i]) * st_il[i] : 0.0f;
          else
            p = (i < N && j < N) ? to_f(P[pbase + (long long)i * N + j]) : 0.0f;
          sT[nt][c] = p;
          dpT[nt][c] = p * (dpT[nt][c] - st_dl[i]);
        }
      uint32_t a[4];
      ah_as_a(dpT, a);
      ah_accumulate<HD>(dk, a, q_sm + ib2 * BLK + a_off);
      ah_as_a(sT, a);
      ah_accumulate<HD>(dv, a, o_sm + ib2 * BLK + a_off);
    }
    const long long ob2 = item * L.dq_item + (long long)h * HD;
    ah_store<HD>(dk, scale, dkg + ob2, L.dq_row, j0, N, lane,
                 part ? red + (nblk + cb) * HD : nullptr);
    ah_store<HD>(dv, 1.0f, dvg + ob2, L.dq_row, j0, N, lane,
                 part ? red + (2 * nblk + cb) * HD : nullptr);
  }
  if (!part) return;
  __syncthreads();

  // ---- column sums of this (item, head): the blocks in order ----
  for (int e = tid; e < 3 * HD; e += nthr) {
    const int which = e / HD, d = e % HD;
    float v = 0.0f;
    for (int b = 0; b < nblk; ++b) v += red[(which * nblk + b) * HD + d];
    part[(item * 3 + which) * (long long)(H * HD) + h * HD + d] = v;
  }
}

inline size_t attn_bwd_head_smem(int N, int hd) {
  const int nblk = (N + 15) / 16, NP = nblk * 16;
  return (size_t)4 * NP * (hd + AH_PAD) * sizeof(bf16) +
         (size_t)(3 * NP + 3 * nblk * hd) * sizeof(float);
}

template <int HD, bool RECOMP>
int attn_bwd_head_launch(const bf16* q, const bf16* k, const bf16* v,
                         const bf16* dO, const bf16* P, bf16* dq, bf16* dk,
                         bf16* dv, bf16* cat, float* part, const HeadLayout& L,
                         int items, int H, int N, float scale,
                         cudaStream_t st) {
  auto kern = attn_bwd_head_kernel<HD, RECOMP>;
  const size_t smem = attn_bwd_head_smem(N, HD);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  FC_CHECK();
  const int nblk = (N + 15) / 16;
  const int warps = nblk < ah_maxw<RECOMP>() ? nblk : ah_maxw<RECOMP>();
  kern<<<dim3(H, items), warps * 32, smem, st>>>(q, k, v, dO, P, dq, dk, dv,
                                                 cat, part, L, N, scale);
  FC_CHECK();
  return 0;
}

// hd in {16, 32, 64} and N <= 256, or cudaErrorInvalidValue.  recompute:
// P is not read and cat [as dO] is written.
inline int attn_bwd_head(const bf16* q, const bf16* k, const bf16* v,
                         const bf16* dO, const bf16* P, bf16* dq, bf16* dk,
                         bf16* dv, bf16* cat, float* part, const HeadLayout& L,
                         int items, int H, int N, int hd, float scale,
                         bool recompute, cudaStream_t st) {
  if (N < 1 || N > 256) return (int)cudaErrorInvalidValue;
#define FC_HEAD(HD_)                                                         \
  if (hd == HD_)                                                             \
    return recompute                                                         \
               ? attn_bwd_head_launch<HD_, true>(q, k, v, dO, P, dq, dk, dv, \
                                                 cat, part, L, items, H, N,  \
                                                 scale, st)                  \
               : attn_bwd_head_launch<HD_, false>(q, k, v, dO, P, dq, dk,    \
                                                  dv, cat, part, L, items,   \
                                                  H, N, scale, st);
  FC_HEAD(16)
  FC_HEAD(32)
  FC_HEAD(64)
#undef FC_HEAD
  return (int)cudaErrorInvalidValue;
}

}  // namespace
