// Attention core backward per (item, head) on tensor cores, bf16:
//     dP = dO . V^T;  P saved (bf16) or recomputed, the f32 softmax of
//     scale * Q . K^T;  delta = rowsum(dP o P);  dS = T(P o (dP - delta));
//     dQ = scale * dS . K;  dK = scale * dS^T . Q;  dV = T(P)^T . dO;
//     recompute only: cat = T(T(P) . V).
// The per-head half of the fused attention backward (attn_bwd.cu: the TPU
// kernels _make_bwd_save_kernel and _bwd_one of
// fedcola_tpu/ops/fused_attention.py run it between their D-wide products).
// It takes a HeadLayout description of where the q/k/v, dO and output rows
// lie, and flash attention's backward (flash_bwd.cu, the TPU kernel
// _bwd_kernel of fedcola_tpu/ops/flash_attention.py) runs it on its
// unpacked [pairs, N, hd] tensors in a third mode, AH_FLASH: P recomputed
// from the pre-scaled q, qm = T(q * qscale), rounded in shared memory
// before the first product; no cat and no column sums; dq rounded twice,
// T(T(dS . K) * qscale); dK = dS^T . qm unscaled.
//
// One block per (head, item), one fused launch: Q, K, V and dO of the head
// ([N, hd], N <= AT_RESIDENT_N = 256, hd in {16, 32, 64}; the streamed
// kernels further down take longer N) are copied once into shared
// memory as bf16 (cp.async, 16 bytes a thread; rows N..NP-1 zeroed, NP = N
// rounded up to 16; padded tiles, attn_mma.cuh), and P and dS never leave
// the SM: they are built in registers in the accumulator layout of one
// product and handed on as the A operand of the next.
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
// (score -inf; in the row passes only the last chunk holds any) and padded
// queries have dO = 0 and a zero 1/sum, so they add nothing to any sum.
// The recomputed P is exp2(c2 * s - c2 * max) / sum with c2 = scale *
// log2(e), one fma and one ex2 an element; the row maximum is kept in that
// form.
//
// Column sums (the bias gradient): the f32 dQ, dK, dV values before
// rounding are summed over each block's 16 rows by shuffles, over the
// blocks in order through shared memory, and written to part [items, 3,
// H*hd]; the caller adds the items of a client in a fixed order.
#pragma once

#include "attn_core.cuh"
#include "attn_mma.cuh"

namespace {

// What the head kernel computes besides dQ, dK, dV.
constexpr int AH_SAVED = 0;   // P read from memory (fused attention, row 2)
constexpr int AH_RECOMP = 1;  // P recomputed, cat written (row 5)
constexpr int AH_FLASH = 2;   // P recomputed from the pre-scaled q (row 12)

// Warps a block: one per 16-row block up to this many (N = 197 is 13
// blocks), bounded by the registers a thread needs: the modes that
// recompute P hold more state than 128 registers take without a spill.
template <int MODE> constexpr int ah_maxw() {
  return MODE == AH_SAVED ? 16 : 13;
}

// grid (H, items), 32 * min(max warps, ceil(N / 16)) threads.  P [items, H,
// N, N] is read in mode AH_SAVED; cat is written in mode AH_RECOMP.  part
// may be null.  qscale is read in mode AH_FLASH only (scale is then 1).  c2
// = scale * log2(e), computed by the launcher so that it costs no register:
// exp(scale * x) = exp2(c2 * x).
template <int HD, int MODE>
__global__ void __launch_bounds__(ah_maxw<MODE>() * 32, 1)
attn_bwd_head_kernel(const bf16* qg, const bf16* kg, const bf16* vg,
                     const bf16* dog, const bf16* P, bf16* dqg, bf16* dkg,
                     bf16* dvg, bf16* catg, float* part, HeadLayout L, int N,
                     float scale, float qscale, float c2) {
  constexpr bool RECOMP = MODE != AH_SAVED;  // P from q and k
  constexpr bool CAT = MODE == AH_RECOMP;
  constexpr int LD = HD + AH_PAD;  // elements a shared row
  constexpr int KS = HD / 16;      // k16 steps over the head dim
  constexpr int DT = HD / 8;       // n8 tiles over the head dim
  extern __shared__ __align__(16) uint8_t ah_raw[];
  const int nblk = (N + 15) / 16, NP = nblk * 16;
  bf16* Qs = reinterpret_cast<bf16*>(ah_raw);
  bf16* Ks = Qs + NP * LD;
  bf16* Vs = Ks + NP * LD;
  bf16* Os = Vs + NP * LD;
  float* st_m = reinterpret_cast<float*>(Os + NP * LD);  // row max * c2
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
  ah_load_tile<HD>(Qs, qg + ib, L.in_row, N, NP, tid, nthr);
  ah_load_tile<HD>(Ks, kg + ib, L.in_row, N, NP, tid, nthr);
  ah_load_tile<HD>(Vs, vg + ib, L.in_row, N, NP, tid, nthr);
  ah_load_tile<HD>(Os, dog + ob, L.do_row, N, NP, tid, nthr);
  ah_cp_wait();
  if (MODE == AH_FLASH) ah_prescale_tile<HD>(Qs, qscale, N, tid, nthr);
  __syncthreads();

  const uint32_t a_off = ah_a_off<HD>(lane), b_off = ah_b_off<HD>(lane);
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
        if (jb == nblk - 1) ah_mask_keys(s, jb * 16 + 2 * t, N);
        float cm[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          cm[r] = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                        fmaxf(s[1][2 * r], s[1][2 * r + 1]));
          cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
          cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
          const float mn = fmaxf(m[r], cm[r]);
          const float corr = exp2f((m[r] - mn) * c2);
          l[r] *= corr;
          dl[r] *= corr;
          m[r] = mn;
        }
        const float mc[2] = {m[0] * c2, m[1] * c2};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e = exp2f(fmaf(s[nt][c], c2, -mc[c >> 1]));
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
    // the row max of the raw products (scale > 0), in the exp2 domain
    const float mc[2] = {m[0] * c2, m[1] * c2};
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
        st_m[i] = mc[r];
        st_il[i] = i < N ? il[r] : 0.0f;
        st_dl[i] = delta[r];
      }
    }

    // pass 2
    float dq[DT][4], cat[CAT ? DT : 1][4];
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dq[nt][c] = 0.0f;
        if constexpr (CAT) cat[nt][c] = 0.0f;
      }
    for (int jb = 0; jb < nblk; ++jb) {
      float s[2][4], dp[2][4];
      ah_chunk<KS, RECOMP>(qa, oa, k_sm + jb * BLK + b_off,
                           v_sm + jb * BLK + b_off, s, dp);
      if (RECOMP && jb == nblk - 1) ah_mask_keys(s, jb * 16 + 2 * t, N);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = r0 + 8 * (c >> 1);
          const int j = jb * 16 + nt * 8 + 2 * t + (c & 1);
          float p;
          if (RECOMP)
            p = exp2f(fmaf(s[nt][c], c2, -mc[c >> 1])) * il[c >> 1];
          else
            p = (i < N && j < N) ? to_f(P[pbase + (long long)i * N + j]) : 0.0f;
          s[nt][c] = p;
          dp[nt][c] = p * (dp[nt][c] - delta[c >> 1]);
        }
      uint32_t a[4];
      ah_as_a(dp, a);
      ah_accumulate<HD>(dq, a, k_sm + jb * BLK + a_off);
      if constexpr (CAT) {
        ah_as_a(s, a);
        ah_accumulate<HD>(cat, a, v_sm + jb * BLK + a_off);
      }
    }
    bf16* dq_out = dqg + item * L.dq_item + (long long)h * HD;
    if constexpr (MODE == AH_FLASH)
      ah_store<HD, true>(dq, qscale, dq_out, L.dq_row, r0, N, lane, nullptr);
    else
      ah_store<HD>(dq, scale, dq_out, L.dq_row, r0, N, lane,
                   part ? red + rb * HD : nullptr);
    if constexpr (CAT)
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
            p = j < N ? exp2f(fmaf(sT[nt][c], c2, -st_m[i])) * st_il[i] : 0.0f;
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
    // flash: dK = dS^T . qm, the pre-scaled q (Qs holds it), unscaled
    ah_store<HD>(dk, MODE == AH_FLASH ? 1.0f : scale, dkg + ob2, L.dq_row,
                 j0, N, lane, part ? red + (nblk + cb) * HD : nullptr);
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

// ---- streamed (N > AT_RESIDENT_N) ----
//
// Two kernels on the same stream, each with shared memory that does not
// grow with N, and the row statistics through device memory in between:
//   rows     grid (H, items, ceil(N / AS_QB)): a block keeps its AS_QB
//            queries' Q and dO in shared memory and streams K and V through
//            a two-slot cp.async ring of AS_KC-key chunks, twice: pass 1
//            the row statistics, written to stats [items, H, N, 3] (the
//            row max * c2, 1 / sum and delta; recompute modes) or delta
//            alone (saved P); pass 2 dQ (and cat), as the resident row
//            pass does per 16-key block.
//   columns  grid (H, items, ceil(N / AS_QB)): a block keeps its AS_QB keys'
//            K and V in shared memory and streams Q, dO and the queries'
//            statistics through the ring, accumulating dK and dV as the
//            resident column pass does.
// Every value has one writer.  Column sums go to part [items * nqb, 3,
// H*hd] (nqb = ceil(N / AS_QB); row item * nqb + block), each block's warps
// summed in order, dQ's by the row kernel and dK's and dV's by the column
// kernel; the caller sums the rows of a client in a fixed order.
template <int HD, int MODE>
__global__ void __launch_bounds__(AS_WARPS * 32, 1)
attn_bwd_head_rows_stream_kernel(const bf16* qg, const bf16* kg,
                                 const bf16* vg, const bf16* dog,
                                 const bf16* P, bf16* dqg, bf16* catg,
                                 float* part, float* stats, HeadLayout L,
                                 int N, float scale, float qscale, float c2) {
  constexpr bool RECOMP = MODE != AH_SAVED;
  constexpr bool CAT = MODE == AH_RECOMP;
  constexpr int LD = HD + AH_PAD;
  constexpr int KS = HD / 16;
  constexpr int DT = HD / 8;
  constexpr uint32_t BLK = 16 * LD * 2;
  constexpr uint32_t SLOT = AS_KC * LD * 2;
  extern __shared__ __align__(16) uint8_t as_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(as_raw);  // [AS_QB][LD]
  bf16* Os = Qs + AS_QB * LD;                  // [AS_QB][LD] (dO)
  bf16* Ks = Os + AS_QB * LD;                  // ring [2][AS_KC][LD]
  bf16* Vs = Ks + 2 * AS_KC * LD;              // ring [2][AS_KC][LD]
  float* red = reinterpret_cast<float*>(Vs + 2 * AS_KC * LD);  // [warps][HD]

  const int h = blockIdx.x, H = gridDim.x;
  const long long item = blockIdx.y;
  const int qz = blockIdx.z, nqb = gridDim.z;
  const int q0 = qz * AS_QB, nq = min(AS_QB, N - q0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = warp * 16 < nq;
  const long long ib = item * L.in_item + (long long)h * HD;
  const long long ob = item * L.do_item + (long long)h * HD;
  const long long pbase = (item * H + h) * (long long)N * N;
  const int nch = (N + AS_KC - 1) / AS_KC;

  ah_load_tile<HD>(Qs, qg + ib + (long long)q0 * L.in_row, L.in_row, nq,
                   AS_QB, tid, nthr);
  ah_load_tile<HD>(Os, dog + ob + (long long)q0 * L.do_row, L.do_row, nq,
                   AS_QB, tid, nthr);
  ah_cp_wait();
  if (MODE == AH_FLASH) ah_prescale_tile<HD>(Qs, qscale, nq, tid, nthr);
  __syncthreads();

  const uint32_t a_off = ah_a_off<HD>(lane), b_off = ah_b_off<HD>(lane);
  const uint32_t k_sm = ah_smem(Ks), v_sm = ah_smem(Vs);
  uint32_t oa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ah_ldsm(oa[ks], ah_smem(Os) + warp * BLK + a_off + ks * 32);
  const uint32_t qa = ah_smem(Qs) + warp * BLK + a_off;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float dl[2] = {0.0f, 0.0f};

  // pass 1: the row statistics
  ah_load_chunk<HD>(Ks, kg + ib, L.in_row, 0, N, tid, nthr);
  ah_load_chunk<HD>(Vs, vg + ib, L.in_row, 0, N, tid, nthr);
  ah_cp_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      const int slot = ((c + 1) & 1) * AS_KC * LD;
      ah_load_chunk<HD>(Ks + slot, kg + ib, L.in_row, (c + 1) * AS_KC, N, tid,
                        nthr);
      ah_load_chunk<HD>(Vs + slot, vg + ib, L.in_row, (c + 1) * AS_KC, N, tid,
                        nthr);
      ah_cp_commit();
      ah_cp_wait_pending<1>();
    } else {
      ah_cp_wait_pending<0>();
    }
    __syncthreads();
    const int j0 = c * AS_KC;
    const int nb = (min(AS_KC, N - j0) + 15) / 16;
    const uint32_t kc = k_sm + (c & 1) * SLOT, vc = v_sm + (c & 1) * SLOT;
    for (int jb = 0; active && jb < nb; ++jb) {
      const int jj = j0 + jb * 16;
      float s[2][4], dp[2][4];
      ah_chunk<KS, RECOMP>(qa, oa, kc + jb * BLK + b_off,
                           vc + jb * BLK + b_off, s, dp);
      if (RECOMP) {
        if (jj + 16 > N) ah_mask_keys(s, jj + 2 * t, N);
        float cm[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          cm[r] = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                        fmaxf(s[1][2 * r], s[1][2 * r + 1]));
          cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
          cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
          const float mn = fmaxf(m[r], cm[r]);
          const float corr = exp2f((m[r] - mn) * c2);
          l[r] *= corr;
          dl[r] *= corr;
          m[r] = mn;
        }
        const float mc[2] = {m[0] * c2, m[1] * c2};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const float e = exp2f(fmaf(s[nt][c4], c2, -mc[c4 >> 1]));
            l[c4 >> 1] += e;
            dl[c4 >> 1] += e * dp[nt][c4];
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const int i = r0 + 8 * (c4 >> 1);
            const int j = jj + nt * 8 + 2 * t + (c4 & 1);
            if (i < N && j < N)
              dl[c4 >> 1] +=
                  to_f(P[pbase + (long long)i * N + j]) * dp[nt][c4];
          }
      }
    }
    __syncthreads();
  }
  float il[2], delta[2];
  const float mc[2] = {m[0] * c2, m[1] * c2};
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
  if (active && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + 8 * r;
      if (i < N) {
        float* st = stats + ((item * H + h) * (long long)N + i) * 3;
        st[0] = mc[r];
        st[1] = il[r];
        st[2] = delta[r];
      }
    }
  }

  // pass 2: dQ (and cat)
  float dq[DT][4], cat[CAT ? DT : 1][4];
#pragma unroll
  for (int nt = 0; nt < DT; ++nt)
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      dq[nt][c4] = 0.0f;
      if constexpr (CAT) cat[nt][c4] = 0.0f;
    }
  ah_load_chunk<HD>(Ks, kg + ib, L.in_row, 0, N, tid, nthr);
  ah_load_chunk<HD>(Vs, vg + ib, L.in_row, 0, N, tid, nthr);
  ah_cp_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      const int slot = ((c + 1) & 1) * AS_KC * LD;
      ah_load_chunk<HD>(Ks + slot, kg + ib, L.in_row, (c + 1) * AS_KC, N, tid,
                        nthr);
      ah_load_chunk<HD>(Vs + slot, vg + ib, L.in_row, (c + 1) * AS_KC, N, tid,
                        nthr);
      ah_cp_commit();
      ah_cp_wait_pending<1>();
    } else {
      ah_cp_wait_pending<0>();
    }
    __syncthreads();
    const int j0 = c * AS_KC;
    const int nb = (min(AS_KC, N - j0) + 15) / 16;
    const uint32_t kc = k_sm + (c & 1) * SLOT, vc = v_sm + (c & 1) * SLOT;
    for (int jb = 0; active && jb < nb; ++jb) {
      const int jj = j0 + jb * 16;
      float s[2][4], dp[2][4];
      ah_chunk<KS, RECOMP>(qa, oa, kc + jb * BLK + b_off,
                           vc + jb * BLK + b_off, s, dp);
      if (RECOMP && jj + 16 > N) ah_mask_keys(s, jj + 2 * t, N);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const int i = r0 + 8 * (c4 >> 1);
          const int j = jj + nt * 8 + 2 * t + (c4 & 1);
          float p;
          if (RECOMP)
            p = exp2f(fmaf(s[nt][c4], c2, -mc[c4 >> 1])) * il[c4 >> 1];
          else
            p = (i < N && j < N) ? to_f(P[pbase + (long long)i * N + j])
                                 : 0.0f;
          s[nt][c4] = p;
          dp[nt][c4] = p * (dp[nt][c4] - delta[c4 >> 1]);
        }
      uint32_t a[4];
      ah_as_a(dp, a);
      ah_accumulate<HD>(dq, a, kc + jb * BLK + a_off);
      if constexpr (CAT) {
        ah_as_a(s, a);
        ah_accumulate<HD>(cat, a, vc + jb * BLK + a_off);
      }
    }
    __syncthreads();
  }
  if (active) {
    bf16* dq_out = dqg + item * L.dq_item + (long long)h * HD;
    if constexpr (MODE == AH_FLASH)
      ah_store<HD, true>(dq, qscale, dq_out, L.dq_row, r0, N, lane, nullptr);
    else
      ah_store<HD>(dq, scale, dq_out, L.dq_row, r0, N, lane,
                   part ? red + warp * HD : nullptr);
    if constexpr (CAT)
      ah_store<HD>(cat, 1.0f, catg + ob, L.do_row, r0, N, lane, nullptr);
  }
  if (!part) return;
  __syncthreads();
  const int nw = (nq + 15) / 16;  // the active warps, in order
  for (int d = tid; d < HD; d += nthr) {
    float v = 0.0f;
    for (int w = 0; w < nw; ++w) v += red[w * HD + d];
    part[((item * nqb + qz) * 3) * (long long)(H * HD) + h * HD + d] = v;
  }
}

template <int HD, int MODE>
__global__ void __launch_bounds__(AS_WARPS * 32, 1)
attn_bwd_head_cols_stream_kernel(const bf16* qg, const bf16* kg,
                                 const bf16* vg, const bf16* dog,
                                 const bf16* P, bf16* dkg, bf16* dvg,
                                 float* part, const float* stats,
                                 HeadLayout L, int N, float scale,
                                 float qscale, float c2) {
  constexpr bool RECOMP = MODE != AH_SAVED;
  constexpr int LD = HD + AH_PAD;
  constexpr int KS = HD / 16;
  constexpr int DT = HD / 8;
  constexpr uint32_t BLK = 16 * LD * 2;
  constexpr uint32_t SLOT = AS_KC * LD * 2;
  extern __shared__ __align__(16) uint8_t as_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(as_raw);  // [AS_QB][LD] (the keys)
  bf16* Vs = Ks + AS_QB * LD;                  // [AS_QB][LD]
  bf16* Qs = Vs + AS_QB * LD;                  // ring [2][AS_KC][LD]
  bf16* Os = Qs + 2 * AS_KC * LD;              // ring [2][AS_KC][LD] (dO)
  float* sst = reinterpret_cast<float*>(Os + 2 * AS_KC * LD);
  // sst: ring [2][3][AS_KC] of the queries' max * c2, 1 / sum and delta
  float* red = sst + 2 * 3 * AS_KC;  // [2][warps][HD]: dK, dV column sums

  const int h = blockIdx.x, H = gridDim.x;
  const long long item = blockIdx.y;
  const int kz = blockIdx.z, nkb = gridDim.z;
  const int k0 = kz * AS_QB, nk = min(AS_QB, N - k0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = warp * 16 < nk;
  const long long ib = item * L.in_item + (long long)h * HD;
  const long long ob = item * L.do_item + (long long)h * HD;
  const long long pbase = (item * H + h) * (long long)N * N;
  const float* sbase = stats + (item * H + h) * (long long)N * 3;
  const int nch = (N + AS_KC - 1) / AS_KC;

  // the queries' statistics of chunk `c` into ring slot `slot`; rows past
  // N get zeros (their Q and dO are zero too, so P and dS are 0 there)
  auto load_stats = [&](int c, int slot) {
    float* dst = sst + slot * 3 * AS_KC;
    for (int e = tid; e < 3 * AS_KC; e += nthr) {
      const int which = e / AS_KC, r = e % AS_KC, i = c * AS_KC + r;
      dst[e] = i < N ? sbase[(long long)i * 3 + which] : 0.0f;
    }
  };
  // Q of chunk `c` (pre-scaled in flash mode: this thread's own pieces,
  // once its copies have landed) and dO into ring slot `slot`
  auto load_qo = [&](int c, int slot) {
    ah_load_chunk<HD>(Qs + slot * AS_KC * LD, qg + ib, L.in_row, c * AS_KC, N,
                      tid, nthr);
    ah_load_chunk<HD>(Os + slot * AS_KC * LD, dog + ob, L.do_row, c * AS_KC,
                      N, tid, nthr);
  };

  ah_load_tile<HD>(Ks, kg + ib + (long long)k0 * L.in_row, L.in_row, nk,
                   AS_QB, tid, nthr);
  ah_load_tile<HD>(Vs, vg + ib + (long long)k0 * L.in_row, L.in_row, nk,
                   AS_QB, tid, nthr);
  ah_cp_commit();
  load_qo(0, 0);
  load_stats(0, 0);
  ah_cp_commit();
  ah_cp_wait_pending<1>();  // the block's K and V have landed
  __syncthreads();

  const uint32_t a_off = ah_a_off<HD>(lane), b_off = ah_b_off<HD>(lane);
  const uint32_t q_sm = ah_smem(Qs), o_sm = ah_smem(Os);
  const uint32_t ka = ah_smem(Ks) + warp * BLK + a_off;
  const int j0 = k0 + warp * 16 + g;  // this thread's keys: j0 and j0 + 8
  uint32_t va[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ah_ldsm(va[ks], ah_smem(Vs) + warp * BLK + a_off + ks * 32);
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int nt = 0; nt < DT; ++nt)
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) { dk[nt][c4] = 0.0f; dv[nt][c4] = 0.0f; }

  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_qo(c + 1, (c + 1) & 1);
      load_stats(c + 1, (c + 1) & 1);
      ah_cp_commit();
      ah_cp_wait_pending<1>();
    } else {
      ah_cp_wait_pending<0>();
    }
    if (MODE == AH_FLASH)
      ah_prescale_tile<HD>(Qs + (c & 1) * AS_KC * LD, qscale,
                           min(AS_KC, N - c * AS_KC), tid, nthr);
    __syncthreads();
    const int i0 = c * AS_KC;
    const int nb = (min(AS_KC, N - i0) + 15) / 16;
    const uint32_t qc = q_sm + (c & 1) * SLOT, oc = o_sm + (c & 1) * SLOT;
    const float* sm = sst + (c & 1) * 3 * AS_KC;
    for (int ib2 = 0; active && ib2 < nb; ++ib2) {
      float sT[2][4], dpT[2][4];
      ah_chunk<KS, RECOMP>(ka, va, qc + ib2 * BLK + b_off,
                           oc + ib2 * BLK + b_off, sT, dpT);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const int j = j0 + 8 * (c4 >> 1);
          const int r = ib2 * 16 + nt * 8 + 2 * t + (c4 & 1);  // in chunk
          const int i = i0 + r;
          float p;
          if (RECOMP)
            p = j < N ? exp2f(fmaf(sT[nt][c4], c2, -sm[r])) * sm[AS_KC + r]
                      : 0.0f;
          else
            p = (i < N && j < N) ? to_f(P[pbase + (long long)i * N + j])
                                 : 0.0f;
          sT[nt][c4] = p;
          dpT[nt][c4] = p * (dpT[nt][c4] - sm[2 * AS_KC + r]);
        }
      uint32_t a[4];
      ah_as_a(dpT, a);
      ah_accumulate<HD>(dk, a, qc + ib2 * BLK + a_off);
      ah_as_a(sT, a);
      ah_accumulate<HD>(dv, a, oc + ib2 * BLK + a_off);
    }
    __syncthreads();
  }
  if (active) {
    const long long ob2 = item * L.dq_item + (long long)h * HD;
    // flash: dK = dS^T . qm, the pre-scaled q (the ring holds it), unscaled
    ah_store<HD>(dk, MODE == AH_FLASH ? 1.0f : scale, dkg + ob2, L.dq_row,
                 j0, N, lane, part ? red + warp * HD : nullptr);
    ah_store<HD>(dv, 1.0f, dvg + ob2, L.dq_row, j0, N, lane,
                 part ? red + (AS_WARPS + warp) * HD : nullptr);
  }
  if (!part) return;
  __syncthreads();
  const int nw = (nk + 15) / 16;
  for (int e = tid; e < 2 * HD; e += nthr) {
    const int which = e / HD, d = e % HD;
    float v = 0.0f;
    for (int w = 0; w < nw; ++w) v += red[(which * AS_WARPS + w) * HD + d];
    part[((item * nkb + kz) * 3 + 1 + which) * (long long)(H * HD) + h * HD +
         d] = v;
  }
}

// The streamed kernels' shared memory, whatever N: the rows kernel's Q and
// dO blocks, its K and V ring and the warps' dQ column sums; the column
// kernel's K and V blocks, its Q and dO ring, the statistics ring and the
// dK and dV column sums.
__host__ __device__ inline size_t attn_bwd_head_rows_stream_smem(int hd) {
  return (size_t)(2 * AS_QB + 4 * AS_KC) * (hd + AH_PAD) * sizeof(bf16) +
         (size_t)AS_WARPS * hd * sizeof(float);
}
__host__ __device__ inline size_t attn_bwd_head_cols_stream_smem(int hd) {
  return (size_t)(2 * AS_QB + 4 * AS_KC) * (hd + AH_PAD) * sizeof(bf16) +
         (size_t)(2 * 3 * AS_KC + 2 * AS_WARPS * hd) * sizeof(float);
}

// Rows of the part buffer an item takes: 1 resident, one a query block
// streamed.
inline int attn_part_rows(int N) {
  return attn_streams_keys(N) ? (N + AS_QB - 1) / AS_QB : 1;
}

template <int HD, int MODE>
int attn_bwd_head_stream_launch(const bf16* q, const bf16* k, const bf16* v,
                                const bf16* dO, const bf16* P, bf16* dq,
                                bf16* dk, bf16* dv, bf16* cat, float* part,
                                float* stats, const HeadLayout& L, int items,
                                int H, int N, float scale, float qscale,
                                cudaStream_t st) {
  auto rows = attn_bwd_head_rows_stream_kernel<HD, MODE>;
  auto cols = attn_bwd_head_cols_stream_kernel<HD, MODE>;
  const size_t smem_r = attn_bwd_head_rows_stream_smem(HD);
  const size_t smem_c = attn_bwd_head_cols_stream_smem(HD);
  cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_r);
  cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_c);
  FC_CHECK();
  const dim3 grid(H, items, (N + AS_QB - 1) / AS_QB);
  const float c2 = scale * AH_LOG2E;
  rows<<<grid, AS_WARPS * 32, smem_r, st>>>(q, k, v, dO, P, dq, cat, part,
                                            stats, L, N, scale, qscale, c2);
  FC_CHECK();
  cols<<<grid, AS_WARPS * 32, smem_c, st>>>(q, k, v, dO, P, dk, dv, part,
                                            stats, L, N, scale, qscale, c2);
  FC_CHECK();
  return 0;
}

// Four tiles, the row statistics and, with column sums, their staging.
inline size_t attn_bwd_head_smem(int N, int hd, bool colsums) {
  const int nblk = (N + 15) / 16, NP = nblk * 16;
  return (size_t)4 * NP * (hd + AH_PAD) * sizeof(bf16) +
         (size_t)(3 * NP + (colsums ? 3 * nblk * hd : 0)) * sizeof(float);
}

template <int HD, int MODE>
int attn_bwd_head_launch(const bf16* q, const bf16* k, const bf16* v,
                         const bf16* dO, const bf16* P, bf16* dq, bf16* dk,
                         bf16* dv, bf16* cat, float* part, const HeadLayout& L,
                         int items, int H, int N, float scale, float qscale,
                         cudaStream_t st) {
  auto kern = attn_bwd_head_kernel<HD, MODE>;
  const size_t smem = attn_bwd_head_smem(N, HD, part != nullptr);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  FC_CHECK();
  const int nblk = (N + 15) / 16;
  const int warps = nblk < ah_maxw<MODE>() ? nblk : ah_maxw<MODE>();
  kern<<<dim3(H, items), warps * 32, smem, st>>>(q, k, v, dO, P, dq, dk, dv,
                                                 cat, part, L, N, scale,
                                                 qscale, scale * AH_LOG2E);
  FC_CHECK();
  return 0;
}

// hd in {16, 32, 64}, or cudaErrorInvalidValue.  mode AH_SAVED reads P;
// AH_RECOMP writes cat [as dO]; AH_FLASH takes qscale (and scale = 1), a
// null part and no cat.  Past AT_RESIDENT_N the streamed kernels run: they
// take stats [items, H, N, 3] f32 (or cudaErrorInvalidValue) and write part
// as [items * attn_part_rows(N), 3, H*hd].
inline int attn_bwd_head(const bf16* q, const bf16* k, const bf16* v,
                         const bf16* dO, const bf16* P, bf16* dq, bf16* dk,
                         bf16* dv, bf16* cat, float* part, float* stats,
                         const HeadLayout& L, int items, int H, int N, int hd,
                         float scale, float qscale, int mode,
                         cudaStream_t st) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const bool stream = attn_streams_keys(N);
  if (stream && !stats) return (int)cudaErrorInvalidValue;
#define FC_HEAD(HD_, MODE_)                                                 \
  if (hd == HD_ && mode == MODE_)                                           \
    return stream ? attn_bwd_head_stream_launch<HD_, MODE_>(                \
                        q, k, v, dO, P, dq, dk, dv, cat, part, stats, L,    \
                        items, H, N, scale, qscale, st)                     \
                  : attn_bwd_head_launch<HD_, MODE_>(q, k, v, dO, P, dq,    \
                                                     dk, dv, cat, part, L,  \
                                                     items, H, N, scale,    \
                                                     qscale, st);
#define FC_HEADS(MODE_) FC_HEAD(16, MODE_) FC_HEAD(32, MODE_) FC_HEAD(64, MODE_)
  FC_HEADS(AH_SAVED)
  FC_HEADS(AH_RECOMP)
  FC_HEADS(AH_FLASH)
#undef FC_HEADS
#undef FC_HEAD
  return (int)cudaErrorInvalidValue;
}

}  // namespace
