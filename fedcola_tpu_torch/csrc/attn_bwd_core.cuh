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
#include "attn_wgmma.cuh"

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

// ---- streamed (N > AT_RESIDENT_N), redesigned for Hopper ----
//
// Two kernels on the same stream, grid (H, items, ceil(N / AS_QB)) each,
// AS_THREADS threads (attn_wgmma.cuh: two warpgroups of 64 rows, TMA into
// a ring of AS_ST stages, wgmma), shared memory a constant whatever N, and
// the row statistics through device memory in between:
//   rows     one block an SM.  The block's 128 queries' Q and dO are
//            loaded once; K and V (and saved P) stream in AS_KC-key
//            chunks, twice.  Pass 1, two chunks a batch, the row
//            statistics (recompute: S = Q.K^T and dP = dO.V^T, the online
//            max and sum with delta's numerator carried under the same
//            rescaling; saved P: dP and delta = rowsum(P o dP)), written to
//            stats [items, H, N, 3] (max * c2, 1 / sum, delta); pass 2 P
//            (f32), dS = T(P o (dP - delta)) and dQ += dS.K (RS, K read
//            MN-major), and in mode AH_RECOMP cat += T(P).V, in one batch
//            with the next chunk's S and dP.
//   columns  two blocks an SM: the block's 128 keys' K and V are loaded
//            once; Q, dO (and saved P) stream in AS_QC-query chunks, the
//            queries' statistics beside them (loaded by the lanes of the
//            warp that refills the stage).  S^T = K.Q^T (recompute) and
//            dP^T = V.dO^T (m64n32); P^T and dS^T from the statistics,
//            rounded into A fragments as they are formed; dV += T(P^T).dO
//            and dK += dS^T.Q (RS).  32-query chunks keep its registers
//            under the 128 of two blocks an SM, whose four warpgroups hide
//            each other's waits (one block of 64-query chunks measured
//            1.4-1.6x as long on an H100).
// Saved P moves as TMA tiles where its rows are 16-byte aligned
// (as_p_tiles: N % 8 == 0; the row kernel's tile is [queries][keys], the
// column kernel's the same tile read transposed), and is otherwise read
// from device memory element by element: the second path, chosen by shape.
// In flash mode Q is pre-scaled in shared memory before any product (in
// the column kernel by both warpgroups, then a barrier of the two).
// Every value has one writer.  Column sums go to part [items * nqb, 3,
// H*hd] (nqb = ceil(N / AS_QB); row item * nqb + block), each block's
// eight warps summed in order, dQ's by the row kernel and dK's and dV's by
// the column kernel; the caller sums the rows of a client in a fixed order.
//
// What bounds them: at N = 512 the S / dP products and P's bytes in saved
// mode (row 2: 1152 heads x 512^2 bf16 = 604 MB read twice by the row
// kernel and once by the column kernel); recompute and flash add the exp2
// of every element in each pass.
template <int HD, int MODE, bool PTMA>
__global__ void __launch_bounds__(AS_THREADS, 1)
attn_bwd_head_rows_stream_kernel(const __grid_constant__ AsBwdArgs g) {
  constexpr bool RECOMP = MODE != AH_SAVED;
  constexpr bool CAT = MODE == AH_RECOMP;
  constexpr bool TP = !RECOMP && PTMA;  // P tiles through the ring
  constexpr int KS = HD / 16;
  constexpr uint32_t STAGE = (TP ? 4 : 2) * AS_BOX;  // K, V [, P 128 x 64]
  extern __shared__ uint8_t as_raw[];
  const uint32_t qt = (smem_u32(as_raw) + 1023u) & ~1023u;  // Q, 2 boxes
  const uint32_t ot = qt + 2 * AS_BOX;                     // dO, 2 boxes
  const uint32_t ring = ot + 2 * AS_BOX;
  const uint32_t red = ring + AS_ST * STAGE;               // [8 warps][HD]
  const uint32_t qbar = red + 8 * 64 * 4;
  const uint32_t full = qbar + 8, cnt = full + 8 * AS_ST;

  const int h = blockIdx.x, item = blockIdx.y, qz = blockIdx.z;
  const int q0 = qz * AS_QB, N = g.N;
  const int nch = (N + AS_KC - 1) / AS_KC, iters = 2 * nch;
  // ring iteration it: chunk it (pass 1) or it - nch (pass 2) of K (saved
  // P's pass 1 needs none), V and saved P in tiles
  auto load = [&](int it) {
    const int st = it % AS_ST;
    const bool p2 = it >= nch;
    const bool k = RECOMP || p2;
    const int j0 = (p2 ? it - nch : it) * AS_KC;
    const uint32_t slot = ring + st * STAGE, fb = full + 8 * st;
    mbar_expect_tx(fb, (k ? 2 : 1) * AS_BOX + (TP ? 2 * AS_BOX : 0));
    if (k) tma_load(slot, &g.k.map, fb, g.k.col + h * HD, j0, item);
    tma_load(slot + AS_BOX, &g.v.map, fb, g.v.col + h * HD, j0, item);
    if (TP)
      for (int b = 0; b < 2; ++b)
        tma_load(slot + (2 + b) * AS_BOX, &g.p, fb, j0, q0 + 64 * b,
                 item * g.H + h);
  };
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < AS_ST; ++s) {
      mbar_init(full + 8 * s, 1);
      as_st32(cnt + 4 * s, 0u);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, 4 * AS_BOX);
    for (int b = 0; b < 2; ++b) {
      tma_load(qt + b * AS_BOX, &g.q.map, qbar, g.q.col + h * HD,
               q0 + 64 * b, item);
      tma_load(ot + b * AS_BOX, &g.o.map, qbar, g.o.col + h * HD,
               q0 + 64 * b, item);
    }
    for (int it = 0; it < AS_ST; ++it) load(it);
  }
  __syncthreads();

  // warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, rl = 16 * warp + (lane >> 2);
  const int r0 = q0 + 64 * wg + rl;  // this thread's rows: r0 and r0 + 8
  const uint32_t qa = qt + wg * AS_BOX, oa = ot + wg * AS_BOX;
  const float c2 = g.c2;
  const bf16* prow = RECOMP ? nullptr
                            : g.P + ((long long)item * g.H + h) * N * N;
  auto release = [&](int it) {
    if (as_release(cnt + 4 * (it % AS_ST), lane) && lane == 0 &&
        it + AS_ST < iters)
      load(it + AS_ST);
  };
  mbar_wait(qbar, 0);
  if (MODE == AH_FLASH) {
    as_prescale(qa, AS_BOX, g.qscale, tid, 128);
    as_fence_async();
    as_bar(1 + wg, 128);
  }
  // saved P at (row r0 + 8 hh, key j0 + 8 j + 2t + e), e = 0, 1
  auto p_pair = [&](uint32_t slot, int j0, int j, int hh) -> float2 {
    if constexpr (TP) {
      return unpack_bf16x2(as_ld32(slot + (2 + wg) * AS_BOX +
                                   as_sw(rl + 8 * hh, 8 * j + 2 * t)));
    } else {
      const int i = r0 + 8 * hh, c = j0 + 8 * j + 2 * t;
      float2 p = make_float2(0.0f, 0.0f);
      if (i < N && c < N) {
        const bf16* at = prow + (long long)i * N + c;
        p.x = to_f(at[0]);
        if (c + 1 < N) p.y = to_f(at[1]);
      }
      return p;
    }
  };

  // pass 1: the row statistics, two chunks' products a wgmma batch
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float dl[2] = {0.0f, 0.0f};
  // S (recompute; s is not read otherwise) and dP of ring iteration `it`,
  // issued (the caller commits)
  auto issue = [&](float (&s)[32], float (&dp)[32], int it) {
    const int st = it % AS_ST;
    const uint32_t slot = ring + st * STAGE;
    mbar_wait(full + 8 * st, (it / AS_ST) & 1);
    if constexpr (RECOMP) as_issue_ss<KS>(s, qa, slot);
    as_issue_ss<KS>(dp, oa, slot + AS_BOX);
  };
  auto stats = [&](float (&s)[32], float (&dp)[32], int c) {
    const uint32_t slot = ring + (c % AS_ST) * STAGE;
    if constexpr (RECOMP) as_keep(s);
    as_keep(dp);
    const int j0 = c * AS_KC;
    if constexpr (RECOMP) {
      if (j0 + AS_KC > N) as_mask_cols(s, j0 + 2 * t, N);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float cm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          cm = fmaxf(cm, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
        const float mn = fmaxf(m[hh], cm);
        const float corr = exp2f((m[hh] - mn) * c2);
        l[hh] *= corr;
        dl[hh] *= corr;
        m[hh] = mn;
        const float mc = mn * c2;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = exp2f(fmaf(s[4 * j + 2 * hh + e], c2, -mc));
            l[hh] += x;
            dl[hh] += x * dp[4 * j + 2 * hh + e];
          }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 p = p_pair(slot, j0, j, hh);
          dl[hh] += p.x * dp[4 * j + 2 * hh] + p.y * dp[4 * j + 2 * hh + 1];
        }
    }
    release(c);
  };
  for (int c = 0; c < nch; c += 2) {
    float sa[32], dpa[32], sb[32], dpb[32];
    const bool two = c + 1 < nch;
    wgmma_fence();
    issue(sa, dpa, c);
    if (two) issue(sb, dpb, c + 1);
    wgmma_commit();
    wgmma_wait<0>();
    stats(sa, dpa, c);
    if (two) stats(sb, dpb, c + 1);
  }
  float il[2], delta[2], mc[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    dl[hh] += __shfl_xor_sync(0xffffffffu, dl[hh], 1);
    dl[hh] += __shfl_xor_sync(0xffffffffu, dl[hh], 2);
    mc[hh] = m[hh] * c2;
    if (RECOMP) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      il[hh] = 1.0f / l[hh];
      delta[hh] = dl[hh] * il[hh];
    } else {
      il[hh] = 0.0f;
      delta[hh] = dl[hh];
    }
    const int i = r0 + 8 * hh;
    if (t == 0 && i < N) {
      float* sp = g.stats + (((long long)item * g.H + h) * N + i) * 3;
      sp[0] = mc[hh];
      sp[1] = il[hh];
      sp[2] = delta[hh];
    }
  }

  // pass 2: dQ (and cat).  dS(c).K(c) (and P(c).V(c)) and the next chunk's
  // S and dP are one wgmma batch.
  float dq[32], cat[CAT ? 32 : 1], s[32], dp[32];
  uint32_t ads[4][4], ap[CAT ? 4 : 1][4];
  wgmma_fence();
  issue(s, dp, nch);
  wgmma_commit();
  wgmma_wait<0>();
  for (int c = 0; c < nch; ++c) {
    const int it = nch + c;
    const uint32_t slot = ring + (it % AS_ST) * STAGE;
    if constexpr (RECOMP) as_keep(s);
    as_keep(dp);
    const int j0 = c * AS_KC;
    if constexpr (RECOMP) {
      if (j0 + AS_KC > N) as_mask_cols(s, j0 + 2 * t, N);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[4 * j + q] =
              exp2f(fmaf(s[4 * j + q], c2, -mc[q >> 1])) * il[q >> 1];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 p = p_pair(slot, j0, j, hh);
          s[4 * j + 2 * hh] = p.x;
          s[4 * j + 2 * hh + 1] = p.y;
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dp[4 * j + q] = s[4 * j + q] * (dp[4 * j + q] - delta[q >> 1]);
    as_frag(dp, ads);
    if constexpr (CAT) as_frag(s, ap);
    wgmma_fence();
    if (c + 1 < nch) issue(s, dp, it + 1);
    as_issue_rs(dq, ads, slot, c);
    if constexpr (CAT) as_issue_rs(cat, ap, slot + AS_BOX, c);
    wgmma_commit();
    wgmma_wait<0>();
    as_keep(dq);
    as_keep(ads);
    if constexpr (CAT) {
      as_keep(cat);
      as_keep(ap);
    }
    release(it);
  }
  float* redp = reinterpret_cast<float*>(as_raw + (red - smem_u32(as_raw)));
  bf16* dq_out = g.dq + (long long)item * g.g_item + h * HD;
  if constexpr (MODE == AH_FLASH)
    as_store<HD, true>(dq, g.qscale, dq_out, g.g_row, r0, N, lane, nullptr);
  else
    as_store<HD>(dq, g.scale, dq_out, g.g_row, r0, N, lane,
                 g.part ? redp + (4 * wg + warp) * HD : nullptr);
  if constexpr (CAT)
    as_store<HD>(cat, 1.0f, g.cat + (long long)item * g.o_item + h * HD,
                 g.o_row, r0, N, lane, nullptr);
  if (!g.part) return;
  as_bar(3, 256);
  for (int d = threadIdx.x; d < HD; d += 256) {
    float v = 0.0f;
    for (int w = 0; w < 8; ++w) v += redp[w * HD + d];
    g.part[((long long)(item * gridDim.z + qz) * 3) * (g.H * HD) + h * HD +
           d] = v;
  }
}

template <int HD, int MODE, bool PTMA>
__global__ void __launch_bounds__(AS_THREADS, 2)
attn_bwd_head_cols_stream_kernel(const __grid_constant__ AsBwdArgs g) {
  constexpr bool RECOMP = MODE != AH_SAVED;
  constexpr bool TP = !RECOMP && PTMA;
  constexpr int KS = HD / 16;
  constexpr uint32_t QBOX = AS_QC * 64 * 2;  // a 32-row box
  // Q, dO [, P: 32 queries x 128 keys as two boxes], the statistics
  constexpr uint32_t STATS = (TP ? 4 : 2) * QBOX;
  constexpr uint32_t STAGE = STATS + 1024;
  extern __shared__ uint8_t as_raw[];
  const uint32_t kt = (smem_u32(as_raw) + 1023u) & ~1023u;  // K, 2 boxes
  const uint32_t vt = kt + 2 * AS_BOX;                     // V, 2 boxes
  const uint32_t ring = vt + 2 * AS_BOX;
  const uint32_t red = ring + AS_ST * STAGE;  // [2][8 warps][HD] f32
  const uint32_t kbar = red + 2 * 8 * 64 * 4;
  const uint32_t full = kbar + 8, cnt = full + 8 * AS_ST;

  const int h = blockIdx.x, item = blockIdx.y, kz = blockIdx.z;
  const int k0 = kz * AS_QB, N = g.N;
  const int nch = (N + AS_QC - 1) / AS_QC;
  const int lane = threadIdx.x & 31;
  const float* sbase = g.stats + ((long long)item * g.H + h) * N * 3;
  // chunk it of Q, dO and saved P in tiles (lane 0's TMA), and the
  // queries' max * c2, 1 / sum and delta, [3][AS_QC], every lane's loads
  // (rows past N get zeros: their Q and dO are zero too, so P and dS are 0
  // there).  A warp calls it; each lane arrives once on the full barrier.
  auto load = [&](int it) {
    const int st = it % AS_ST;
    const int i0 = it * AS_QC;
    const uint32_t slot = ring + st * STAGE, fb = full + 8 * st;
    for (int e = lane; e < 3 * AS_QC; e += 32) {
      const int which = e / AS_QC, i = i0 + e % AS_QC;
      as_st_f32(slot + STATS + 4 * e,
                i < N ? sbase[(long long)i * 3 + which] : 0.0f);
    }
    __syncwarp();
    if (lane == 0) {
      mbar_expect_tx(fb, (TP ? 4 : 2) * QBOX);
      tma_load(slot, &g.qc.map, fb, g.qc.col + h * HD, i0, item);
      tma_load(slot + QBOX, &g.oc.map, fb, g.oc.col + h * HD, i0, item);
      if (TP)
        for (int b = 0; b < 2; ++b)
          tma_load(slot + (2 + b) * QBOX, &g.pc, fb, k0 + 64 * b, i0,
                   item * g.H + h);
    } else {
      mbar_arrive(fb);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(kbar, 1);
    for (int s = 0; s < AS_ST; ++s) {
      mbar_init(full + 8 * s, 32);  // a warp's lanes
      as_st32(cnt + 4 * s, 0u);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kbar, 4 * AS_BOX);
    for (int b = 0; b < 2; ++b) {
      tma_load(kt + b * AS_BOX, &g.k.map, kbar, g.k.col + h * HD,
               k0 + 64 * b, item);
      tma_load(vt + b * AS_BOX, &g.v.map, kbar, g.v.col + h * HD,
               k0 + 64 * b, item);
    }
  }
  __syncthreads();
  if (threadIdx.x < 32)
    for (int it = 0; it < AS_ST; ++it) load(it);

  // warpgroup wg owns keys k0 + 64 wg .. + 63
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5;
  const int t = lane & 3, jl = 16 * warp + (lane >> 2);
  const int j0 = k0 + 64 * wg + jl;  // this thread's keys: j0 and j0 + 8
  const uint32_t ka = kt + wg * AS_BOX, va = vt + wg * AS_BOX;
  const float c2 = g.c2;
  const bf16* pbase = RECOMP ? nullptr
                             : g.P + ((long long)item * g.H + h) * N * N;
  auto release = [&](int it) {
    if (as_release(cnt + 4 * (it % AS_ST), lane) && it + AS_ST < nch)
      load(it + AS_ST);
  };
  mbar_wait(kbar, 0);
  float dk[32], dv[32];
  for (int c = 0; c < nch; ++c) {
    const int st = c % AS_ST;
    const uint32_t slot = ring + st * STAGE;
    mbar_wait(full + 8 * st, (c / AS_ST) & 1);
    if (MODE == AH_FLASH) {
      as_prescale(slot, QBOX, g.qscale, threadIdx.x, 256);
      as_fence_async();
      as_bar(3, 256);
    }
    float sT[16], dpT[16];
    wgmma_fence();
    if constexpr (RECOMP) as_issue_ss<KS>(sT, ka, slot);
    as_issue_ss<KS>(dpT, va, slot + QBOX);
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (RECOMP) as_keep(sT);
    as_keep(dpT);
    const int i0 = c * AS_QC;
    const uint32_t sm = slot + STATS;
    // P^T and dS^T, rounded into the A fragments as they are formed:
    // columns 8j + 2t + e of rows jl + 8 hh are a[j / 2][2 (j % 2) + hh]
    uint32_t ap[2][4], ads[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[2][2], ds[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * j + 2 * t + e;  // the query, in the chunk
        const float dlt = as_ld_f32(sm + 4 * (2 * AS_QC + r));
        float mr = 0.0f, ilr = 0.0f;
        if constexpr (RECOMP) {
          mr = as_ld_f32(sm + 4 * r);
          ilr = as_ld_f32(sm + 4 * (AS_QC + r));
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          float pv;
          if constexpr (RECOMP) {
            pv = j0 + 8 * hh < N ? exp2f(fmaf(sT[x], c2, -mr)) * ilr : 0.0f;
          } else if constexpr (TP) {
            pv = as_ld_bf16(slot + (2 + wg) * QBOX + as_sw(r, jl + 8 * hh));
          } else {
            const int i = i0 + r, jj = j0 + 8 * hh;
            pv = (i < N && jj < N) ? to_f(pbase[(long long)i * N + jj]) : 0.0f;
          }
          p[hh][e] = pv;
          ds[hh][e] = pv * (dpT[x] - dlt);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        ap[j >> 1][2 * (j & 1) + hh] = ah_pack(p[hh][0], p[hh][1]);
        ads[j >> 1][2 * (j & 1) + hh] = ah_pack(ds[hh][0], ds[hh][1]);
      }
    }
    wgmma_fence();
    as_issue_rs(dv, ap, slot + QBOX, c);
    as_issue_rs(dk, ads, slot, c);
    wgmma_commit();
    wgmma_wait<0>();
    as_keep(dv);
    as_keep(dk);
    as_keep(ap);
    as_keep(ads);
    release(c);
  }
  float* redp = reinterpret_cast<float*>(as_raw + (red - smem_u32(as_raw)));
  const long long ob = (long long)item * g.g_item + h * HD;
  // flash: dK = dS^T . qm, the pre-scaled q (the ring holds it), unscaled
  as_store<HD>(dk, MODE == AH_FLASH ? 1.0f : g.scale, g.dk + ob, g.g_row, j0,
               N, lane, g.part ? redp + (4 * wg + warp) * HD : nullptr);
  as_store<HD>(dv, 1.0f, g.dv + ob, g.g_row, j0, N, lane,
               g.part ? redp + (8 + 4 * wg + warp) * HD : nullptr);
  if (!g.part) return;
  as_bar(3, 256);
  for (int e = threadIdx.x; e < 2 * HD; e += 256) {
    const int which = e / HD, d = e % HD;
    float v = 0.0f;
    for (int w = 0; w < 8; ++w) v += redp[(which * 8 + w) * HD + d];
    g.part[((long long)(item * gridDim.z + kz) * 3 + 1 + which) *
               (g.H * HD) + h * HD + d] = v;
  }
}

// The streamed kernels' shared memory, whatever N (and whatever hd): the
// row kernel's Q and dO boxes, its ring (K, V and with P tiles P) and the
// warps' dQ column sums; the column kernel's K and V boxes, its ring (Q,
// dO, with P tiles P, and the statistics) and the dK and dV column sums.
__host__ __device__ inline size_t attn_bwd_head_rows_stream_smem(bool tiles) {
  return 1024 + (size_t)(4 + AS_ST * (tiles ? 4 : 2)) * AS_BOX +
         8 * 64 * 4 + 8 * (1 + AS_ST) + 4 * AS_ST;
}
__host__ __device__ inline size_t attn_bwd_head_cols_stream_smem(bool tiles) {
  return 1024 + (size_t)4 * AS_BOX +
         (size_t)AS_ST * ((tiles ? 4 : 2) * AS_QC * 128 + 1024) +
         2 * 8 * 64 * 4 + 8 * (1 + AS_ST) + 4 * AS_ST;
}

// Rows of the part buffer an item takes: 1 resident, one a query block
// streamed.
inline int attn_part_rows(int N) {
  return attn_streams_keys(N) ? (N + AS_QB - 1) / AS_QB : 1;
}

template <int HD, int MODE, bool PTMA>
int attn_bwd_head_stream_launch(const AsBwdArgs& g, int items,
                                cudaStream_t st) {
  auto rows = attn_bwd_head_rows_stream_kernel<HD, MODE, PTMA>;
  auto cols = attn_bwd_head_cols_stream_kernel<HD, MODE, PTMA>;
  const bool tiles = MODE == AH_SAVED && PTMA;
  const size_t smem_r = attn_bwd_head_rows_stream_smem(tiles);
  const size_t smem_c = attn_bwd_head_cols_stream_smem(tiles);
  cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_r);
  cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_c);
  FC_CHECK();
  const dim3 grid(g.H, items, (g.N + AS_QB - 1) / AS_QB);
  rows<<<grid, AS_THREADS, smem_r, st>>>(g);
  FC_CHECK();
  cols<<<grid, AS_THREADS, smem_c, st>>>(g);
  FC_CHECK();
  return 0;
}

// The maps and scalars of one streamed backward; q, k, v, dO as AsSrc,
// dq / dk / dv rows at item * g_item + r * g_row, cat rows as dO's.
template <int MODE>
int attn_bwd_head_stream(const AsSrc& q, const AsSrc& k, const AsSrc& v,
                         const AsSrc& o, const bf16* P, bf16* dq, bf16* dk,
                         bf16* dv, long long g_item, int g_row, bf16* cat,
                         float* part, float* stats, int items, int H, int N,
                         int hd, float scale, float qscale, cudaStream_t st) {
  AsBwdArgs g = {};
  int err;
  if ((err = as_map(&g.q.map, q, N, items)) ||
      (err = as_map(&g.k.map, k, N, items)) ||
      (err = as_map(&g.v.map, v, N, items)) ||
      (err = as_map(&g.o.map, o, N, items)) ||
      (err = as_map(&g.qc.map, q, N, items, AS_QC)) ||
      (err = as_map(&g.oc.map, o, N, items, AS_QC)))
    return err;
  g.q.col = g.qc.col = q.col; g.k.col = k.col; g.v.col = v.col;
  g.o.col = g.oc.col = o.col;
  const bool ptma = MODE == AH_SAVED && as_p_tiles(P, N);
  if (ptma) {
    const AsSrc p = {P, (long long)N * N, N, N, 0};
    if ((err = as_map(&g.p, p, N, items * H)) ||
        (err = as_map(&g.pc, p, N, items * H, AS_QC)))
      return err;
  }
  g.P = P; g.dq = dq; g.dk = dk; g.dv = dv;
  g.g_item = g_item; g.g_row = g_row;
  g.cat = cat; g.o_item = o.item; g.o_row = o.row;
  g.part = part; g.stats = stats;
  g.N = N; g.H = H;
  g.scale = scale; g.qscale = qscale; g.c2 = scale * AH_LOG2E;
#define FC_AS_BWD(HD_)                                                      \
  if (hd == HD_) {                                                          \
    if constexpr (MODE == AH_SAVED) {                                       \
      if (ptma)                                                             \
        return attn_bwd_head_stream_launch<HD_, MODE, true>(g, items, st);  \
    }                                                                       \
    return attn_bwd_head_stream_launch<HD_, MODE, false>(g, items, st);     \
  }
  FC_AS_BWD(16)
  FC_AS_BWD(32)
  FC_AS_BWD(64)
#undef FC_AS_BWD
  return (int)cudaErrorInvalidValue;
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

// hd in {16, 32, 64}, or cudaErrorInvalidValue.  MODE AH_SAVED reads P;
// AH_RECOMP writes cat [as dO]; AH_FLASH takes qscale (and scale = 1), a
// null part and no cat (a template argument, so that each caller builds
// only the kernels of its modes).  Past AT_RESIDENT_N the streamed kernels run: they
// take stats [items, H, N, 3] f32 (or cudaErrorInvalidValue) and write part
// as [items * attn_part_rows(N), 3, H*hd].  packed = D where k = q + D and
// v = q + 2D are the packed qkv layout's columns (one map over its rows),
// 0 where q, k and v are separate tensors.
template <int MODE>
int attn_bwd_head(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* dO, const bf16* P, bf16* dq, bf16* dk, bf16* dv,
                  bf16* cat, float* part, float* stats, const HeadLayout& L,
                  int items, int H, int N, int hd, float scale, float qscale,
                  int packed, cudaStream_t st) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  if (attn_streams_keys(N)) {
    if (!stats) return (int)cudaErrorInvalidValue;
    AsSrc qs = {q, L.in_item, L.in_row, L.in_row, 0}, ks = qs, vs = qs;
    if (packed) {
      ks.col = packed;
      vs.col = 2 * packed;
    } else {
      ks.ptr = k;
      vs.ptr = v;
    }
    const AsSrc os = {dO, L.do_item, L.do_row, L.do_row, 0};
    return attn_bwd_head_stream<MODE>(qs, ks, vs, os, P, dq, dk, dv,
                                      L.dq_item, L.dq_row, cat, part, stats,
                                      items, H, N, hd, scale, qscale, st);
  }
#define FC_HEAD(HD_)                                                        \
  if (hd == HD_)                                                            \
    return attn_bwd_head_launch<HD_, MODE>(q, k, v, dO, P, dq, dk, dv, cat, \
                                           part, L, items, H, N, scale,     \
                                           qscale, st);
  FC_HEAD(16)
  FC_HEAD(32)
  FC_HEAD(64)
#undef FC_HEAD
  return (int)cudaErrorInvalidValue;
}

}  // namespace
