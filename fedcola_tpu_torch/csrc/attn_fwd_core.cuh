// Attention core forward per (item, head) on tensor cores, bf16:
//     S = scale * Q . K^T (Q optionally pre-scaled and rounded first),
//     P = T(softmax_f32(S)),  O = T(P . V),  P optionally written.
// The sibling of attn_bwd_core.cuh and in its idiom (attn_mma.cuh).  It
// replaces the CUDA-core attn_core_fwd (attn_core.cuh) for bf16 at head_dim
// 16, 32 or 64 and every N; flash_fwd.cu runs it on unpacked [pairs, N,
// hd] tensors (the TPU kernel _fwd_kernel of
// fedcola_tpu/ops/flash_attention.py), and attn_fwd_head_packed gives the
// fused sublayer's packed qkv / cat layout with P saved (the per-head part
// of _fwd_save_call and _fwd_call of fedcola_tpu/ops/fused_attention.py).
//
// Two kernels, chosen by N alone (attn_streams_keys, attn_core.cuh): up to
// AT_RESIDENT_N = 256 keys the resident kernel below, past it the streamed
// kernel further down (attn_fwd_head_stream_kernel), whose shared memory
// does not grow with N.
//
// Resident: one block per (head, item): Q, K and V of the head go once
// into shared memory as padded bf16 tiles (cp.async; rows N..NP-1 zeroed,
// NP = N rounded up to 16; 88 KB at N = 197, hd = 64), flash attention's
// pre-scaled q is rounded there, and each warp owns 16-query blocks with
// its Q fragments in registers.  Products are
// mma.sync.m16n8k16 fed by ldmatrix (ldmatrix.trans for V in P . V).
//
// Two passes over the keys in 16-wide chunks, not an online softmax: the
// TPU kernels round P = exp(s - max) / sum after normalisation and before
// P . V, and an online softmax would round exp(s - running max) and divide
// at the end.  Pass 1 forms S chunk by chunk for the row max and the sum
// (the sum carried under the running max); pass 2 forms S again, P =
// T(exp(s - max) * (1 / sum)), whose rounded accumulator fragment is the A
// fragment of P . V, accumulated in f32.  exp(scale * x) is taken as
// exp2(scale * log2(e) * x), one fma and one ex2 an element: against the
// TPU kernel's exp and division a difference in the last bits of the f32 P,
// before its rounding to bf16.  The second S product costs
// 2 N^2 hd a head, far below what the bytes allow.  Padded keys score -inf
// (P = 0); padded query rows are computed and not stored.  Every sum has
// one owner and a fixed order: the same bits on every call.
//
// The P store.  A row of P has N elements and N = 197 is odd, so from the
// accumulator fragment a lane could only write single bf16 values (2 bytes
// to each of 8 rows a warp-wide store): with 89 MB of P a training call those
// stores were half the kernel's time.  A warp's 16 query rows are one
// contiguous span of 16 N elements of P, so the warp collects its rounded
// P in shared memory behind the tiles, at the span's own offset within a
// 16-byte line, and writes the span out in whole aligned lines after pass
// 2 (one writer per element, the same values).  Where the tiles leave no
// room (head_dim 64, N > 232) the fragment is stored directly, value by
// value.
#pragma once

#include "attn_core.cuh"
#include "attn_mma.cuh"

namespace {

constexpr int AF_MAXW = 16;  // warps a block: one per 16-query block
constexpr size_t AF_MAX_SMEM = 232448;  // dynamic shared memory a block

// bf16 elements of the P staging buffer of one warp: 16 rows of N keys and
// up to 7 elements of offset, in whole 16-byte lines.
__host__ __device__ inline int af_stage_elems(int N) {
  return (16 * N + 7 + 7) / 8 * 8;
}

// grid (H, items), 32 * min(AF_MAXW, ceil(N / 16)) threads.  score = scale
// * (q . k), given as c2 = scale * log2(e): exp(scale * x) = exp2(c2 * x),
// one fma and one ex2 an element.  qscale != 0 first rounds q to T(q *
// qscale).  SAVE: P [items, H, N, N] is written; `stage`: through
// af_stage_elems(N) more bf16 of shared memory a warp, behind the tiles.
// Without SAVE the kernel holds no code for P (flash attention's forward).
template <int HD, bool SAVE>
__global__ void __launch_bounds__(AF_MAXW * 32, 1)
attn_fwd_head_kernel(const bf16* qg, const bf16* kg, const bf16* vg, bf16* og,
                     bf16* P, CoreLayout L, int N, float c2, float qscale,
                     int stage) {
  constexpr int LD = HD + AH_PAD;  // elements a shared row
  constexpr int KS = HD / 16;  // k16 steps over the head dim
  constexpr int DT = HD / 8;   // n8 tiles over the head dim
  extern __shared__ __align__(16) uint8_t af_raw[];
  const int nblk = (N + 15) / 16, NP = nblk * 16;
  bf16* Qs = reinterpret_cast<bf16*>(af_raw);
  bf16* Ks = Qs + NP * LD;
  bf16* Vs = Ks + NP * LD;

  const int h = blockIdx.x, H = gridDim.x;
  const long long item = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long ib = item * L.in_item + (long long)h * HD;
  const long long ob = item * L.out_item + (long long)h * HD;

  ah_load_tile<HD>(Qs, qg + ib, L.in_row, N, NP, tid, nthr);
  ah_load_tile<HD>(Ks, kg + ib, L.in_row, N, NP, tid, nthr);
  ah_load_tile<HD>(Vs, vg + ib, L.in_row, N, NP, tid, nthr);
  ah_cp_wait();
  if (qscale != 0.0f) ah_prescale_tile<HD>(Qs, qscale, N, tid, nthr);
  __syncthreads();

  const uint32_t a_off = ah_a_off<HD>(lane), b_off = ah_b_off<HD>(lane);
  const uint32_t q_sm = ah_smem(Qs), k_sm = ah_smem(Ks), v_sm = ah_smem(Vs);
  constexpr uint32_t BLK = 16 * LD * 2;  // bytes of 16 shared rows

  for (int rb = warp; rb < nblk; rb += nwarps) {
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ah_ldsm(qa[ks], q_sm + rb * BLK + a_off + ks * 32);
    const int r0 = rb * 16 + g;  // this thread's rows: r0 and r0 + 8

    // pass 1: row max (of the raw products; scale > 0) and sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    for (int jb = 0; jb < nblk; ++jb) {
      float s[2][4];
      ah_scores<KS>(qa, k_sm + jb * BLK + b_off, s);
      if (jb == nblk - 1) ah_mask_keys(s, jb * 16 + 2 * t, N);
      float cm[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cm[r] = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                      fmaxf(s[1][2 * r], s[1][2 * r + 1]));
        cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
        cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
        const float mn = fmaxf(m[r], cm[r]);
        l[r] *= exp2f((m[r] - mn) * c2);
        m[r] = mn;
      }
      const float mc[2] = {m[0] * c2, m[1] * c2};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          l[c >> 1] += exp2f(fmaf(s[nt][c], c2, -mc[c >> 1]));
    }
    float il[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      il[r] = 1.0f / l[r];
    }
    const float mc[2] = {m[0] * c2, m[1] * c2};

    // pass 2: P and O
    float o[DT][4];
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nt][c] = 0.0f;
    bf16* prow = SAVE ? P + (item * H + h) * (long long)N * N : nullptr;
    // staged P: the block's 16 rows are one contiguous span of P, kept in
    // shared memory at the span's own offset within a 16-byte line
    uint16_t* pw = nullptr;
    int sh = 0;
    if (SAVE && stage) {
      pw = reinterpret_cast<uint16_t*>(Vs + NP * LD) +
           warp * af_stage_elems(N);
      sh = (int)((reinterpret_cast<uintptr_t>(prow + (long long)rb * 16 * N) >>
                  1) & 7);
    }
    for (int jb = 0; jb < nblk; ++jb) {
      float s[2][4];
      ah_scores<KS>(qa, k_sm + jb * BLK + b_off, s);
      if (jb == nblk - 1) ah_mask_keys(s, jb * 16 + 2 * t, N);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[nt][c] = exp2f(fmaf(s[nt][c], c2, -mc[c >> 1])) * il[c >> 1];
      uint32_t a[4];
      ah_as_a(s, a);
      if constexpr (SAVE) {
        if (pw) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = jb * 16 + (q >> 1) * 8 + 2 * t;
            const int e = sh + (g + 8 * (q & 1)) * N + j;
            if (j < N) pw[e] = (uint16_t)(a[q] & 0xffffu);
            if (j + 1 < N) pw[e + 1] = (uint16_t)(a[q] >> 16);
          }
        } else {
          // N may be odd, so rows of P are only 2-byte aligned
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int i = r0 + 8 * (c >> 1);
              const int j = jb * 16 + nt * 8 + 2 * t + (c & 1);
              if (i < N && j < N)
                prow[(long long)i * N + j] = from_f<bf16>(s[nt][c]);
            }
        }
      }
      ah_accumulate<HD>(o, a, v_sm + jb * BLK + a_off);
    }
    ah_store<HD>(o, 1.0f, og + ob, L.out_row, r0, N, lane, nullptr);
    if (SAVE && pw) {
      // the span [sh, sh + len) of the staging buffer goes out in whole
      // 16-byte lines, its ragged head and tail element by element
      __syncwarp();
      const int len = min(16, N - rb * 16) * N;
      uint16_t* gp =
          reinterpret_cast<uint16_t*>(prow + (long long)rb * 16 * N) - sh;
      for (int e0 = lane * 8; e0 < sh + len; e0 += 32 * 8) {
        if (e0 >= sh && e0 + 8 <= sh + len) {
          *reinterpret_cast<uint4*>(gp + e0) =
              *reinterpret_cast<const uint4*>(pw + e0);
        } else {
          for (int e = max(e0, sh); e < min(e0 + 8, sh + len); ++e)
            gp[e] = pw[e];
        }
      }
      __syncwarp();
    }
  }
}

// The streamed forward (N > AT_RESIDENT_N): grid (H, items, ceil(N /
// AS_QB)), AS_WARPS warps, one 16-query block each.  The block's queries
// stay in shared memory; K (pass 1) and K and V (pass 2) stream through a
// two-slot cp.async ring of AS_KC-key chunks, the next chunk in flight
// while the current one is used.  Per 16-key block the arithmetic is the
// resident kernel's, in the same order, so the two passes and the rounding
// of P before P . V are as above.  P, when saved, is stored from the
// fragments (pairs of keys at even N), not staged.
template <int HD, bool SAVE>
__global__ void __launch_bounds__(AS_WARPS * 32, 2)
attn_fwd_head_stream_kernel(const bf16* qg, const bf16* kg, const bf16* vg,
                            bf16* og, bf16* P, CoreLayout L, int N, float c2,
                            float qscale) {
  constexpr int LD = HD + AH_PAD;
  constexpr int KS = HD / 16;
  constexpr int DT = HD / 8;
  constexpr uint32_t BLK = 16 * LD * 2;     // bytes of 16 shared rows
  constexpr uint32_t SLOT = AS_KC * LD * 2;  // bytes of a ring slot
  extern __shared__ __align__(16) uint8_t as_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(as_raw);  // [AS_QB][LD]
  bf16* Ks = Qs + AS_QB * LD;                  // ring [2][AS_KC][LD]
  bf16* Vs = Ks + 2 * AS_KC * LD;              // ring [2][AS_KC][LD]

  const int h = blockIdx.x, H = gridDim.x;
  const long long item = blockIdx.y;
  const int q0 = blockIdx.z * AS_QB, nq = min(AS_QB, N - q0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = warp * 16 < nq;  // the warp's rows hold a query
  const long long ib = item * L.in_item + (long long)h * HD;
  const long long ob = item * L.out_item + (long long)h * HD;
  const int nch = (N + AS_KC - 1) / AS_KC;

  ah_load_tile<HD>(Qs, qg + ib + (long long)q0 * L.in_row, L.in_row, nq,
                   AS_QB, tid, nthr);
  ah_cp_wait();
  if (qscale != 0.0f) ah_prescale_tile<HD>(Qs, qscale, nq, tid, nthr);
  __syncthreads();

  const uint32_t a_off = ah_a_off<HD>(lane), b_off = ah_b_off<HD>(lane);
  const uint32_t k_sm = ah_smem(Ks), v_sm = ah_smem(Vs);
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ah_ldsm(qa[ks], ah_smem(Qs) + warp * BLK + a_off + ks * 32);
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  // pass 1: row max (of the raw products; scale > 0) and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  ah_load_chunk<HD>(Ks, kg + ib, L.in_row, 0, N, tid, nthr);
  ah_cp_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      ah_load_chunk<HD>(Ks + ((c + 1) & 1) * AS_KC * LD, kg + ib, L.in_row,
                        (c + 1) * AS_KC, N, tid, nthr);
      ah_cp_commit();
      ah_cp_wait_pending<1>();
    } else {
      ah_cp_wait_pending<0>();
    }
    __syncthreads();
    const int j0 = c * AS_KC;
    const int nb = (min(AS_KC, N - j0) + 15) / 16;
    const uint32_t kc = k_sm + (c & 1) * SLOT;
    for (int jb = 0; active && jb < nb; ++jb) {
      float s[2][4];
      ah_scores<KS>(qa, kc + jb * BLK + b_off, s);
      const int jj = j0 + jb * 16;
      if (jj + 16 > N) ah_mask_keys(s, jj + 2 * t, N);
      float cm[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cm[r] = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                      fmaxf(s[1][2 * r], s[1][2 * r + 1]));
        cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
        cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
        const float mn = fmaxf(m[r], cm[r]);
        l[r] *= exp2f((m[r] - mn) * c2);
        m[r] = mn;
      }
      const float mc[2] = {m[0] * c2, m[1] * c2};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4)
          l[c4 >> 1] += exp2f(fmaf(s[nt][c4], c2, -mc[c4 >> 1]));
    }
    __syncthreads();
  }
  float il[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    il[r] = 1.0f / l[r];
  }
  const float mc[2] = {m[0] * c2, m[1] * c2};

  // pass 2: P and O, K and V through the ring
  float o[DT][4];
#pragma unroll
  for (int nt = 0; nt < DT; ++nt)
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) o[nt][c4] = 0.0f;
  bf16* prow = SAVE ? P + (item * H + h) * (long long)N * N : nullptr;
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
      float s[2][4];
      ah_scores<KS>(qa, kc + jb * BLK + b_off, s);
      const int jj = j0 + jb * 16;
      if (jj + 16 > N) ah_mask_keys(s, jj + 2 * t, N);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4)
          s[nt][c4] = exp2f(fmaf(s[nt][c4], c2, -mc[c4 >> 1])) * il[c4 >> 1];
      uint32_t a[4];
      ah_as_a(s, a);
      if constexpr (SAVE) {
        if ((N & 1) == 0) {
          // even N: each key pair is one aligned 4-byte word of a row of P
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = r0 + 8 * (q & 1);
            const int j = jj + (q >> 1) * 8 + 2 * t;
            if (i < N && j < N)
              *reinterpret_cast<uint32_t*>(prow + (long long)i * N + j) = a[q];
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c4 = 0; c4 < 4; ++c4) {
              const int i = r0 + 8 * (c4 >> 1);
              const int j = jj + nt * 8 + 2 * t + (c4 & 1);
              if (i < N && j < N)
                prow[(long long)i * N + j] = from_f<bf16>(s[nt][c4]);
            }
        }
      }
      ah_accumulate<HD>(o, a, vc + jb * BLK + a_off);
    }
    __syncthreads();
  }
  if (active) ah_store<HD>(o, 1.0f, og + ob, L.out_row, r0, N, lane, nullptr);
}

// Three tiles' worth of rows (the queries and two ring slots each of K and
// V), whatever N.
__host__ __device__ inline size_t attn_fwd_head_stream_smem(int hd) {
  return (size_t)(AS_QB + 4 * AS_KC) * (hd + AH_PAD) * sizeof(bf16);
}

template <int HD, bool SAVE>
int attn_fwd_head_stream_launch(const bf16* q, const bf16* k, const bf16* v,
                                bf16* o, bf16* P, const CoreLayout& L,
                                int items, int H, int N, float scale,
                                float qscale, cudaStream_t st) {
  auto kern = attn_fwd_head_stream_kernel<HD, SAVE>;
  const size_t smem = attn_fwd_head_stream_smem(HD);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  FC_CHECK();
  kern<<<dim3(H, items, (N + AS_QB - 1) / AS_QB), AS_WARPS * 32, smem, st>>>(
      q, k, v, o, P, L, N, scale * AH_LOG2E, qscale);
  FC_CHECK();
  return 0;
}

inline size_t attn_fwd_head_smem(int N, int hd) {
  const int NP = (N + 15) / 16 * 16;
  return (size_t)3 * NP * (hd + AH_PAD) * sizeof(bf16);
}

template <int HD, bool SAVE>
int attn_fwd_head_launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                         bf16* P, const CoreLayout& L, int items, int H, int N,
                         float scale, float qscale, cudaStream_t st) {
  auto kern = attn_fwd_head_kernel<HD, SAVE>;
  const int nblk = (N + 15) / 16;
  const int warps = nblk < AF_MAXW ? nblk : AF_MAXW;
  // P goes through shared memory where the tiles leave room for it (all
  // but head_dim 64 at N > 232)
  size_t smem = attn_fwd_head_smem(N, HD);
  const size_t staged = smem + (size_t)warps * af_stage_elems(N) * sizeof(bf16);
  const int stage = SAVE && staged <= AF_MAX_SMEM;
  if (stage) smem = staged;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  FC_CHECK();
  kern<<<dim3(H, items), warps * 32, smem, st>>>(
      q, k, v, o, P, L, N, scale * AH_LOG2E, qscale, stage);
  FC_CHECK();
  return 0;
}

// Whether attn_fwd_head takes the shape (bf16 only): every N, resident up
// to AT_RESIDENT_N and streamed past it.
inline bool attn_fwd_head_takes(int N, int hd) {
  return (hd == 16 || hd == 32 || hd == 64) && N >= 1;
}

// The arguments of attn_core_fwd<bf16>; cudaErrorInvalidValue where
// attn_fwd_head_takes is false.
inline int attn_fwd_head(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                         bf16* P, const CoreLayout& L, int items, int H, int N,
                         int hd, float scale, float qscale, cudaStream_t st) {
  if (!attn_fwd_head_takes(N, hd)) return (int)cudaErrorInvalidValue;
#define FC_AF_LAUNCH(HD)                                                      \
  return attn_streams_keys(N)                                                 \
      ? (P ? attn_fwd_head_stream_launch<HD, true>(                           \
                 q, k, v, o, P, L, items, H, N, scale, qscale, st)            \
           : attn_fwd_head_stream_launch<HD, false>(                          \
                 q, k, v, o, P, L, items, H, N, scale, qscale, st))           \
      : (P ? attn_fwd_head_launch<HD, true>(q, k, v, o, P, L, items, H, N,    \
                                            scale, qscale, st)                \
           : attn_fwd_head_launch<HD, false>(q, k, v, o, P, L, items, H, N,   \
                                             scale, qscale, st))
  if (hd == 16) FC_AF_LAUNCH(16);
  if (hd == 32) FC_AF_LAUNCH(32);
  FC_AF_LAUNCH(64);
#undef FC_AF_LAUNCH
}

// The fused sublayer's packed layout, as attn_core_fwd_packed: qkv [items,
// N, 3D] (q | k | v), the head concat cat [items, N, D], P [items, H, N, N]
// or null.
inline int attn_fwd_head_packed(const bf16* qkv, bf16* P, bf16* cat, int items,
                                int N, int D, int H, cudaStream_t st) {
  const int hd = D / H;
  const CoreLayout L = {(long long)N * 3 * D, 3 * D, (long long)N * D, D};
  return attn_fwd_head(qkv, qkv + D, qkv + 2 * D, cat, P, L, items, H, N, hd,
                       1.0f / sqrtf((float)hd), 0.0f, st);
}

}  // namespace
