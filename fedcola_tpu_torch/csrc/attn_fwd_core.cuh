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
#include "attn_wgmma.cuh"

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

// The streamed forward (N > AT_RESIDENT_N), redesigned for Hopper: grid
// (H, items, ceil(N / AS_QB)), AS_THREADS threads (attn_wgmma.cuh), two
// blocks an SM.  The block's 128 queries are loaded once; the head's keys
// stream in AS_KC-key chunks through the ring, twice: pass 1 K alone,
// pass 2 K and V.  Each warpgroup owns 64 query rows:
//   pass 1  S = Q.K^T (SS wgmma), two chunks a batch, the row max (of the
//           raw products; scale > 0) and the sum carried under it;
//   pass 2  S again, P = T(exp2(c2 s - c2 max) * (1 / sum)), whose rounded
//           accumulator is the A operand of O += P.V (RS wgmma, V read
//           MN-major); P(c).V(c) and the next chunk's S are one batch.
// Two passes, not an online softmax, as the resident kernel above: P is
// rounded after normalisation and before P.V, as the TPU kernels round it.
// Padded keys (the last chunk's rows past N, TMA's zero fill) score -inf;
// padded query rows are computed and not stored.
//
// The P store (SAVE).  With PTMA (as_p_tiles: N % 8 == 0) each warpgroup
// writes its rounded 64 x 64 P tile into a swizzled staging box and one
// thread sends the box out with a TMA store, which clips the ragged edges.
// Without PTMA the rows of P are not 16-byte aligned and the fragments are
// stored directly, key pair by key pair at even N, element by element at
// odd N: the second path, chosen by shape in attn_fwd_head_stream.
//
// What bounds it: at N = 512, hd = 64 two exp2 an element of S (16 a clock
// an SM) and the three N^2 products; the bytes of q, k, v and o (and P when
// saved) come next.  Shared memory: 64 KB, 96 KB with the P staging,
// whatever N, so two blocks share an SM.
template <int HD, bool SAVE, bool PTMA>
__global__ void __launch_bounds__(AS_THREADS, 2)
attn_fwd_head_stream_kernel(const __grid_constant__ AsFwdArgs g) {
  constexpr int KS = HD / 16;
  constexpr bool STAGE_P = SAVE && PTMA;
  extern __shared__ uint8_t as_raw[];
  const uint32_t qt = (smem_u32(as_raw) + 1023u) & ~1023u;  // Q, 2 boxes
  const uint32_t ring = qt + 2 * AS_BOX;                   // AS_ST x {K, V}
  const uint32_t pst = ring + AS_ST * 2 * AS_BOX;          // [wg] P boxes
  const uint32_t qbar = pst + (STAGE_P ? 2 * AS_BOX : 0);
  const uint32_t full = qbar + 8, cnt = full + 8 * AS_ST;

  const int h = blockIdx.x, item = blockIdx.y;
  const int q0 = blockIdx.z * AS_QB, N = g.N;
  const int nch = (N + AS_KC - 1) / AS_KC, iters = 2 * nch;
  // ring iteration it: pass 1 K of chunk it, pass 2 K and V of it - nch
  auto load = [&](int it) {
    const int st = it % AS_ST;
    const bool p2 = it >= nch;
    const int j0 = (p2 ? it - nch : it) * AS_KC;
    const uint32_t slot = ring + st * 2 * AS_BOX, fb = full + 8 * st;
    mbar_expect_tx(fb, p2 ? 2 * AS_BOX : AS_BOX);
    tma_load(slot, &g.k.map, fb, g.k.col + h * HD, j0, item);
    if (p2) tma_load(slot + AS_BOX, &g.v.map, fb, g.v.col + h * HD, j0, item);
  };
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < AS_ST; ++s) {
      mbar_init(full + 8 * s, 1);
      as_st32(cnt + 4 * s, 0u);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, 2 * AS_BOX);
    tma_load(qt, &g.q.map, qbar, g.q.col + h * HD, q0, item);
    tma_load(qt + AS_BOX, &g.q.map, qbar, g.q.col + h * HD, q0 + 64, item);
    for (int it = 0; it < AS_ST; ++it) load(it);
  }
  __syncthreads();

  // warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2);  // and r0 + 8
  const uint32_t qa = qt + wg * AS_BOX;
  const float c2 = g.c2;
  // this warp is done with ring iteration it; the last of the eight to be
  // done refills its stage
  auto release = [&](int it) {
    if (as_release(cnt + 4 * (it % AS_ST), lane) && lane == 0 &&
        it + AS_ST < iters)
      load(it + AS_ST);
  };
  mbar_wait(qbar, 0);
  if (g.qscale != 0.0f) {
    as_prescale(qa, AS_BOX, g.qscale, tid, 128);
    as_fence_async();
    as_bar(1 + wg, 128);
  }

  // pass 1: row max and sum, two chunks' S a wgmma batch
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  auto stats = [&](float (&s)[32], int c) {
    as_keep(s);
    release(c);
    const int j0 = c * AS_KC;
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
      l[hh] *= exp2f((m[hh] - mn) * c2);
      m[hh] = mn;
      const float mc = mn * c2;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          l[hh] += exp2f(fmaf(s[4 * j + 2 * hh + e], c2, -mc));
    }
  };
  // S of ring iteration it into s, issued (the caller commits)
  auto issue_s = [&](float (&s)[32], int it) {
    const int st = it % AS_ST;
    mbar_wait(full + 8 * st, (it / AS_ST) & 1);
    as_issue_ss<KS>(s, qa, ring + st * 2 * AS_BOX);
  };
  for (int c = 0; c < nch; c += 2) {
    float sa[32], sb[32];
    const bool two = c + 1 < nch;
    wgmma_fence();
    issue_s(sa, c);
    if (two) issue_s(sb, c + 1);
    wgmma_commit();
    wgmma_wait<0>();
    stats(sa, c);
    if (two) stats(sb, c + 1);
  }
  float il[2], mc[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    il[hh] = 1.0f / l[hh];
    mc[hh] = m[hh] * c2;
  }

  // pass 2: P and O.  P(c).V(c) and the next chunk's S are one wgmma batch.
  float o[32], s[32];
  uint32_t a[4][4];
  bf16* prow = SAVE ? g.P + ((long long)item * g.H + h) * N * N : nullptr;
  wgmma_fence();
  issue_s(s, nch);
  wgmma_commit();
  wgmma_wait<0>();
  for (int c = 0; c < nch; ++c) {
    const int it = nch + c;
    as_keep(s);
    const int j0 = c * AS_KC;
    if (j0 + AS_KC > N) as_mask_cols(s, j0 + 2 * t, N);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s[4 * j + q] = exp2f(fmaf(s[4 * j + q], c2, -mc[q >> 1])) * il[q >> 1];
    as_frag(s, a);
    if constexpr (STAGE_P) {
      // a[kk][q]: row 16 warp + lane/4 + 8 (q & 1), keys 16 kk + 8 (q >> 1)
      // + 2t, +1 of the warpgroup's tile
      const uint32_t buf = pst + wg * AS_BOX;
      if (c > 0) {
        if (tid == 0) as_bulk_wait_read<0>();  // the last store has read it
        as_bar(1 + wg, 128);
      }
      const int rl = 16 * warp + (lane >> 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          as_st32(buf + as_sw(rl + 8 * (q & 1), 16 * kk + 8 * (q >> 1) + 2 * t),
                  a[kk][q]);
      as_fence_async();
      as_bar(1 + wg, 128);
      if (tid == 0) {
        as_tma_store(&g.p, buf, j0, q0 + 64 * wg, item * g.H + h);
        as_bulk_commit();
      }
    } else if constexpr (SAVE) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = r0 + 8 * (q & 1);
          const int j = j0 + 16 * kk + 8 * (q >> 1) + 2 * t;
          if (i >= N || j >= N) continue;
          bf16* p = prow + (long long)i * N + j;
          if ((N & 1) == 0) {
            *reinterpret_cast<uint32_t*>(p) = a[kk][q];
          } else {
            *reinterpret_cast<uint16_t*>(p) = (uint16_t)(a[kk][q] & 0xffffu);
            if (j + 1 < N)
              *reinterpret_cast<uint16_t*>(p + 1) = (uint16_t)(a[kk][q] >> 16);
          }
        }
    }
    wgmma_fence();
    if (c + 1 < nch) issue_s(s, it + 1);
    as_issue_rs(o, a, ring + (it % AS_ST) * 2 * AS_BOX + AS_BOX, c);
    wgmma_commit();
    wgmma_wait<0>();
    as_keep(o);
    as_keep(a);
    release(it);
  }
  as_store<HD>(o, 1.0f, g.o + (long long)item * g.o_item + h * HD, g.o_row,
               r0, N, lane, nullptr);
  if (STAGE_P && tid == 0) as_bulk_wait_all();
}

// The streamed forward's shared memory, whatever N (and whatever hd): the
// queries, the ring and, with P stored in tiles, its staging boxes.
__host__ __device__ inline size_t attn_fwd_head_stream_smem(bool stage_p) {
  return 1024 + (size_t)(2 + 2 * AS_ST + (stage_p ? 2 : 0)) * AS_BOX +
         8 * (1 + AS_ST) + 4 * AS_ST;
}

template <int HD, bool SAVE, bool PTMA>
int attn_fwd_head_stream_launch(const AsFwdArgs& g, int items,
                                cudaStream_t st) {
  auto kern = attn_fwd_head_stream_kernel<HD, SAVE, PTMA>;
  const size_t smem = attn_fwd_head_stream_smem(SAVE && PTMA);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  FC_CHECK();
  kern<<<dim3(g.H, items, (g.N + AS_QB - 1) / AS_QB), AS_THREADS, smem, st>>>(
      g);
  FC_CHECK();
  return 0;
}

// The maps and scalars of one streamed forward: q, k, v as AsSrc (the
// packed layout's one map, or three), o [items, N, ...] at o_item / o_row,
// P [items, H, N, N] or null.
inline int attn_fwd_head_stream(const AsSrc& q, const AsSrc& k,
                                const AsSrc& v, bf16* o, long long o_item,
                                int o_row, bf16* P, int items, int H, int N,
                                int hd, float scale, float qscale,
                                cudaStream_t st) {
  AsFwdArgs g = {};
  int err;
  if ((err = as_map(&g.q.map, q, N, items)) ||
      (err = as_map(&g.k.map, k, N, items)) ||
      (err = as_map(&g.v.map, v, N, items)))
    return err;
  g.q.col = q.col; g.k.col = k.col; g.v.col = v.col;
  const bool ptma = as_p_tiles(P, N);
  if (ptma) {
    const AsSrc p = {P, (long long)N * N, N, N, 0};
    if ((err = as_map(&g.p, p, N, items * H))) return err;
  }
  g.o = o; g.o_item = o_item; g.o_row = o_row;
  g.P = P; g.N = N; g.H = H;
  g.c2 = scale * AH_LOG2E; g.qscale = qscale;
#define FC_AS_FWD(HD_)                                                       \
  if (hd == HD_)                                                             \
    return !P ? attn_fwd_head_stream_launch<HD_, false, false>(g, items, st) \
           : ptma ? attn_fwd_head_stream_launch<HD_, true, true>(g, items, st) \
                  : attn_fwd_head_stream_launch<HD_, true, false>(g, items, st);
  FC_AS_FWD(16)
  FC_AS_FWD(32)
  FC_AS_FWD(64)
#undef FC_AS_FWD
  return (int)cudaErrorInvalidValue;
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

// The arguments of attn_core_fwd<bf16>, q, k and v separate tensors (each
// row L.in_row elements wide); cudaErrorInvalidValue where
// attn_fwd_head_takes is false.
inline int attn_fwd_head(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                         bf16* P, const CoreLayout& L, int items, int H, int N,
                         int hd, float scale, float qscale, cudaStream_t st) {
  if (!attn_fwd_head_takes(N, hd)) return (int)cudaErrorInvalidValue;
  if (attn_streams_keys(N)) {
    const AsSrc qs = {q, L.in_item, L.in_row, L.in_row, 0};
    AsSrc ks = qs, vs = qs;
    ks.ptr = k;
    vs.ptr = v;
    return attn_fwd_head_stream(qs, ks, vs, o, L.out_item, L.out_row, P,
                                items, H, N, hd, scale, qscale, st);
  }
#define FC_AF_LAUNCH(HD)                                                      \
  return P ? attn_fwd_head_launch<HD, true>(q, k, v, o, P, L, items, H, N,    \
                                            scale, qscale, st)                \
           : attn_fwd_head_launch<HD, false>(q, k, v, o, P, L, items, H, N,   \
                                             scale, qscale, st)
  if (hd == 16) FC_AF_LAUNCH(16);
  if (hd == 32) FC_AF_LAUNCH(32);
  FC_AF_LAUNCH(64);
#undef FC_AF_LAUNCH
}

// The fused sublayer's packed layout, as attn_core_fwd_packed: qkv [items,
// N, 3D] (q | k | v), the head concat cat [items, N, D], P [items, H, N, N]
// or null.  Streamed, q, k and v are one map over qkv's rows.
inline int attn_fwd_head_packed(const bf16* qkv, bf16* P, bf16* cat, int items,
                                int N, int D, int H, cudaStream_t st) {
  const int hd = D / H;
  const float scale = 1.0f / sqrtf((float)hd);
  if (attn_streams_keys(N) && attn_fwd_head_takes(N, hd)) {
    const AsSrc q = {qkv, (long long)N * 3 * D, 3 * D, 3 * D, 0};
    AsSrc k = q, v = q;
    k.col = D;
    v.col = 2 * D;
    return attn_fwd_head_stream(q, k, v, cat, (long long)N * D, D, P, items,
                                H, N, hd, scale, 0.0f, st);
  }
  const CoreLayout L = {(long long)N * 3 * D, 3 * D, (long long)N * D, D};
  return attn_fwd_head(qkv, qkv + D, qkv + 2 * D, cat, P, L, items, H, N, hd,
                       scale, 0.0f, st);
}

}  // namespace
