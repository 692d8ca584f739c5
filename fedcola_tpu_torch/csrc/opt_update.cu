// The local optimizer step of a client-stacked group, fused: AdamW, Adam
// (decay added to the gradient) and SGD (momentum, nesterov) over every
// non-frozen leaf of the group in one pass over memory, with f32 or bf16
// moments, per-client step masks and per-leaf, per-client step counters.
//
// Replaces no Pallas kernel: the JAX package's update
// (fedcola_tpu/parallel/optim.py opt_update) is plain jnp that XLA fuses.
// The port's plain version, parallel/optim.py opt_update_plain, runs about
// twenty eager PyTorch ops per leaf and per step (casts, moments, bias
// corrections, masks); this kernel is that loop in one launch plus a tiny
// one for the counters, and follows its arithmetic in f32 op for op
// (round-to-nearest intrinsics, so nothing is contracted into an fma).
//
// What bounds it on the H100: bytes.  AdamW reads p, g, m and v and writes
// p, m and v: 28 bytes an element with f32 moments (20 with bf16 moments,
// 20 for SGD with momentum, 12 without), against about 12 flops, so the
// bound is bytes / 3.35 TB/s (a coco.sh group's step, 109-163 M elements:
// 0.9-1.4 ms).  What the design does about it:
//   * one launch over a flat work table: a row per leaf (pointers, the
//     per-client size, the tiles a client's segment takes, the first block)
//     passed by value as a __grid_constant__ struct, so no table is copied
//     to the device each step; a block finds its row by binary search;
//   * each block owns one tile of OPT_TILE elements of one (leaf, client)
//     segment: each thread loads OPT_UNROLL 16-byte vectors of p, g, m and v
//     before it computes (16 loads in flight), then stores; a segment whose
//     size is not a multiple of 4 or whose addresses are not aligned takes
//     a scalar loop over the same tile;
//   * a block reads its client's mask and counter once: a client masked
//     for the step returns before any load, so a padded step moves no
//     bytes and leaves p, m, v and t bitwise untouched;
//   * the counters are advanced by a second launch of one block after the
//     first, so no block reads a counter another block has written.
#include "common.cuh"

namespace {

constexpr int OPT_THREADS = 256, OPT_VEC = 4, OPT_UNROLL = 4;
constexpr int OPT_TILE = OPT_THREADS * OPT_VEC * OPT_UNROLL;  // 4096
constexpr int OPT_MAX_LEAVES = 48;  // parallel/optim.py OPT_MAX_LEAVES
enum { ADAMW = 0, ADAM = 1, SGD = 2 };

// One leaf of the group, as the host packs it (parallel/optim.py
// opt_launches): client c's segment starts c * numel elements in.
struct OptLeaf {
  float* p;
  const float* g;
  void* m;  // Adam: first moment; SGD: momentum buffer (f32)
  void* v;  // Adam: second moment; SGD: unused
  int* t;   // step counters [n]
  long long numel;
  int tiles, first, vec, pad;
};

struct OptArgs {
  OptLeaf leaf[OPT_MAX_LEAVES];
  const unsigned char* sv;  // step_valid (bool), element c at c * sv_stride
  long long sv_stride;
  int nleaves, n, nesterov;
  float lr, b1, omb1, b2, omb2, eps, wd, decay, momentum;
};
static_assert(sizeof(OptArgs) <= 4096, "kernel parameters exceed 4 KB");

__device__ __forceinline__ void load4(const float* s, float* d) {
  const float4 x = *reinterpret_cast<const float4*>(s);
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* s, float* d) {
  const uint2 x = *reinterpret_cast<const uint2*>(s);
  typedef const __nv_bfloat162* P2;
  const float2 a = __bfloat1622float2(*reinterpret_cast<P2>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<P2>(&x.y));
  d[0] = a.x; d[1] = a.y; d[2] = b.x; d[3] = b.y;
}
__device__ __forceinline__ void store4(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ void store4(bf16* d, const float* s) {
  __nv_bfloat162 a = __floats2bfloat162_rn(s[0], s[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(s[2], s[3]);
  uint2 x;
  x.x = *reinterpret_cast<uint32_t*>(&a);
  x.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(d) = x;
}

__device__ __forceinline__ bool aligned(const void* q, int bytes) {
  return (reinterpret_cast<uintptr_t>(q) & (bytes - 1)) == 0;
}

// One element, in the plain version's order of operations.
template <int RULE>
__device__ __forceinline__ void opt_elem(const OptArgs& a, float bc1,
                                         float bc2, bool first, float& p,
                                         float g, float& m, float& v) {
  if (RULE == SGD) {
    g = __fadd_rn(g, __fmul_rn(a.wd, p));
    float d = g;
    if (a.momentum > 0.f) {
      m = first ? g : __fadd_rn(__fmul_rn(a.momentum, m), g);
      d = a.nesterov ? __fadd_rn(g, __fmul_rn(a.momentum, m)) : m;
    }
    p = __fsub_rn(p, __fmul_rn(a.lr, d));
  } else {
    if (RULE == ADAM) g = __fadd_rn(g, __fmul_rn(a.wd, p));
    m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
    v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
    const float mh = __fdiv_rn(m, bc1), vh = __fdiv_rn(v, bc2);
    if (RULE == ADAMW) p = __fmul_rn(p, a.decay);
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(a.lr, mh),
                               __fadd_rn(__fsqrt_rn(vh), a.eps)));
  }
}

template <int RULE, typename MT>
__global__ void __launch_bounds__(OPT_THREADS)
    opt_update_kernel(const __grid_constant__ OptArgs a) {
  const int b = blockIdx.x;
  int lo = 0, hi = a.nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.leaf[mid].first <= b) lo = mid; else hi = mid - 1;
  }
  const OptLeaf& L = a.leaf[lo];
  const int r = b - L.first;
  const int c = r / L.tiles;
  if (a.sv != nullptr && !a.sv[c * a.sv_stride]) return;
  const int tile = r - c * L.tiles;
  const int t1 = L.t[c] + 1;
  const bool first = t1 == 1;
  float bc1 = 1.f, bc2 = 1.f;
  if (RULE != SGD) {
    const float tf = (float)t1;
    bc1 = __fsub_rn(1.f, powf(a.b1, tf));
    bc2 = __fsub_rn(1.f, powf(a.b2, tf));
  }
  const long long off = (long long)c * L.numel + (long long)tile * OPT_TILE;
  const int len = (int)min((long long)OPT_TILE,
                           L.numel - (long long)tile * OPT_TILE);
  float* p = L.p + off;
  const float* g = L.g + off;
  MT* m = static_cast<MT*>(L.m) + off;
  MT* v = RULE == SGD ? nullptr : static_cast<MT*>(L.v) + off;
  const bool uses_m = RULE != SGD || a.momentum > 0.f;
  const int tid = threadIdx.x;

  const int vb = 4 * (int)sizeof(MT);
  if (L.vec && aligned(p, 16) && aligned(g, 16) &&
      (!uses_m || aligned(m, vb)) && (RULE == SGD || aligned(v, vb))) {
    float P[OPT_UNROLL][4], G[OPT_UNROLL][4], M[OPT_UNROLL][4] = {},
        V[OPT_UNROLL][4] = {};
#pragma unroll
    for (int u = 0; u < OPT_UNROLL; ++u) {
      const int i = (u * OPT_THREADS + tid) * OPT_VEC;
      if (i < len) {  // len is a multiple of 4 here
        load4(p + i, P[u]);
        load4(g + i, G[u]);
        if (uses_m) load4(m + i, M[u]);
        if (RULE != SGD) load4(v + i, V[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < OPT_UNROLL; ++u) {
      const int i = (u * OPT_THREADS + tid) * OPT_VEC;
      if (i < len) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          opt_elem<RULE>(a, bc1, bc2, first, P[u][k], G[u][k], M[u][k],
                         V[u][k]);
        store4(p + i, P[u]);
        if (uses_m) store4(m + i, M[u]);
        if (RULE != SGD) store4(v + i, V[u]);
      }
    }
  } else {
    for (int i = tid; i < len; i += OPT_THREADS) {
      float pp = p[i], mm = uses_m ? to_f(m[i]) : 0.f;
      float vv = RULE == SGD ? 0.f : to_f(v[i]);
      opt_elem<RULE>(a, bc1, bc2, first, pp, g[i], mm, vv);
      p[i] = pp;
      if (uses_m) m[i] = from_f<MT>(mm);
      if (RULE != SGD) v[i] = from_f<MT>(vv);
    }
  }
}

// After the update: every counter of a client that stepped advances by one.
__global__ void opt_count_kernel(const __grid_constant__ OptArgs a) {
  for (int i = threadIdx.x; i < a.nleaves * a.n; i += blockDim.x) {
    const int l = i / a.n, c = i - l * a.n;
    if (a.sv == nullptr || a.sv[c * a.sv_stride]) a.leaf[l].t[c] += 1;
  }
}

template <int RULE, typename MT>
int opt_launch(const OptArgs& a, int blocks, cudaStream_t st) {
  opt_update_kernel<RULE, MT><<<blocks, OPT_THREADS, 0, st>>>(a);
  FC_CHECK();
  return 0;
}

}  // namespace

// table [nleaves, 9] (int64, host memory): p, g, m, v, t, the per-client
// size, tiles per client, first block, vec — one row per leaf, as
// parallel/optim.py plan_opt_segments lays them out (frozen and empty leaves
// left out, at most OPT_MAX_LEAVES).  p, g f32; m, v f32 or bf16
// (moment_bf16); SGD's momentum buffer in m (f32), v null; t int32 [n].
// step_valid: bool, element c at c * sv_stride, or null (every client
// steps).  rule: 0 AdamW, 1 Adam, 2 SGD.  The scalars are the plain
// version's, each rounded to f32 once: omb1 = 1 - beta1, omb2 = 1 - beta2,
// decay = 1 - lr * weight_decay.
extern "C" int fc_opt_update(int rule, int moment_bf16, int nleaves, int n,
                             const long long* table, const void* step_valid,
                             int sv_stride, float lr, float beta1, float omb1,
                             float beta2, float omb2, float eps, float wd,
                             float decay, float momentum, int nesterov,
                             cudaStream_t st) {
  if (nleaves < 1 || nleaves > OPT_MAX_LEAVES || n < 1 || rule < 0 ||
      rule > 2 || (rule == SGD && moment_bf16))
    return (int)cudaErrorInvalidValue;
  OptArgs a = {};
  for (int l = 0; l < nleaves; ++l) {
    const long long* row = table + 9 * l;
    OptLeaf& L = a.leaf[l];
    L.p = reinterpret_cast<float*>(row[0]);
    L.g = reinterpret_cast<const float*>(row[1]);
    L.m = reinterpret_cast<void*>(row[2]);
    L.v = reinterpret_cast<void*>(row[3]);
    L.t = reinterpret_cast<int*>(row[4]);
    L.numel = row[5];
    L.tiles = (int)row[6];
    L.first = (int)row[7];
    L.vec = (int)row[8];
  }
  a.sv = static_cast<const unsigned char*>(step_valid);
  a.sv_stride = sv_stride;
  a.nleaves = nleaves;
  a.n = n;
  a.nesterov = nesterov;
  a.lr = lr; a.b1 = beta1; a.omb1 = omb1; a.b2 = beta2; a.omb2 = omb2;
  a.eps = eps; a.wd = wd; a.decay = decay; a.momentum = momentum;
  const OptLeaf& last = a.leaf[nleaves - 1];
  const int blocks = last.first + n * last.tiles;
  int err;
  if (rule == SGD) err = opt_launch<SGD, float>(a, blocks, st);
  else if (rule == ADAM)
    err = moment_bf16 ? opt_launch<ADAM, bf16>(a, blocks, st)
                      : opt_launch<ADAM, float>(a, blocks, st);
  else
    err = moment_bf16 ? opt_launch<ADAMW, bf16>(a, blocks, st)
                      : opt_launch<ADAMW, float>(a, blocks, st);
  if (err) return err;
  opt_count_kernel<<<1, OPT_THREADS, 0, st>>>(a);
  FC_CHECK();
  return 0;
}
