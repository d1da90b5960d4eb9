// Masked / per-voxel Adam, one pass a leaf (the train step's optimizer).
//
// Replaces no Pallas kernel: the JAX package's masked Adam
// (fgs_nerf_tpu/optim/masked_adam.py) is plain jnp, which XLA fuses on
// the TPU.  The port's plain version, fgs_nerf_tpu_torch/optim/
// masked_adam.py:adam_leaf, makes about sixteen elementwise passes a
// leaf (the two moments, the step, the mask and three selects for
// skip_zero_grad), and over the fine grids the step's Adam read 16% of
// its byte bound on an H100.  This kernel is the same function in one
// pass, with every operation rounded as the plain version rounds it:
//
//   m' = b1 m + c1 g                    c1 = (float)(1 - beta1)
//   v' = b2 v + (c2 g) g                c2 = (float)(1 - beta2)
//   s  = lr bias [ plr ]                lr, bias: 0-d device tensors
//   p' = p - (s m') / (sqrt(v') + eps)
//
// and, where skip_zero_grad is set and g == 0, p, m and v kept as they
// were.  Each operation is a separate IEEE round-to-nearest step
// (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn: nothing contracted into
// an FMA), on the float32 values of PyTorch's scalars, so the result is
// bit-equal to the plain version on the card.
//
// Bound on an H100: bytes.  Each element reads p, g, m and v and writes
// p', m' and v': 28 B (32 with a per-voxel lr).  Over the fine sdf and
// k0 grids (258 x 257 x 252 x (1 + 12) = 217.2M elements) that is
// 6.08 GB, >= 1.82 ms at 3.35 TB/s.
//
// Design: one launch a leaf, outputs written to fresh tensors (the
// update is functional: callers may hold the old state).
// - Every operand in one layout (the steady state of every leaf): a flat
//   pass, one thread per four elements with 16-byte loads and streaming
//   16-byte stores, and a scalar tail for a count not a multiple of 4.
//   Where an operand is not 16-byte aligned (a leaf of the dp path's flat
//   all-reduce buffer), the tiled pass below takes the leaf as rows of
//   one channel, with 4-byte loads.
// - Operands in two orders, as on a rung's first step (a grid's
//   parameters and moments channel-last, [N, C], and its gradient
//   channel-major, [C, N]: the backward of the forward's permute of k0),
//   or a gradient that is a strided slice (a padded head weight's
//   columns; a channel range of the lattice engine's channel-last field):
//   a block takes a tile of T whole rows (T C <= 2,048 elements), reads
//   each operand's tile in that operand's own order, coalesced (row by
//   row channel-last, channel by channel channel-major; 4-byte loads),
//   into shared memory, updates the tile there and writes each output in
//   its own order.  No transposed or compacted copy of any operand is
//   made in device memory.
#include <cuda_runtime.h>

constexpr int THREADS = 256;
constexpr int TILE_ELEMS = 2048;  // elements of one operand's tile

struct Consts {
  float b1, c1, b2, c2, eps;
  int skip;
};

__device__ __forceinline__ void adam_elem(float p, float g, float m, float v,
                                          float s, const Consts& k,
                                          float& po, float& mo, float& vo) {
  const float mn = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, g));
  const float vn = __fadd_rn(__fmul_rn(k.b2, v),
                             __fmul_rn(__fmul_rn(k.c2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(vn), k.eps);
  const float pn = __fsub_rn(p, __fdiv_rn(__fmul_rn(s, mn), den));
  const bool keep = k.skip && g == 0.0f;
  po = keep ? p : pn;
  mo = keep ? m : mn;
  vo = keep ? v : vn;
}

__device__ __forceinline__ float step_scale(const float* lr,
                                            const float* bias) {
  return __fmul_rn(__ldg(lr), __ldg(bias));
}

__device__ __forceinline__ void adam_scalar(
    const float* __restrict__ p, const float* __restrict__ g,
    const float* __restrict__ m, const float* __restrict__ v,
    const float* __restrict__ plr, float* __restrict__ po,
    float* __restrict__ mo, float* __restrict__ vo, float s0,
    const Consts& k, long long i) {
  const float s = plr ? __fmul_rn(s0, __ldcs(plr + i)) : s0;
  float a, b, c;
  adam_elem(__ldcs(p + i), __ldcs(g + i), __ldcs(m + i), __ldcs(v + i), s, k,
            a, b, c);
  __stcs(po + i, a);
  __stcs(mo + i, b);
  __stcs(vo + i, c);
}

// Every operand in one layout, all 16-byte aligned: thread i updates
// elements 4i .. 4i + 3; the first n % 4 threads also take the tail.
__global__ void __launch_bounds__(THREADS)
masked_adam_step_vec4(const float* __restrict__ p, const float* __restrict__ g,
                      const float* __restrict__ m, const float* __restrict__ v,
                      const float* __restrict__ plr, float* __restrict__ po,
                      float* __restrict__ mo, float* __restrict__ vo,
                      const float* __restrict__ lr,
                      const float* __restrict__ bias, long long n, Consts k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n >> 2;
  const float s0 = step_scale(lr, bias);
  if (i < n4) {
    const float4 pp = __ldcs(reinterpret_cast<const float4*>(p) + i);
    const float4 gg = __ldcs(reinterpret_cast<const float4*>(g) + i);
    const float4 mm = __ldcs(reinterpret_cast<const float4*>(m) + i);
    const float4 vv = __ldcs(reinterpret_cast<const float4*>(v) + i);
    float4 sc = make_float4(s0, s0, s0, s0);
    if (plr) {
      const float4 l = __ldcs(reinterpret_cast<const float4*>(plr) + i);
      sc = make_float4(__fmul_rn(s0, l.x), __fmul_rn(s0, l.y),
                       __fmul_rn(s0, l.z), __fmul_rn(s0, l.w));
    }
    float4 a, b, c;
    adam_elem(pp.x, gg.x, mm.x, vv.x, sc.x, k, a.x, b.x, c.x);
    adam_elem(pp.y, gg.y, mm.y, vv.y, sc.y, k, a.y, b.y, c.y);
    adam_elem(pp.z, gg.z, mm.z, vv.z, sc.z, k, a.z, b.z, c.z);
    adam_elem(pp.w, gg.w, mm.w, vv.w, sc.w, k, a.w, b.w, c.w);
    __stcs(reinterpret_cast<float4*>(po) + i, a);
    __stcs(reinterpret_cast<float4*>(mo) + i, b);
    __stcs(reinterpret_cast<float4*>(vo) + i, c);
  }
  if (i < (n & 3)) adam_scalar(p, g, m, v, plr, po, mo, vo, s0, k, 4 * n4 + i);
}

// A leaf viewed as N rows of C channels; element (n, c) of operand j lies
// at n rs[j] + c cs[j].  Order of operands: p, g, m, v, plr, p', m', v'.
struct Strides {
  long long rs[8], cs[8];
};

// A tile of rows n0 .. n0 + tn is kept row-major in shared memory,
// t[r C + c].  An operand whose rows are its smaller stride (channel-major)
// is walked channel by channel, the others row by row, so that
// neighbouring threads touch neighbouring addresses either way.
__device__ __forceinline__ bool by_channel(long long rs, long long cs, int C) {
  return C > 1 && rs < cs;
}

__device__ __forceinline__ void load_tile(float* __restrict__ t,
                                          const float* __restrict__ src,
                                          long long rs, long long cs,
                                          long long n0, int tn, int C) {
  const int e = tn * C;
  if (by_channel(rs, cs, C)) {
    for (int i = threadIdx.x; i < e; i += blockDim.x) {
      const int c = i / tn, r = i - c * tn;
      t[r * C + c] = __ldcs(src + c * cs + (n0 + r) * rs);
    }
  } else {
    for (int i = threadIdx.x; i < e; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      t[i] = __ldcs(src + (n0 + r) * rs + c * cs);
    }
  }
}

__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float* __restrict__ t,
                                           long long rs, long long cs,
                                           long long n0, int tn, int C) {
  const int e = tn * C;
  if (by_channel(rs, cs, C)) {
    for (int i = threadIdx.x; i < e; i += blockDim.x) {
      const int c = i / tn, r = i - c * tn;
      __stcs(dst + c * cs + (n0 + r) * rs, t[r * C + c]);
    }
  } else {
    for (int i = threadIdx.x; i < e; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      __stcs(dst + (n0 + r) * rs + c * cs, t[i]);
    }
  }
}

// Operands in more than one layout, or strided: a block of THREADS
// threads per tile of T rows.  Shared memory: one tile each of p, g, m, v
// and plr (when given); p', m' and v' are written over p, m and v.
__global__ void __launch_bounds__(THREADS)
masked_adam_step_tiled(const float* __restrict__ p,
                       const float* __restrict__ g,
                       const float* __restrict__ m,
                       const float* __restrict__ v,
                       const float* __restrict__ plr, float* __restrict__ po,
                       float* __restrict__ mo, float* __restrict__ vo,
                       const float* __restrict__ lr,
                       const float* __restrict__ bias, long long N, int C,
                       int T, Strides st, Consts k) {
  extern __shared__ __align__(16) float smem[];
  const int te = T * C;
  float* tp = smem;
  float* tg = tp + te;
  float* tm = tg + te;
  float* tv = tm + te;
  float* tl = tv + te;
  const long long n0 = (long long)blockIdx.x * T;
  const int tn = (int)(N - n0 < T ? N - n0 : T);
  load_tile(tp, p, st.rs[0], st.cs[0], n0, tn, C);
  load_tile(tg, g, st.rs[1], st.cs[1], n0, tn, C);
  load_tile(tm, m, st.rs[2], st.cs[2], n0, tn, C);
  load_tile(tv, v, st.rs[3], st.cs[3], n0, tn, C);
  if (plr) load_tile(tl, plr, st.rs[4], st.cs[4], n0, tn, C);
  __syncthreads();
  const float s0 = step_scale(lr, bias);
  for (int i = threadIdx.x; i < tn * C; i += blockDim.x) {
    const float s = plr ? __fmul_rn(s0, tl[i]) : s0;
    adam_elem(tp[i], tg[i], tm[i], tv[i], s, k, tp[i], tm[i], tv[i]);
  }
  __syncthreads();
  store_tile(po, tp, st.rs[5], st.cs[5], n0, tn, C);
  store_tile(mo, tm, st.rs[6], st.cs[6], n0, tn, C);
  store_tile(vo, tv, st.rs[7], st.cs[7], n0, tn, C);
}

// One leaf of N rows of C channels.  ``strides``: 16 host int64, the
// operands' row strides then channel strides (``Strides``).  ``flat``:
// every operand dense in one order, so one flat pass over N C elements.
// plr may be null.
extern "C" int masked_adam_step(const void* p, const void* g, const void* m,
                                const void* v, const void* plr, void* po,
                                void* mo, void* vo, const void* lr,
                                const void* bias, long long N, int C,
                                const void* strides, int flat, float b1,
                                float c1, float b2, float c2, float eps,
                                int skip, void* stream) {
  if (N < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Consts k{b1, c1, b2, c2, eps, skip};
  cudaStream_t sm = (cudaStream_t)stream;
  const float* fp = (const float*)p;
  const float* fg = (const float*)g;
  const float* fm = (const float*)m;
  const float* fv = (const float*)v;
  const float* fl = (const float*)plr;
  float* op = (float*)po;
  float* om = (float*)mo;
  float* ov = (float*)vo;
  const float* flr = (const float*)lr;
  const float* fb = (const float*)bias;
  if (flat) {
    const long long n = N * C;
    const unsigned long long any =
        (unsigned long long)p | (unsigned long long)g |
        (unsigned long long)m | (unsigned long long)v |
        (unsigned long long)plr | (unsigned long long)po |
        (unsigned long long)mo | (unsigned long long)vo;
    if ((any & 15ull) == 0ull) {
      const long long threads = (n >> 2) > (n & 3) ? (n >> 2) : (n & 3);
      masked_adam_step_vec4<<<(unsigned)((threads + THREADS - 1) / THREADS),
                              THREADS, 0, sm>>>(fp, fg, fm, fv, fl, op, om,
                                                ov, flr, fb, n, k);
      return (int)cudaGetLastError();
    }
  }
  // The tiled pass: at each operand's strides, or, for a flat leaf with
  // an operand not 16-byte aligned, over its N C elements as rows of one
  // channel (every operand holds element i at offset i).
  Strides st;
  const long long* h = (const long long*)strides;
  for (int j = 0; j < 8; ++j) {
    st.rs[j] = flat ? 1 : h[j];
    st.cs[j] = flat ? 1 : h[8 + j];
  }
  if (flat) {
    N *= C;
    C = 1;
  }
  if (C > TILE_ELEMS) return (int)cudaErrorInvalidValue;
  const int T = TILE_ELEMS / C;
  const size_t smem = (size_t)(plr ? 5 : 4) * T * C * sizeof(float);
  masked_adam_step_tiled<<<(unsigned)((N + T - 1) / T), THREADS, smem, sm>>>(
      fp, fg, fm, fv, fl, op, om, ov, flr, fb, N, C, T, st, k);
  return (int)cudaGetLastError();
}
