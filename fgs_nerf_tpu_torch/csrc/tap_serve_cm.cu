// Multi-tap serve of a row-sorted sample stream from a 1-channel half
// cell pack (kernel B5 of the port) and its backward, the multi-tap dense
// accumulate (kernel B6).  These are the fine stage's hierarchical
// finite-difference taps: tap t of sample m is a trilinear serve at row
// rows[m] + delta[t, m] with its own corner weights.
//
// B5 replaces the TPU kernel fgs_nerf_tpu/ops/pallas/tap_serve_cm.py:158
// (tap_window_serve_cm_pallas).  Same function as its reference
// (tap_serve_cm.py:211-224):
//
//   out[t, m] = sum_d sum_k2 w8t[8t + 4d + k2, m] * pack[k2, rows[m] + delta[t, m] + d]
//
// The TPU kernel serves a widened VMEM window with one-hot MXU products
// because the TPU has no vector gather.  Here a thread owns one sample
// and serves all T taps in turn, four taps' loads in flight at once (T is
// a template parameter for the fine stage's 16 z/y and 8 x taps); a block
// holds 256 consecutive sorted samples.  B5 is a stream: delta, w8t (80%
// of the bytes) and the output are read or written once, so a warp's
// consecutive samples move them as whole 128-byte lines, past the caches
// (__ldcs / __stcs), which keeps L1 and L2 for the pack.  Its 8 pack values
// per tap are gathered from device memory: the tap columns of a warp lie
// close together (sorted rows, deltas within tap_bounds' envelope) and hit
// L1/L2, and the pack is ~4% of the bytes.  (A shared-memory copy of each
// tile's pack window, as B1 stages, was no faster on the z/y call and
// slower on the x call on an H100: the stage left fewer blocks an SM.  The
// first design, a thread per (tap, sample) with a dependent rows -> delta
// -> pack chain per thread, reached half the bound.)  The sum runs in the
// plain twin's order with round-to-nearest multiplies and adds (no FMA
// contraction): per d, ((p0 w0 + p1 w1) + p2 w2) + p3 w3, then
// (0 + s_0) + s_1 — bit-equal to the twin.
//
// Bound of B5 on an H100: bytes.  rows, delta, w8t and the output once,
// and the pack columns the taps touch once, in whole 32-byte sectors: at
// the fine bench's z/y call (T = 16, M = 1,048,576) ~0.71 GB, >= 0.21 ms
// at 3.35 TB/s.
//
// B6 replaces fgs_nerf_tpu/ops/pallas/tap_serve_cm.py:358
// (tap_dense_accumulate_cm_pallas).  Same function as its reference
// (tap_serve_cm.py:430-442):
//
//   D[k2, rows[m] + delta[t, m] + d] += w8t[8t + 4d + k2, m] * g[t, m]
//
// with every output row written.  It must be deterministic, so no float
// atomics.  Unlike B2's stream, the deposit rows rows + delta_t are only
// nearly sorted (samples of one base row can floor to neighbouring tap
// cells, y taps jump whole z strides), so the wrapper first sorts the
// T * M deposit keys rows + delta_t (flat index e = t * M + m) stably with
// torch.sort; the kernel reads the sorted keys and the permutation.
//
// Bound of B6 on an H100: bytes.  rows, delta, w8t and g read once and the
// dense [4, cap] output written once: ~1.08 GB at the fine bench's z/y
// call (T = 16, M = 1,048,576, cap ~ 25.56M), >= 0.32 ms at 3.35 TB/s.
// Most output rows are empty there (16.8M deposits over 25.56M rows).
//
// Design: row tiles on sorted_runs.cuh, as B2 and B7; no float atomics,
// no per-row scratch, no thread per row of the whole row space.  A block
// of 256 threads owns TILE_ROWS = 1024 consecutive output rows [a, b):
// - it finds the deposits of the keys [a - 1, b) with two warp-wide
//   searches (tile_span); key a - 1 is included because its d = 1
//   deposits land on row a.  A tile without deposits does that, writes
//   zeros and leaves;
// - it stages the span's keys in shared memory with cp.async, and each
//   deposit's flat index e = t * M + m from the permutation (32-bit:
//   T * M < 2^31).  A span larger than the stage runs in passes of whole
//   rows (plan_pass); a row whose runs do not fit the stage on their own
//   takes a pass of its own and reads device memory through the
//   permutation, merging its two runs by tap;
// - it finds each row's runs in the staged keys (fill_run_starts): row r
//   adds key r's deposits with d = 0 and key r - 1's with d = 1;
// - each deposit then reads its payload through the permutation (g[e] and
//   the 8 w8t values, one gather each, every thread a few deposits in
//   flight), forms its 8 rounded products w8t[8t + 4d + k2, m] * g[e]
//   once, and writes them as its two roles, a float4 each: the d = 0
//   role in its key's row, the d = 1 role in the row above, each at its
//   place in that row's (t, d, m) order, the JAX reference's serial
//   scatter order, which the plain twin keeps too.  Both runs are sorted
//   by e, so that place is the deposit's index in its run plus the
//   neighbouring run's deposits of a smaller tap (d = 0: e < t * M) or of
//   a tap no larger (d = 1: e < (t + 1) * M), one binary search of the
//   staged e;
// - one thread per 4 consecutive rows sums each row's roles in order, a
//   contiguous range of shared memory with no data-dependent branch, so
//   a row whose runs hold at most 2 x CHUNK deposits each equals the twin
//   bit for bit; then writes its 4 rows of each channel with one float4
//   store (the wrapper pads the output's row stride to a multiple of 4),
//   scalar stores only where a pass ends off a 4-row boundary.
//   (A first version merged the two runs by tap in the row loop itself:
//   each step waited on the tap it had just loaded, and with the fine
//   stage's runs of tens of deposits that loop took most of the call.)
// Reading the payload through the permutation, rather than a separate
// pass that first permutes it into sorted order, keeps the 8 products out
// of device memory (~1.1 GB written and read again at the z/y call).
//
// Long runs: every sentinel sample shares one base row, so masked
// traffic piles most of the stream onto a few keys.  Before the tiles,
// tap_block_sums sums each CHUNK-deposit block of the sorted stream whose
// keys are all equal (one warp per block, a fixed butterfly), and
// tap_run_totals turns the first block sum of every run longer than
// 2 x CHUNK into that run's total for each of the 8 (d, k2) outputs, one
// block per long run adding P parts in parallel and then in order
// (sorted_runs.cuh).  A row with such a run places its roles as its d = 0
// run, then its d = 1 run, and adds them in that order, a long run as
// its total.  Deterministic; for those rows the association differs from
// the serial reference (float32 reassociation).
//
// Sizes: TILE_ROWS = 1024 gives each of the 256 threads one 4-row group
// (every lane busy in the stores) and halves the tile searches of a
// 512-row tile.  The stage is three times a tile's mean span
// (stage_samples), at most STAGE_DEPOSITS = 1,024 deposits of 40 bytes
// (key, e, two float4 roles): 45 KB with the run starts, so four blocks
// of 56 registers a thread fit an SM.  The fine stage's samples crowd the
// surface, so the tiles there run in a few passes, and the kernel's pace
// is the latency of a pass's steps (searches, the payload gathers)
// times the passes: a 64 KB stage (three blocks an SM, fewer passes) and
// smaller stages with fewer registers (spills) were slower on an H100.
#include "sorted_runs.cuh"

#define B5_THREADS 256  // samples of a block, one a thread

// One tap of one sample: its 8 weights at stride M from w (streamed past
// the caches) and its 8 pack values at column col (L1/L2 gathers), summed
// in the plain twin's order.
__device__ __forceinline__ float tap_value(const float* __restrict__ pack,
                                           long long rp, long long col,
                                           const float* __restrict__ w,
                                           long long M) {
  float wk[8], p[8];  // [d][k2]
#pragma unroll
  for (int k = 0; k < 8; ++k) wk[k] = __ldcs(w + k * M);
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = __ldg(pack + (k & 3) * rp + col + (k >> 2));
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    float s = __fmul_rn(p[4 * d], wk[4 * d]);
    s = __fadd_rn(s, __fmul_rn(p[4 * d + 1], wk[4 * d + 1]));
    s = __fadd_rn(s, __fmul_rn(p[4 * d + 2], wk[4 * d + 2]));
    s = __fadd_rn(s, __fmul_rn(p[4 * d + 3], wk[4 * d + 3]));
    acc = __fadd_rn(acc, s);
  }
  return acc;
}

// T is a template parameter for the fine stage's two calls (16 z/y taps,
// 8 x taps), 0 for any other count.
template <int TT>
__global__ void __launch_bounds__(B5_THREADS)
tap_serve_samples(const float* __restrict__ pack, const int* __restrict__ rows,
                  const int* __restrict__ delta, const float* __restrict__ w8t,
                  float* __restrict__ out, long long rp, int t_rt,
                  long long M) {
  const int T = TT > 0 ? TT : t_rt;
  const long long m = (long long)blockIdx.x * B5_THREADS + threadIdx.x;
  if (m >= M) return;
  const long long r = __ldg(rows + m);
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const long long col = r + __ldcs(delta + t * M + m);
    __stcs(out + t * M + m,
           tap_value(pack, rp, col, w8t + 8LL * t * M + m, M));
  }
}

// Deposit s of the sorted stream: its product for output pair = 4d + k2,
// w8t[8t + pair, m] * g[e] with e = perm[s] = t * M + m.
struct TapTerm {
  const long long* perm;
  const float* w8t;
  const float* g;
  int M;
  __device__ __forceinline__ float operator()(long long s, int pair) const {
    const int e = (int)__ldg(perm + s);
    const int t = e / M;
    const int m = e - t * M;
    return __fmul_rn(__ldg(w8t + (long long)(8 * t + pair) * M + m),
                     __ldg(g + e));
  }
};

// S[j][pair] for every CHUNK-deposit block j whose keys are all equal;
// one warp per block, lane l holding deposits l, l + 32, ..., l + 224.
__global__ void __launch_bounds__(256)
tap_block_sums(const int* __restrict__ keys, const long long* __restrict__ perm,
               const float* __restrict__ w8t, const float* __restrict__ g,
               float* __restrict__ S, int M, long long nchunk) {
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= nchunk) return;
  const long long a = j * CHUNK;
  if (__ldg(keys + a) != __ldg(keys + a + CHUNK - 1)) return;
  float p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < CHUNK / 32; ++i) {
    const int e = (int)__ldg(perm + a + lane + 32 * i);
    const int t = e / M;
    const float gv = __ldg(g + e);
    const float* w = w8t + (long long)8 * t * M + (e - t * M);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      p[k] = __fadd_rn(p[k], __fmul_rn(__ldg(w + (long long)k * M), gv));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v = warp_sum(p[k]);
    if (lane == k) S[j * 8 + k] = v;
  }
}

__global__ void __launch_bounds__(1024)
tap_run_totals(const int* __restrict__ keys, const long long* __restrict__ perm,
               const float* __restrict__ w8t, const float* __restrict__ g,
               float* __restrict__ S, int M, long long n, long long nchunk) {
  run_totals_block(keys, n, nchunk, S, 8, TapTerm{perm, w8t, g, M});
}

// acc + the total of the run longer than 2 x CHUNK that starts at sorted
// position s, for corner row d (tap_run_totals left it in place of the
// run's first whole block sum).
__device__ __forceinline__ void add_run_total(float acc[4],
                                              const float* __restrict__ S,
                                              long long s, int d) {
  const long long j0 = (s + CHUNK - 1) / CHUNK;
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2)
    acc[k2] = __fadd_rn(acc[k2], __ldg(S + j0 * 8 + 4 * d + k2));
}

// acc + the run [p, q) of deposits of corner row d, read from device
// memory through the permutation (term.perm points at the pass's first
// sorted position s_lo), in stream order, or its total when it is longer
// than 2 x CHUNK.
__device__ __forceinline__ void tap_run_add(float acc[4], const TapTerm& term,
                                            int p, int q, int d,
                                            long long s_lo,
                                            const float* __restrict__ S) {
  if (q - p > 2 * CHUNK) {
    add_run_total(acc, S, s_lo + p, d);
    return;
  }
  for (int i = p; i < q; ++i)
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2)
      acc[k2] = __fadd_rn(acc[k2], term(i, 4 * d + k2));
}

// acc + the staged roles r[k0, k1), in order.
__device__ __forceinline__ void add_roles(float acc[4], const float4* r,
                                          int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    const float4 x = r[k];
    acc[0] = __fadd_rn(acc[0], x.x);
    acc[1] = __fadd_rn(acc[1], x.y);
    acc[2] = __fadd_rn(acc[2], x.z);
    acc[3] = __fadd_rn(acc[3], x.w);
  }
}

// One row of an unstaged pass (its runs do not fit the stage): its d = 0
// run [p0, q0) (key r) and d = 1 run [p1, p0) (key r - 1), read through
// the permutation.  Short runs merge by tap, in (t, d, m) order (each run
// is sorted by e = t * M + m); a row with a long run adds its d = 0 run,
// then its d = 1 run.
__device__ __forceinline__ void tap_row_sum_unstaged(
    float acc[4], const TapTerm& term, int p1, int p0, int q0, long long s_lo,
    const float* __restrict__ S) {
  const int q1 = p0;
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) acc[k2] = 0.0f;
  if (q0 - p0 > 2 * CHUNK || q1 - p1 > 2 * CHUNK) {
    tap_run_add(acc, term, p0, q0, 0, s_lo, S);
    tap_run_add(acc, term, p1, q1, 1, s_lo, S);
    return;
  }
  auto tap = [&](int i) { return (int)__ldg(term.perm + i) / term.M; };
  const int none = 0x7fffffff;
  int i = p0, j = p1;
  int ti = i < q0 ? tap(i) : none;
  int tj = j < q1 ? tap(j) : none;
  while (i < q0 || j < q1) {
    const int d = ti <= tj ? 0 : 1;
    const int s = d ? j++ : i++;
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2)
      acc[k2] = __fadd_rn(acc[k2], term(s, 4 * d + k2));
    if (d) tj = j < q1 ? tap(j) : none;
    else ti = i < q0 ? tap(i) : none;
  }
}

// Rows of a tile: one 4-row group per thread of the 256.
#define TILE_ROWS 1024
#define TILE_THREADS 256
#define STAGE_WORDS 10  // a staged deposit: key, e, its two 4-product roles
#define STAGE_DEPOSITS 1024  // the most a pass stages: 45 KB, 4 blocks an SM
static_assert(TILE_ROWS == 4 * TILE_THREADS, "one 4-row group a thread");

// Shared memory: starts[TILE_ROWS + 2] (padded to 4), then keys[NS], the
// flat indices e[NS] and the roles' products, float4 [2 NS].
static inline size_t tap_tile_smem(int ns) {
  return (size_t)((TILE_ROWS + 2 + 3) / 4 * 4 + (long long)STAGE_WORDS * ns) * 4;
}

// keys: the n sorted deposit keys in [0, R - 2]; perm: their flat indices;
// out: [4][ld] with ld >= R a multiple of 4 (16-byte aligned rows).
__global__ void __launch_bounds__(TILE_THREADS)
tap_tile_accumulate(const int* __restrict__ keys,
                    const long long* __restrict__ perm,
                    const float* __restrict__ w8t, const float* __restrict__ g,
                    const float* __restrict__ S, float* __restrict__ out,
                    int M, long long n, long long R, long long ld, int NS) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long span[2];
  __shared__ Pass pass;
  int* starts = (int*)smem;
  int* skey = starts + (TILE_ROWS + 2 + 3) / 4 * 4;
  int* se = skey + NS;
  float4* roles = (float4*)(se + NS);
  const long long row0 = (long long)blockIdx.x * TILE_ROWS;
  const long long row_end = R - row0 < TILE_ROWS ? R : row0 + TILE_ROWS;

  tile_span(keys, n, row0 - 1, row_end, span);
  const long long tile_hi = span[1];
  long long s_lo = span[0];  // first deposit of key row_a - 1
  long long row_a = row0;
  while (row_a < row_end) {
    if (threadIdx.x < 32) {
      const Pass ps = plan_pass(keys, row_a, row_end, s_lo, tile_hi, NS);
      if (threadIdx.x == 0) pass = ps;
    }
    __syncthreads();
    const long long row_b = pass.row_b;
    const bool staged = pass.staged;
    const int nd = (int)(pass.s_hi - s_lo);
    const int nr = (int)(row_b - row_a);
    if (staged) {
      stage_words(skey, keys + s_lo, nd);
      for (int i = threadIdx.x; i < nd; i += TILE_THREADS)
        se[i] = (int)__ldg(perm + s_lo + i);
    }
    cp_async_wait_all();
    __syncthreads();
    // starts[j]: first local deposit of key row_a - 1 + j; row jr of the
    // pass adds the key runs jr + 1 (d = 0) and jr (d = 1)
    fill_run_starts(starts, staged ? skey : keys + s_lo, nd, row_a - 1,
                    nr + 2);
    __syncthreads();
    // the roles of row jr start at starts[jr] + starts[jr + 1] - starts[1]
    const int s1 = starts[1];
    if (staged) {
      // every deposit: its 8 products, written as its d = 0 role (row of
      // its key) and its d = 1 role (the row above) at their places in
      // those rows' order: (t, d, m), or for a row with a run longer than
      // 2 x CHUNK, its d = 0 run and then its d = 1 run
#pragma unroll 2
      for (int i = threadIdx.x; i < nd; i += TILE_THREADS) {
        const int e = se[i];
        const int t = e / M;
        const float gv = __ldg(g + e);
        const float* w = w8t + (long long)8 * t * M + (e - t * M);
        float p[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          p[k] = __fmul_rn(__ldg(w + (long long)k * M), gv);
        const int jk = skey[i] - (int)(row_a - 1);  // key run of i
        const int a = starts[jk], b = starts[jk + 1];
        if (jk >= 1) {  // d = 0 role, row jk - 1, after its d = 1 run [lo, a)
          const int lo = starts[jk - 1];
          const bool lng = b - a > 2 * CHUNK || a - lo > 2 * CHUNK;
          // the d = 1 run's deposits of a tap below t: e < t * M
          const int before =
              lng ? 0 : (int)lower_bound(se, lo, a, (long long)t * M) - lo;
          roles[lo + a - s1 + (i - a) + before] =
              make_float4(p[0], p[1], p[2], p[3]);
        }
        if (jk < nr) {  // d = 1 role, row jk, after its d = 0 run [b, c)
          const int c = starts[jk + 2];
          const bool lng = c - b > 2 * CHUNK || b - a > 2 * CHUNK;
          // the d = 0 run's deposits of a tap up to t: e < (t + 1) * M
          const int before = lng ? c - b
                                 : (int)lower_bound(se, b, c, (long long)(t + 1) * M) - b;
          roles[a + b - s1 + (i - a) + before] =
              make_float4(p[4], p[5], p[6], p[7]);
        }
      }
    }
    __syncthreads();

    const int j0 = 4 * threadIdx.x;
    if (j0 < nr) {
      const int nv = nr - j0 < 4 ? nr - j0 : 4;
      const TapTerm term{perm + s_lo, w8t, g, M};
      float v[4][4];  // [row][k2]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) v[i][k2] = 0.0f;
        if (i >= nv) continue;
        const int jr = j0 + i;
        const int p1 = starts[jr], p0 = starts[jr + 1], q0 = starts[jr + 2];
        if (p1 == q0) continue;
        if (!staged) {
          tap_row_sum_unstaged(v[i], term, p1, p0, q0, s_lo, S);
          continue;
        }
        // the row's roles in order; with a long run, the d = 0 run's roles
        // or total, then the d = 1 run's
        const float4* r = roles + p1 + p0 - s1;
        const int len0 = q0 - p0, len1 = p0 - p1;
        if (len0 <= 2 * CHUNK && len1 <= 2 * CHUNK) {
          add_roles(v[i], r, 0, len0 + len1);
          continue;
        }
        if (len0 > 2 * CHUNK) add_run_total(v[i], S, s_lo + p0, 0);
        else add_roles(v[i], r, 0, len0);
        if (len1 > 2 * CHUNK) add_run_total(v[i], S, s_lo + p1, 1);
        else add_roles(v[i], r, len0, len0 + len1);
      }
      const long long row = row_a + j0;
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        float* o = out + k2 * ld + row;
        if ((row & 3) == 0 && nv == 4) {
          __stcs((float4*)o, make_float4(v[0][k2], v[1][k2], v[2][k2],
                                         v[3][k2]));
        } else {
          for (int i = 0; i < nv; ++i) __stcs(o + i, v[i][k2]);
        }
      }
    }
    s_lo += starts[nr];  // first deposit of key row_b - 1
    row_a = row_b;
    __syncthreads();
  }
}

template <int TT>
static cudaError_t launch_b5(const float* pack, const int* rows,
                             const int* delta, const float* w8t, float* out,
                             long long rp, int T, long long M,
                             cudaStream_t st) {
  tap_serve_samples<TT><<<(unsigned)((M + B5_THREADS - 1) / B5_THREADS),
                          B5_THREADS, 0, st>>>(pack, rows, delta, w8t, out,
                                               rp, T, M);
  return cudaGetLastError();
}

extern "C" int tap_window_serve_cm(const void* pack, const void* rows,
                                   const void* delta, const void* w8t,
                                   void* out, long long rp, int T,
                                   long long M, void* stream) {
  if (T <= 0 || M <= 0) return (int)cudaGetLastError();
  const float* p = (const float*)pack;
  const int* r = (const int*)rows;
  const int* d = (const int*)delta;
  const float* w = (const float*)w8t;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (T) {
    case 16: return (int)launch_b5<16>(p, r, d, w, o, rp, T, M, st);
    case 8: return (int)launch_b5<8>(p, r, d, w, o, rp, T, M, st);
    default: return (int)launch_b5<0>(p, r, d, w, o, rp, T, M, st);
  }
}

// The deposits a tile stages per pass for n deposits over R rows.
static inline int tap_stage_deposits(long long n, long long R) {
  const int ns = stage_samples(n, R, TILE_ROWS + 2, STAGE_WORDS);
  return ns < STAGE_DEPOSITS ? ns : STAGE_DEPOSITS;
}

// keys_sorted / perm: the T * M deposit keys rows + delta_t (int32, in
// [0, R - 2]) sorted stably and their flat indices t * M + m (int64);
// block_sums: f32 scratch of 8 * (T * M / CHUNK) entries; out: f32
// [4][ld], ld >= R a multiple of 4 (all allocated by the caller).
extern "C" int tap_dense_accumulate_cm(const void* keys_sorted,
                                       const void* perm, const void* w8t,
                                       const void* g, void* block_sums,
                                       void* out, int T, long long M,
                                       long long R, long long ld,
                                       void* stream) {
  const long long n = (long long)T * M;
  if (R < 2 || ld < R || (ld & 3) || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* k = (const int*)keys_sorted;
  const long long* p = (const long long*)perm;
  const float* w = (const float*)w8t;
  const float* gg = (const float*)g;
  float* S = (float*)block_sums;
  const long long nchunk = n / CHUNK;
  if (nchunk > 0) {
    tap_block_sums<<<(unsigned)((nchunk * 32 + 255) / 256), 256, 0, st>>>(
        k, p, w, gg, S, (int)M, nchunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tap_run_totals<<<(unsigned)((nchunk + 1023) / 1024), 1024, 0, st>>>(
        k, p, w, gg, S, (int)M, n, nchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int ns = tap_stage_deposits(n, R);
  const size_t smem = tap_tile_smem(ns);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tap_tile_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tap_tile_accumulate<<<(unsigned)((R + TILE_ROWS - 1) / TILE_ROWS),
                        TILE_THREADS, smem, st>>>(k, p, w, gg, S, (float*)out,
                                                  (int)M, n, R, ld, ns);
  return (int)cudaGetLastError();
}

// Report only: dynamic shared memory per tile block for n deposits over
// R rows.
extern "C" long long tap_dense_accumulate_smem_bytes(long long n,
                                                     long long R) {
  return (long long)tap_tile_smem(tap_stage_deposits(n, R));
}
