// Deterministic dense accumulate of a row-sorted stream into the
// channel-major half-pack row space (kernel B2 of the port, the
// backward of B1).
//
// Replaces the TPU kernel fgs_nerf_tpu/ops/pallas/scatter_combine_cm.py:182
// (dense_accumulate_cm_pallas).  Same function as its reference
// (scatter_combine_cm.py:261-275):
//
//   D[k2*C + c, row]     += w8[2*k2,     s] * g[c, s]   for rows[s] = row
//   D[k2*C + c, row + 1] += w8[2*k2 + 1, s] * g[c, s]
//
// with every output row written (rows no sample touches are zero).
//
// Bound on an H100: bytes.  rows, w8 and g are read once and the dense
// [4C, R] output written once; the output is almost all of it: 6.54 GB at
// the fine bench shape (C = 16, R = 258 * 258 * 384), >= 2.0 ms at
// 3.35 TB/s.  Most rows are empty there (4.19M samples, 25.6M rows).
//
// Design: row tiles, no float atomics, no per-row scratch.  A block of
// 256 threads owns a tile of T = 512 consecutive output rows and all 4C
// channels:
// - it finds the samples of rows [row0 - 1, row0 + T) with two warp-wide
//   searches of the stream (the run of row0 - 1 deposits its dz = 1 half
//   in row0);
// - it stages their keys, w8 and g in shared memory with cp.async, each
//   sample value read from device memory once per tile.  A tile whose
//   samples do not fit the stage (dense traffic, up to ~8 samples a row at
//   the fine bench shape) runs in passes of whole rows that fit, cut where
//   the stage ends; a row whose own samples do not fit with the row below
//   (a long run) takes a pass of its own and reads device memory;
// - it finds each row's run offsets in the staged keys and cuts the rows
//   into groups of 4, one per thread.  A group without samples (most of
//   them: 4.19M samples over 25.6M rows at the fine bench shape) stores
//   zeros in all 4C channels, one float4 per channel, neighbouring
//   threads writing neighbouring groups.  The groups with samples are
//   listed in order and their (group, channel) pairs spread over the
//   block, so a few busy groups do not hold a whole warp through all 4C
//   channels;
// - a row adds its dz = 0 run, then the dz = 1 run of the row below, in
//   sample order with round-to-nearest multiplies and adds: the
//   reference's order (scatter of the dz = 0 updates, then of the dz = 1
//   updates), so runs of up to 2 x CHUNK samples equal the serial
//   reference bit for bit.  Where every run of a group holds at most one
//   sample (sparse traffic) the group's loads are issued at once and the
//   two adds follow, the same sums;
// - stores bypass the caches (__stcs), float4 where R and the pass are
//   4-aligned.
//
// Long runs: every masked lattice slot carries the sentinel key, clamped
// to row R - 2, so one run can hold millions of samples.  Before the
// tiles, cm_block_sums sums each CHUNK-sample block of the stream that
// lies inside one row (one warp per block, samples across lanes, a fixed
// butterfly), and cm_run_totals turns the first block sum of every run
// longer than 2 x CHUNK into that run's total for each of the 2 x 4C
// (dz, channel) outputs (sorted_runs.cuh).  A tile adds such a run as that
// one value.  Deterministic; for those runs the association differs from
// the serial reference (float32 reassociation).
#include "sorted_runs.cuh"

// Sample s's update for output pair = dz * 4C + k2 * C + c.
struct CmTerm {
  const float* w8;
  const float* g;
  long long M;
  int C;
  __device__ float operator()(long long s, int pair) const {
    const int c4 = 4 * C;
    const int dz = pair >= c4;
    const int ch = pair - dz * c4;
    const int k2 = ch / C;
    const int c = ch - k2 * C;
    return __fmul_rn(__ldg(w8 + (long long)(2 * k2 + dz) * M + s),
                     __ldg(g + (long long)c * M + s));
  }
};

// S[j][pair] for every CHUNK-sample block j inside one row; one warp per
// block, lane l holding samples l, l + 32, ..., l + 224.
__global__ void __launch_bounds__(256)
cm_block_sums(const int* __restrict__ rows, const float* __restrict__ w8,
              const float* __restrict__ g, float* __restrict__ S, int C,
              long long M, long long nchunk) {
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= nchunk) return;
  const long long a = j * CHUNK;
  if (__ldg(rows + a) != __ldg(rows + a + CHUNK - 1)) return;
  const int np = 8 * C;
  float w[8][8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[k][i] = __ldg(w8 + (long long)k * M + a + lane + 32 * i);
  for (int c = 0; c < C; ++c) {
    float gv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      gv[i] = __ldg(g + (long long)c * M + a + lane + 32 * i);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float p = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) p = __fadd_rn(p, __fmul_rn(w[k][i], gv[i]));
      p = warp_sum(p);
      // k = 2 * k2 + dz -> pair dz * 4C + k2 * C + c
      if (lane == k) S[j * np + (k & 1) * 4 * C + (k >> 1) * C + c] = p;
    }
  }
}

__global__ void __launch_bounds__(1024)
cm_run_totals(const int* __restrict__ rows, const float* __restrict__ w8,
              const float* __restrict__ g, float* __restrict__ S, int C,
              long long M, long long nchunk) {
  run_totals_block(rows, M, nchunk, S, 8 * C, CmTerm{w8, g, M, C});
}

// acc + the updates w[s] * g[s] of the local run [p, q) (stride: the
// row stride of w and g), or + its total from S when it is long.
__device__ __forceinline__ float cm_run_add(float acc, const float* w,
                                            const float* gc, int p, int q,
                                            long long lo,
                                            const float* __restrict__ S,
                                            int np, int pair) {
  if (q - p > 2 * CHUNK) {
    const long long j0 = (lo + p + CHUNK - 1) / CHUNK;
    return __fadd_rn(acc, __ldg(S + j0 * np + pair));
  }
  for (int s = p; s < q; ++s) acc = __fadd_rn(acc, __fmul_rn(w[s], gc[s]));
  return acc;
}

// One block of 256 threads per tile of T rows (a multiple of 4).  Shared
// memory: starts[T + 2] and busy[T / 4] (each padded to 4), then keys[NS],
// w8[8][NS], g[C][NS].
__global__ void __launch_bounds__(256)
cm_tile_accumulate(const int* __restrict__ rows, const float* __restrict__ w8,
                   const float* __restrict__ g, const float* __restrict__ S,
                   float* __restrict__ out, int C, long long R, long long M,
                   int T, int NS) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long span[2];
  __shared__ Pass pass;
  __shared__ int warp_busy[32];
  int* starts = (int*)smem;
  int* busy = starts + (T + 2 + 3) / 4 * 4;  // groups with samples
  int* skey = busy + (T / 4 + 3) / 4 * 4;
  float* sw = (float*)(skey + NS);
  float* sg = sw + 8 * NS;
  const long long row0 = (long long)blockIdx.x * T;
  const long long row_end = R - row0 < T ? R : row0 + T;
  const int c4 = 4 * C, np = 8 * C;
  const bool r4 = (R & 3) == 0;

  tile_span(rows, M, row0 - 1, row0 + T, span);
  const long long tile_hi = span[1];
  long long s_lo = span[0];  // first sample of row row_a - 1
  long long row_a = row0;
  while (row_a < row_end) {
    if (threadIdx.x < 32) {
      const Pass ps = plan_pass(rows, row_a, row_end, s_lo, tile_hi, NS);
      if (threadIdx.x == 0) pass = ps;
    }
    __syncthreads();
    const long long row_b = pass.row_b;
    const bool staged = pass.staged;
    const int n = (int)(pass.s_hi - s_lo);
    const int nr = (int)(row_b - row_a);
    if (staged && n > 0) {
      stage_words(skey, rows + s_lo, n);
      for (int k = 0; k < 8; ++k)
        stage_words(sw + k * NS, w8 + (long long)k * M + s_lo, n);
      for (int c = 0; c < C; ++c)
        stage_words(sg + c * NS, g + (long long)c * M + s_lo, n);
    }
    cp_async_wait_all();
    __syncthreads();
    // starts[j]: first local sample of row row_a - 1 + j
    fill_run_starts(starts, staged ? skey : rows + s_lo, n, row_a - 1, nr + 2);
    __syncthreads();

    const float* wsrc = staged ? sw : w8 + s_lo;
    const float* gsrc = staged ? sg : g + s_lo;
    const long long stride = staged ? NS : M;
    // groups of 4 consecutive rows, one per thread.  A group without
    // samples stores zeros in every channel (neighbouring threads,
    // neighbouring groups); the others are listed in order and their
    // (group, channel) pairs spread over the whole block.
    const int ng = (nr + 3) >> 2;  // <= T / 4 <= blockDim.x
    const int grp = threadIdx.x;
    const int j0g = 4 * grp;
    const int nvg = nr - j0g < 4 ? nr - j0g : 4;
    const bool has = grp < ng && starts[j0g] != starts[j0g + nvg + 1];
    // list the groups with samples in order (warp ballots, then the warps'
    // counts in order)
    const unsigned ball = __ballot_sync(FULL_MASK, has);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_busy[warp] = __popc(ball);
    __syncthreads();
    int before = 0, nb = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      before += w < warp ? warp_busy[w] : 0;
      nb += warp_busy[w];
    }
    if (has) busy[before + __popc(ball & ((1u << lane) - 1u))] = grp;
    if (grp < ng && !has) {
      const long long row = row_a + j0g;
      float* o = out + row;
      if (r4 && (row & 3) == 0 && nvg == 4) {
        for (int ch = 0; ch < c4; ++ch, o += R)
          __stcs((float4*)o, make_float4(0.f, 0.f, 0.f, 0.f));
      } else {
        for (int ch = 0; ch < c4; ++ch, o += R)
          for (int i = 0; i < nvg; ++i) __stcs(o + i, 0.0f);
      }
    }
    __syncthreads();
    for (int it = threadIdx.x; it < nb * c4; it += blockDim.x) {
      const int ch = it / nb;
      const int j0 = 4 * busy[it - ch * nb];
      const int nv = nr - j0 < 4 ? nr - j0 : 4;
      const int k2 = ch / C;
      const int c = ch - k2 * C;
      const float* we = wsrc + (long long)(2 * k2) * stride;
      const float* wo = we + stride;
      const float* gc = gsrc + (long long)c * stride;
      // b[i]: first local sample of row row_a + j0 - 1 + i
      int b[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) b[i] = starts[j0 + (i <= nv + 1 ? i : nv + 1)];
      float v[4];
      bool single = true;  // every run of the group holds at most one sample
#pragma unroll
      for (int k = 0; k < 5; ++k) single &= b[k + 1] - b[k] <= 1;
      if (single) {
        // the run of row row_a + j0 - 1 + k is dz = 1 of row k and dz = 0 of
        // row k - 1 of the group: all loads at once, then the reference's
        // order (0 + dz = 0 update + dz = 1 update; an absent update adds
        // +0, which leaves every sum as the serial one)
        float x0[4], x1[4];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const bool has = b[k + 1] > b[k];
          const int sk = has ? b[k] : 0;
          const float gv = has ? gc[sk] : 0.0f;
          if (k >= 1) x0[k - 1] = has ? __fmul_rn(we[sk], gv) : 0.0f;
          if (k <= 3) x1[k] = has ? __fmul_rn(wo[sk], gv) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = __fadd_rn(__fadd_rn(0.0f, x0[i]), x1[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // row row_a + j0 + i: its own run (dz = 0), then the run of the
          // row below (dz = 1)
          const float acc = cm_run_add(0.0f, we, gc, b[i + 1], b[i + 2], s_lo,
                                       S, np, ch);
          v[i] = cm_run_add(acc, wo, gc, b[i], b[i + 1], s_lo, S, np, c4 + ch);
        }
      }
      const long long row = row_a + j0;
      float* o = out + (long long)ch * R + row;
      if (r4 && (row & 3) == 0 && nv == 4) {
        __stcs((float4*)o, make_float4(v[0], v[1], v[2], v[3]));
      } else {
        for (int i = 0; i < nv; ++i) __stcs(o + i, v[i]);
      }
    }
    s_lo += starts[nr];  // first sample of row row_b - 1
    row_a = row_b;
    __syncthreads();
  }
}

// Rows of a tile: a multiple of 4, one 4-row group per thread (at most
// 4 x 256).
#define TILE_ROWS 512
static_assert(TILE_ROWS % 4 == 0 && TILE_ROWS <= 4 * 256, "tile rows");

// rows: int32 [M] non-decreasing in [0, R - 2]; w8: f32 [8, M]; g: f32
// [C, M]; out: f32 [4C, R].  block_sums: f32 scratch of (M / CHUNK) * 8C
// entries.
extern "C" int dense_accumulate_cm(const void* rows, const void* w8,
                                   const void* g, void* block_sums,
                                   void* out, int C, long long R, long long M,
                                   void* stream) {
  if (C < 1 || R < 2) return (int)cudaErrorInvalidValue;
  const int T = TILE_ROWS;
  // a staged sample: its key, w8[8] and g[C]; the span of a tile's rows
  // and the row below
  const int ns = stage_samples(M, R, T + 2, 9 + C);
  cudaStream_t st = (cudaStream_t)stream;
  const int* r = (const int*)rows;
  const float* w = (const float*)w8;
  const float* gg = (const float*)g;
  float* S = (float*)block_sums;
  const long long nchunk = M / CHUNK;
  if (nchunk > 0) {
    cm_block_sums<<<(unsigned)((nchunk * 32 + 255) / 256), 256, 0, st>>>(
        r, w, gg, S, C, M, nchunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cm_run_totals<<<(unsigned)((nchunk + 1023) / 1024), 1024, 0, st>>>(
        r, w, gg, S, C, M, nchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem =
      (size_t)((T + 2 + 3) / 4 * 4 + (T / 4 + 3) / 4 * 4 + (long long)ns * (9 + C)) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cm_tile_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cm_tile_accumulate<<<(unsigned)((R + T - 1) / T), 256, smem, st>>>(
      r, w, gg, S, (float*)out, C, R, M, T, ns);
  return (int)cudaGetLastError();
}
