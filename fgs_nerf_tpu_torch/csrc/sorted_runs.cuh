// Device code shared by the row-tile sorted accumulates (kernels B2 and
// B7): a stream of samples sorted by output row, whose samples of one row
// form one run, summed into a dense row space without float atomics.
//
// - Tile span search: a block that owns the output rows [a, b) finds the
//   samples of its rows with two warp-wide 32-ary searches of the sorted
//   stream (five dependent loads each for four million samples), one per
//   tile instead of one per row.
// - Staging: cp.async copies of the span into shared memory, all in
//   flight at once; a span larger than the stage is cut into passes of
//   whole rows (plan_pass), and a row too long for the stage on its own
//   is read from device memory.
// - In-tile run offsets: each thread finds the run starts of a few
//   consecutive rows in the (staged) keys, by binary search for its first
//   row and by galloping from there.
// - Long runs: a run of more than 2 x CHUNK samples is summed in a fixed
//   order from CHUNK-sample block sums.  One block per long run adds, for
//   each output channel, its head samples and the block sums of P equal
//   parts of the run in parallel, then the P parts in order and the tail
//   samples, and leaves the total in place of the run's first block sum.
//   Deterministic (bit-equal on a repeat); the association differs from
//   a serial sum (float32 reassociation).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 256
#define FULL_MASK 0xffffffffu
#define STAGE_BYTES (64 * 1024)  // shared memory for a pass's staged samples

// Host side: the samples a tile stages per pass, three times the tile's
// mean span (M / R samples a row over `rows` rows), at least 64 and at
// most what fits STAGE_BYTES at `words` 4-byte words a sample; a multiple
// of 4 (16-byte aligned stage arrays).  A denser tile runs in passes.
static inline int stage_samples(long long M, long long R, long long rows,
                                int words) {
  long long ns = (3 * M * rows + 4 * R - 1) / (4 * R) * 4;
  const long long ns_max = STAGE_BYTES / (4 * words) / 4 * 4;
  if (ns < 64) ns = 64;
  if (ns > ns_max) ns = ns_max;
  return ns < 4 ? 4 : (int)ns;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Copy n floats (or ints) from device memory to 16-byte-aligned shared
// memory with the whole block: 16-byte copies where the source is
// 16-byte aligned, 4-byte copies otherwise.  Completes with
// cp_async_wait_all() and __syncthreads().
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            long long n) {
  const float* s = (const float*)src;
  float* d = (float*)dst;
  long long i0 = 0;
  if ((((uintptr_t)s) & 15) == 0) {
    const long long n4 = n >> 2;
    for (long long i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(d + 4 * i, s + 4 * i);
    i0 = n4 << 2;
  }
  for (long long i = i0 + threadIdx.x; i < n; i += blockDim.x)
    cp_async4(d + i, s + i);
}

// First s in [lo, hi) with keys[s] >= v (hi if none), one thread.
__device__ __forceinline__ long long lower_bound(const int* keys,
                                                 long long lo, long long hi,
                                                 long long v) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)keys[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same for an answer expected close to lo: doubling steps, then a
// binary search of the last step (2 log2 of the distance loads).
__device__ __forceinline__ long long gallop(const int* keys, long long lo,
                                            long long hi, long long v) {
  long long step = 1, prev = lo;
  while (lo < hi && (long long)keys[lo] < v) {
    prev = lo + 1;
    lo += step;
    step <<= 1;
    if (lo > hi) lo = hi;
  }
  return lower_bound(keys, prev, lo, v);
}

// First s in [lo, hi) with keys[s] >= v, by one whole warp: 32 pivots per
// step (the keys below v are a prefix), so a range shrinks 32-fold per
// dependent load.  Every lane returns the answer.
__device__ __forceinline__ long long warp_lower_bound(const int* keys,
                                                      long long lo,
                                                      long long hi,
                                                      long long v) {
  // invariant: the answer lies in [lo, hi]
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) >> 5;
    // pivot i = min(lo + (i + 1) * step, hi) - 1; pivot 31 is hi - 1
    auto pivot = [&](long long i) {
      const long long e = lo + (i + 1) * step;
      return (e < hi ? e : hi) - 1;
    };
    const bool less = (long long)__ldg(keys + pivot(lane)) < v;
    const int nl = __popc(__ballot_sync(FULL_MASK, less));
    if (nl == 32) return hi;  // every pivot is below v, hi - 1 included
    // pivot nl - 1 is below v (if nl > 0), pivot nl is not
    const long long new_lo = nl == 0 ? lo : pivot(nl - 1) + 1;
    hi = pivot(nl);
    lo = new_lo;
  }
  const long long s = lo + lane;
  const bool less = s < hi && (long long)__ldg(keys + s) < v;
  return lo + __popc(__ballot_sync(FULL_MASK, less));
}

// The samples of the rows [a, b): span[0] = first s with rows[s] >= a,
// span[1] = first s with rows[s] >= b.  Warp 0 and warp 1 search at once;
// needs blockDim.x >= 64.  Ends with __syncthreads().
__device__ __forceinline__ void tile_span(const int* rows, long long M,
                                          long long a, long long b,
                                          long long* span) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long s = warp_lower_bound(rows, 0, M, warp == 0 ? a : b);
    if ((threadIdx.x & 31) == 0) span[warp] = s;
  }
  __syncthreads();
}

// One pass of a tile: its rows [row_a, row_b) and their samples [s_lo,
// s_hi) (the samples of rows [row_a - lead, row_b)); staged when those
// fit the stage.
struct Pass {
  long long row_b, s_hi;
  int staged;
};

// Plan the pass that starts at row_a, whose samples start at s_lo; the
// tile's rows end at row_end, its samples at tile_hi.  A dense tile is cut
// into passes of whole rows whose samples fit the stage of ns samples
// (ends rounded down to a multiple of 4 rows, which keeps the vector
// stores aligned); a row whose own samples (with those of the row below,
// lead = 1) do not fit takes a pass of its own, read from device memory.
// Called by warp 0 only.
__device__ __forceinline__ Pass plan_pass(const int* rows, long long row_a,
                                          long long row_end, long long s_lo,
                                          long long tile_hi, int ns) {
  Pass ps;
  if (tile_hi - s_lo <= ns) {
    ps.row_b = row_end;
    ps.s_hi = tile_hi;
    ps.staged = 1;
    return ps;
  }
  // every row below the key of sample s_lo + ns has all its samples (and
  // those of the row below) in [s_lo, s_lo + ns)
  long long row_b = __ldg(rows + s_lo + ns);
  if ((row_b & ~3LL) > row_a) row_b &= ~3LL;
  if (row_b > row_a) {
    ps.row_b = row_b;
    ps.s_hi = warp_lower_bound(rows, s_lo, s_lo + ns, row_b);
    ps.staged = 1;
  } else {
    ps.row_b = row_a + 1;
    ps.s_hi = warp_lower_bound(rows, s_lo, tile_hi, row_a + 1);
    ps.staged = 0;
  }
  return ps;
}

// starts[j] = first local s in [0, n) with keys[s] >= first_row + j, for
// j in [0, count): thread t fills a contiguous range of j, the first by
// binary search and the rest by galloping from the previous start.  keys
// may point to shared or to device memory.
__device__ __forceinline__ void fill_run_starts(int* starts, const int* keys,
                                                int n, long long first_row,
                                                int count) {
  const int per = (count + blockDim.x - 1) / blockDim.x;
  const int j0 = threadIdx.x * per;
  const int j1 = j0 + per < count ? j0 + per : count;
  long long s = 0;
  for (int j = j0; j < j1; ++j) {
    s = j == j0 ? lower_bound(keys, 0, n, first_row + j)
                : gallop(keys, s, n, first_row + j);
    starts[j] = (int)s;
  }
}

// Whole-warp sum with a fixed butterfly: every lane gets the same value,
// the same on every run.
__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, m));
  return v;
}

// Long runs.  S: [nchunk][np] block sums, written for every CHUNK-sample
// block of the stream whose samples share one row (others are left
// unwritten and never read).  A run [p, q) with q - p > 2 * CHUNK has its
// first whole block at j0 = ceil(p / CHUNK); this replaces S[j0][.] by the
// run's total over [p, q) for each of the np outputs ("pairs").  term(s,
// pair) is sample s's update for that output.  One block of
// blockDim.x >= np threads per run; part_sums: blockDim.x floats of shared
// memory.
template <class Term>
__device__ void run_total(const Term& term, float* S, int np, long long p,
                          long long q, long long j0, float* part_sums) {
  const long long a = j0 * CHUNK;
  const long long nblk = q / CHUNK - j0;
  const long long b = (j0 + nblk) * CHUNK;
  const int P = blockDim.x / np;
  const int t = threadIdx.x;
  const int pair = t % np;
  const int part = t / np;
  if (part < P) {
    float acc = 0.0f;
    if (part == 0)
      for (long long s = p; s < a; ++s) acc = __fadd_rn(acc, term(s, pair));
    const long long jl = j0 + nblk * part / P;
    const long long jh = j0 + nblk * (part + 1) / P;
    for (long long j = jl; j < jh; ++j)
      acc = __fadd_rn(acc, S[j * np + pair]);
    part_sums[part * np + pair] = acc;
  }
  __syncthreads();
  if (t < np) {
    float tot = part_sums[t];
    for (int k = 1; k < P; ++k) tot = __fadd_rn(tot, part_sums[k * np + t]);
    for (long long s = b; s < q; ++s) tot = __fadd_rn(tot, term(s, t));
    S[j0 * np + t] = tot;
  }
  __syncthreads();
}

// One block of blockDim.x threads (a multiple of 32, >= np) for the
// blockDim.x chunks from blockIdx.x * blockDim.x: each chunk that is the
// first whole block of a run longer than 2 * CHUNK gets its run's total,
// in chunk order.
template <class Term>
__device__ void run_totals_block(const int* rows, long long M,
                                 long long nchunk, float* S, int np,
                                 const Term& term) {
  __shared__ long long list[1024][2];  // (p, q) of this block's long runs
  __shared__ int warp_count[32];
  __shared__ float part_sums[1024];
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long p = 0, q = 0;
  bool found = false;
  if (j < nchunk) {
    const long long a = j * CHUNK;
    const int r = __ldg(rows + a);
    if (__ldg(rows + a + CHUNK - 1) == r &&
        (j == 0 || __ldg(rows + a - CHUNK) != r)) {
      // the run starts in ((j - 1) * CHUNK, j * CHUNK]
      p = lower_bound(rows, j == 0 ? 0 : a - CHUNK + 1, a, r);
      q = lower_bound(rows, a + CHUNK, M, (long long)r + 1);
      found = q - p > 2 * CHUNK;
    }
  }
  // compact the long runs in chunk order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ball = __ballot_sync(FULL_MASK, found);
  if (lane == 0) warp_count[warp] = __popc(ball);
  __syncthreads();
  int before = 0, total = 0;
  const int nwarps = blockDim.x >> 5;
  for (int w = 0; w < nwarps; ++w) {
    if (w < warp) before += warp_count[w];
    total += warp_count[w];
  }
  if (found) {
    const int k = before + __popc(ball & ((1u << lane) - 1u));
    list[k][0] = p;
    list[k][1] = q;
  }
  __syncthreads();
  for (int k = 0; k < total; ++k) {
    const long long pk = list[k][0], qk = list[k][1];
    run_total(term, S, np, pk, qk, (pk + CHUNK - 1) / CHUNK, part_sums);
  }
}
