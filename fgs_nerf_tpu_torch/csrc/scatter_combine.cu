// Deterministic row-major sorted scatter-add (kernel B7 of the port, the
// lattice engine's grid-gradient accumulate).
//
// Replaces the TPU kernel fgs_nerf_tpu/ops/pallas/scatter_combine.py:118
// (dense_accumulate_pallas).  Same function as its reference, the
// sorted scatter-add of fgs_nerf_tpu/ops/scatter.py:57-64:
//
//   D[row, c] = sum of upd[s, c] over the samples s with rows[s] = row
//
// for a non-decreasing stream rows[0..M) of rows in [0, cap); every one
// of the cap output rows is written, rows no sample touches as zeros.
// The TPU kernel slides a 2B-row VMEM accumulator and adds each block
// with a one-hot [B, B] x [B, C] MXU product because the TPU has no
// vector scatter; none of that is needed here.
//
// Bound on an H100: bytes.  rows and upd are read once and the dense
// [cap, C] f32 output written once: at the fine field shape (M =
// 4,194,304, C = 104, cap = 258^3) about 8.9 GB, >= 2.7 ms at 3.35 TB/s;
// three quarters of those rows are empty.
//
// Design: row tiles, no float atomics, no per-row scratch.  A block of
// 256 threads owns a tile of T consecutive rows (T a multiple of 4 near
// 16,384 / C), whose [T, C] output is one contiguous span of T * C floats:
// - it finds the samples of its rows with two warp-wide searches of the
//   stream and stages their keys and update rows in shared memory with
//   cp.async.  A tile whose samples do not fit the stage runs in passes of
//   whole rows that fit (a multiple of 4 rows where it can); a row whose
//   own run does not fit takes a pass of its own and reads device memory;
// - it finds each row's run in the staged keys; each thread computes four
//   consecutive floats of the pass's flat output at a time, each the sum
//   of its channel over its row's run in sample order with
//   round-to-nearest adds (the serial reference's order, so runs of up to
//   2 x CHUNK samples equal it bit for bit), and writes them with one
//   float4 store that bypasses the caches: every lane busy for any C, the
//   tile's span written in full lines, scalar stores only where a pass
//   starts off a 16-byte boundary or the row space ends.  A tile without
//   samples only stores zeros.
//
// Long runs: masked lattice slots are clipped onto boundary base cells
// (ops/scatter.py:103-109), so a few rows can receive very long runs.
// Before the tiles, rowmajor_block_sums sums each CHUNK-sample block of
// the stream that lies inside one row (one warp per block, channels across
// lanes), and rowmajor_run_totals turns the first block sum of every run
// longer than 2 x CHUNK into that run's total (sorted_runs.cuh); a tile
// adds such a run as that one value.  Deterministic; for those runs the
// association differs from the serial reference (float32 reassociation).
#include "sorted_runs.cuh"

struct RowTerm {
  const float* upd;
  int C;
  __device__ float operator()(long long s, int c) const {
    return __ldg(upd + s * C + c);
  }
};

// S[j][c] for every CHUNK-sample block j inside one row; one warp per
// block, lanes across channels, samples in order.
__global__ void __launch_bounds__(256)
rowmajor_block_sums(const int* __restrict__ rows,
                    const float* __restrict__ upd, float* __restrict__ S,
                    int C, long long nchunk) {
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= nchunk) return;
  const long long a = j * CHUNK;
  if (__ldg(rows + a) != __ldg(rows + a + CHUNK - 1)) return;
  for (int c = lane; c < C; c += 32) {
    float s = 0.0f;
    for (long long i = a; i < a + CHUNK; ++i)
      s = __fadd_rn(s, __ldg(upd + i * C + c));
    S[j * C + c] = s;
  }
}

__global__ void __launch_bounds__(1024)
rowmajor_run_totals(const int* __restrict__ rows,
                    const float* __restrict__ upd, float* __restrict__ S,
                    int C, long long M, long long nchunk) {
  run_totals_block(rows, M, nchunk, S, C, RowTerm{upd, C});
}

// One block of 256 threads per tile of T rows.  Shared memory: starts[T +
// 1] (padded to 4), keys[NS], upd[NS][C].
__global__ void __launch_bounds__(256)
rowmajor_tile_accumulate(const int* __restrict__ rows,
                         const float* __restrict__ upd,
                         const float* __restrict__ S, float* __restrict__ out,
                         int C, long long R, long long M, int T, int NS) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long span[2];
  __shared__ Pass pass;
  int* starts = (int*)smem;
  int* skey = starts + (T + 1 + 3) / 4 * 4;
  float* supd = (float*)(skey + NS);
  const long long row0 = (long long)blockIdx.x * T;
  const long long row_end = R - row0 < T ? R : row0 + T;

  tile_span(rows, M, row0, row0 + T, span);
  const long long tile_hi = span[1];
  long long s_lo = span[0];  // first sample of row row_a
  long long row_a = row0;
  while (row_a < row_end) {
    if (threadIdx.x < 32) {
      const Pass ps = plan_pass(rows, row_a, row_end, s_lo, tile_hi, NS);
      if (threadIdx.x == 0) pass = ps;
    }
    __syncthreads();
    const long long row_b = pass.row_b;
    const bool staged = pass.staged;
    const long long s_hi = pass.s_hi;
    const int n = (int)(s_hi - s_lo);
    const int nr = (int)(row_b - row_a);
    if (staged && n > 0) {
      stage_words(skey, rows + s_lo, n);
      stage_words(supd, upd + s_lo * C, (long long)n * C);
    }
    cp_async_wait_all();
    __syncthreads();
    // starts[j]: first local sample of row row_a + j
    fill_run_starts(starts, staged ? skey : rows + s_lo, n, row_a, nr + 1);
    __syncthreads();

    const float* u = staged ? supd : upd + s_lo * C;
    const long long total = (long long)nr * C;  // floats of this pass
    float* o = out + row_a * C;
    const bool aligned = ((row_a * C) & 3) == 0;
    // each thread: floats e4 .. e4 + 3 of the pass, e4 += 4 * blockDim.x;
    // (t, c): row and channel of e4, stepped without divisions
    const int step = 4 * blockDim.x;
    const int dt = step / C, dc = step - dt * C;
    int t = (4 * threadIdx.x) / C;
    int c = 4 * threadIdx.x - t * C;
    for (long long e4 = 4LL * threadIdx.x; e4 < total; e4 += step) {
      float v[4];
      int tt = t, cc = c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = 0.0f;
        if (n > 0 && e4 + k < total) {
          const int p = starts[tt], q = starts[tt + 1];
          if (q - p > 2 * CHUNK) {
            v[k] = __ldg(S + (s_lo + p + CHUNK - 1) / CHUNK * C + cc);
          } else {
            float acc = 0.0f;
            for (int s = p; s < q; ++s)
              acc = __fadd_rn(acc, u[(long long)s * C + cc]);
            v[k] = acc;
          }
        }
        if (++cc == C) {
          cc = 0;
          ++tt;
        }
      }
      if (aligned && e4 + 4 <= total) {
        __stcs((float4*)(o + e4), make_float4(v[0], v[1], v[2], v[3]));
      } else {
        for (int k = 0; k < 4 && e4 + k < total; ++k) __stcs(o + e4 + k, v[k]);
      }
      t += dt;
      c += dc;
      if (c >= C) {
        c -= C;
        ++t;
      }
    }
    s_lo = s_hi;
    row_a = row_b;
    __syncthreads();
  }
}

// Output floats of a tile: T, the rows of a tile, is a multiple of 4 near
// TILE_FLOATS / C (aligned float4 stores).
#define TILE_FLOATS 16384

// rows: int32 [M] non-decreasing in [0, R); upd: f32 [M, C]; out: f32
// [R, C].  block_sums: f32 scratch of (M / CHUNK) * C entries.
extern "C" int dense_accumulate(const void* rows, const void* upd,
                                void* block_sums, void* out, int C,
                                long long R, long long M, void* stream) {
  if (C < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int T = TILE_FLOATS / C / 4 * 4 < 4 ? 4 : TILE_FLOATS / C / 4 * 4;
  // a staged sample: its key and upd[C]
  const int ns = stage_samples(M, R, T, 1 + C);
  cudaStream_t st = (cudaStream_t)stream;
  const int* r = (const int*)rows;
  const float* u = (const float*)upd;
  float* S = (float*)block_sums;
  const long long nchunk = M / CHUNK;
  if (nchunk > 0) {
    rowmajor_block_sums<<<(unsigned)((nchunk * 32 + 255) / 256), 256, 0,
                          st>>>(r, u, S, C, nchunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rowmajor_run_totals<<<(unsigned)((nchunk + 1023) / 1024), 1024, 0, st>>>(
        r, u, S, C, M, nchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)((T + 1 + 3) / 4 * 4 + ns + (long long)ns * C) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rowmajor_tile_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rowmajor_tile_accumulate<<<(unsigned)((R + T - 1) / T), 256, smem, st>>>(
      r, u, S, (float*)out, C, R, M, T, ns);
  return (int)cudaGetLastError();
}
