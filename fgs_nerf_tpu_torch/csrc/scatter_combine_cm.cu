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
// Design: no float atomics.  The stream is sorted by row, so the
// samples of a row form one run.  A first kernel finds every run start
// with a binary search (start[r] = first s with rows[s] >= r, for
// r = 0..R).  The main kernel runs one thread per (output row, channel):
// it adds the dz = 0 run of its row, then the dz = 1 run of the row
// below, in sample order, with round-to-nearest multiplies and adds —
// the reference's order (scatter of the dz = 0 updates, then of the
// dz = 1 updates), so for runs of up to 2 x CHUNK samples the result
// equals the serial reference bit for bit.  Neighbouring threads own
// neighbouring rows: output stores coalesce and run reads are
// contiguous.
//
// Long runs: every masked lattice slot carries the sentinel key, clamped
// to row R - 2, so one run can hold most of a million samples; summed by
// one thread in series it took 33 ms on an H100 at the bench shape.  A
// second kernel therefore sums each CHUNK-sample block of the stream
// whose samples all share one row, and a long run adds its head and tail
// samples one by one and its whole blocks through those block sums, in
// stream order.  Still deterministic; for such runs the association
// differs from the serial reference (float32 reassociation).
//
// Bound on an H100: bytes.  rows, w8 and g are read once and the dense
// [4C, R] output written once: about 677 MB at the coarse bench shape
// (C = 16, M = 2,359,296, R = 1,722,368), i.e. >= 0.20 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void run_starts_kernel(const int* __restrict__ rows, long long M,
                                  int* __restrict__ start, long long R) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r > R) return;
  long long lo = 0, hi = M;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if ((long long)rows[mid] < r) lo = mid + 1; else hi = mid;
  }
  start[r] = (int)lo;
}

#define CHUNK 256

// Block sums of the dz = 0 / dz = 1 updates for every full CHUNK-sample
// block of the stream whose samples share one row.  S: [2][4C][nchunk];
// entries of other blocks are left unwritten and never read.
__global__ void chunk_sums_kernel(const int* __restrict__ rows,
                                  const float* __restrict__ w8,
                                  const float* __restrict__ g,
                                  float* __restrict__ S, int C, long long M,
                                  long long nchunk) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nchunk) return;
  const long long a = j * CHUNK;
  if (rows[a] != rows[a + CHUNK - 1]) return;
  const int ch = blockIdx.y;
  const int k2 = ch / C;
  const int c = ch - k2 * C;
  const float* we = w8 + (long long)(2 * k2) * M;
  const float* wo = w8 + (long long)(2 * k2 + 1) * M;
  const float* gc = g + (long long)c * M;
  float s0 = 0.0f, s1 = 0.0f;
  for (long long s = a; s < a + CHUNK; ++s) {
    const float gv = __ldg(gc + s);
    s0 = __fadd_rn(s0, __fmul_rn(__ldg(we + s), gv));
    s1 = __fadd_rn(s1, __fmul_rn(__ldg(wo + s), gv));
  }
  S[(long long)ch * nchunk + j] = s0;
  S[(long long)(4 * C + ch) * nchunk + j] = s1;
}

// acc + the updates w[s] * g[s] of the run [p, q), in stream order.
__device__ inline float run_add(float acc, const float* __restrict__ w,
                                const float* __restrict__ gc,
                                const float* __restrict__ Sch, int p, int q) {
  if (q - p <= 2 * CHUNK) {
    for (int s = p; s < q; ++s)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + s), __ldg(gc + s)));
    return acc;
  }
  const int a = (p + CHUNK - 1) / CHUNK * CHUNK;  // first whole block
  const int b = q / CHUNK * CHUNK;                // end of the last one
  for (int s = p; s < a; ++s)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + s), __ldg(gc + s)));
  for (int j = a / CHUNK; j < b / CHUNK; ++j)
    acc = __fadd_rn(acc, __ldg(Sch + j));
  for (int s = b; s < q; ++s)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + s), __ldg(gc + s)));
  return acc;
}

__global__ void dense_accumulate_cm_kernel(
    const int* __restrict__ start, const float* __restrict__ w8,
    const float* __restrict__ g, const float* __restrict__ S,
    float* __restrict__ out, int C, long long R, long long M,
    long long nchunk) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const int ch = blockIdx.y;  // k2 * C + c
  const int k2 = ch / C;
  const int c = ch - k2 * C;
  const float* we = w8 + (long long)(2 * k2) * M;
  const float* wo = w8 + (long long)(2 * k2 + 1) * M;
  const float* gc = g + (long long)c * M;
  const int s0 = start[row];
  float acc = run_add(0.0f, we, gc, S + (long long)ch * nchunk, s0,
                      start[row + 1]);
  if (row > 0)
    acc = run_add(acc, wo, gc, S + (long long)(4 * C + ch) * nchunk,
                  start[row - 1], s0);
  out[(long long)ch * R + row] = acc;
}

// start: int32 scratch of R + 1 entries; chunk_sums: f32 scratch of
// 2 * 4C * (M / CHUNK) entries (both allocated by the caller).
extern "C" int dense_accumulate_cm(const void* rows, const void* w8,
                                   const void* g, void* start,
                                   void* chunk_sums, void* out, int C,
                                   long long R, long long M, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const long long nchunk = M / CHUNK;
  run_starts_kernel<<<(unsigned)((R + 1 + threads - 1) / threads), threads,
                      0, st>>>((const int*)rows, M, (int*)start, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nchunk > 0) {
    dim3 cgrid((unsigned)((nchunk + threads - 1) / threads),
               (unsigned)(4 * C));
    chunk_sums_kernel<<<cgrid, threads, 0, st>>>(
        (const int*)rows, (const float*)w8, (const float*)g,
        (float*)chunk_sums, C, M, nchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((R + threads - 1) / threads), (unsigned)(4 * C));
  dense_accumulate_cm_kernel<<<grid, threads, 0, st>>>(
      (const int*)start, (const float*)w8, (const float*)g,
      (const float*)chunk_sums, (float*)out, C, R, M, nchunk);
  return (int)cudaGetLastError();
}
