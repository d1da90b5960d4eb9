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
// because the TPU has no vector gather.  Here one thread per (tap,
// sample) reads its 8 pack values directly.  Threads run sample-minor,
// so a warp reads neighbouring samples of one tap: rows, delta, w8t and
// the output coalesce, and sorted rows keep the pack reads close.  The
// sum runs in the plain twin's order with round-to-nearest multiplies and
// adds (no FMA contraction): per d, ((p0 w0 + p1 w1) + p2 w2) + p3 w3, then
// (0 + s_0) + s_1 — bit-equal to the twin.
//
// Bound of B5 on an H100: bytes.  rows, delta, w8t and the output once,
// and the pack columns the taps touch once: at the fine bench shape
// (T = 16, M = 1,048,576) that is ~0.7 GB without the pack, >= 0.2 ms at
// 3.35 TB/s.
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
// torch.sort.  Then, as in B2: a binary search finds every run start
// (start[r] = first sorted position with key >= r), and one thread per
// output row adds the d = 0 deposits of its key (key == r) and the d = 1
// deposits of the key below (key == r - 1), reading w8t and g through the
// permutation — no [8, T * M] product is formed.  Both runs are sorted by
// e, so the thread merges them by tap and adds in (t, d, m) order: the
// JAX reference's serial scatter order, which the plain twin keeps too.
// Long runs: every sentinel sample shares one base row, so masked
// traffic piles most of the stream onto a few keys.  A second kernel
// sums each CHUNK-deposit block of the sorted stream whose keys are all
// equal, and a run longer than 2 x CHUNK adds its head and tail one by
// one and its whole blocks through those sums (d = 0 run, then d = 1).
// Still deterministic; for such runs the association differs from the
// serial reference (float32 reassociation).
//
// Bound of B6 on an H100: bytes.  rows, delta, w8t and g read once and the
// dense [4, cap] output written once: ~1.05 GB at the fine bench shape
// (T = 16, M = 1,048,576, cap ~ 25.56M), >= 0.31 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tap_window_serve_cm_kernel(
    const float* __restrict__ pack, const int* __restrict__ rows,
    const int* __restrict__ delta, const float* __restrict__ w8t,
    float* __restrict__ out, long long rp, int T, long long M) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)T * M) return;
  const long long t = idx / M;
  const long long m = idx - t * M;
  const long long r = (long long)rows[m] + delta[idx];
  const float* w = w8t + 8 * t * M + m;
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float* col = pack + r + d;
    float s = __fmul_rn(__ldg(col), __ldg(w + (4 * d) * M));
    s = __fadd_rn(s, __fmul_rn(__ldg(col + rp), __ldg(w + (4 * d + 1) * M)));
    s = __fadd_rn(s, __fmul_rn(__ldg(col + 2 * rp),
                               __ldg(w + (4 * d + 2) * M)));
    s = __fadd_rn(s, __fmul_rn(__ldg(col + 3 * rp),
                               __ldg(w + (4 * d + 3) * M)));
    acc = __fadd_rn(acc, s);
  }
  out[idx] = acc;
}

#define CHUNK 256

__global__ void tap_run_starts_kernel(const int* __restrict__ keys,
                                      long long n, int* __restrict__ start,
                                      long long R) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r > R) return;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)keys[mid] < r) lo = mid + 1; else hi = mid;
  }
  start[r] = (int)lo;
}

// Adds deposit e (= t * M + m) of corner row d to acc[0..3].
__device__ inline void add_deposit(float acc[4], const float* __restrict__ w8t,
                                   const float* __restrict__ g, long long M,
                                   int e, int d) {
  const long long t = e / M;
  const long long m = e - t * M;
  const float gv = __ldg(g + e);
  const float* w = w8t + (8 * t + 4 * d) * M + m;
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2)
    acc[k2] = __fadd_rn(acc[k2], __fmul_rn(__ldg(w + k2 * M), gv));
}

// Block sums of the d = 0 and d = 1 deposits of every full CHUNK block
// of the sorted stream whose keys are all equal.  S: [8][nchunk], row
// d * 4 + k2; entries of other blocks are left unwritten and never read.
__global__ void tap_chunk_sums_kernel(const int* __restrict__ keys,
                                      const int* __restrict__ perm,
                                      const float* __restrict__ w8t,
                                      const float* __restrict__ g,
                                      float* __restrict__ S, long long M,
                                      long long nchunk) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nchunk) return;
  const long long a = j * CHUNK;
  if (keys[a] != keys[a + CHUNK - 1]) return;
  float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long i = a; i < a + CHUNK; ++i) {
    const int e = __ldg(perm + i);
    add_deposit(s0, w8t, g, M, e, 0);
    add_deposit(s1, w8t, g, M, e, 1);
  }
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) {
    S[(long long)k2 * nchunk + j] = s0[k2];
    S[(long long)(4 + k2) * nchunk + j] = s1[k2];
  }
}

// acc + the deposits of corner row d of the sorted run [p, q), in stream
// order, whole blocks of a run longer than 2 x CHUNK through S.
__device__ inline void run_add(float acc[4], const int* __restrict__ perm,
                               const float* __restrict__ w8t,
                               const float* __restrict__ g,
                               const float* __restrict__ S, long long M,
                               long long nchunk, int d, int p, int q) {
  if (q - p <= 2 * CHUNK) {
    for (int i = p; i < q; ++i) add_deposit(acc, w8t, g, M, __ldg(perm + i), d);
    return;
  }
  const int a = (p + CHUNK - 1) / CHUNK * CHUNK;  // first whole block
  const int b = q / CHUNK * CHUNK;                // end of the last one
  for (int i = p; i < a; ++i) add_deposit(acc, w8t, g, M, __ldg(perm + i), d);
  for (int j = a / CHUNK; j < b / CHUNK; ++j) {
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2)
      acc[k2] = __fadd_rn(acc[k2], __ldg(S + (long long)(4 * d + k2) * nchunk + j));
  }
  for (int i = b; i < q; ++i) add_deposit(acc, w8t, g, M, __ldg(perm + i), d);
}

__global__ void tap_dense_accumulate_cm_kernel(
    const int* __restrict__ start, const int* __restrict__ perm,
    const float* __restrict__ w8t, const float* __restrict__ g,
    const float* __restrict__ S, float* __restrict__ out, long long M,
    long long R, long long nchunk) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const int p0 = start[row], q0 = start[row + 1];  // d = 0: key == row
  const int p1 = row > 0 ? start[row - 1] : p0;    // d = 1: key == row - 1
  const int q1 = p0;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (q0 - p0 > 2 * CHUNK || q1 - p1 > 2 * CHUNK) {
    run_add(acc, perm, w8t, g, S, M, nchunk, 0, p0, q0);
    run_add(acc, perm, w8t, g, S, M, nchunk, 1, p1, q1);
  } else {
    // merge the two runs by tap: (t, d, m) order
    int i = p0, j = p1;
    while (i < q0 || j < q1) {
      bool take0;
      if (j >= q1) take0 = true;
      else if (i >= q0) take0 = false;
      else take0 = (long long)__ldg(perm + i) / M <= (long long)__ldg(perm + j) / M;
      if (take0) add_deposit(acc, w8t, g, M, __ldg(perm + i++), 0);
      else add_deposit(acc, w8t, g, M, __ldg(perm + j++), 1);
    }
  }
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) out[(long long)k2 * R + row] = acc[k2];
}

extern "C" int tap_window_serve_cm(const void* pack, const void* rows,
                                   const void* delta, const void* w8t,
                                   void* out, long long rp, int T,
                                   long long M, void* stream) {
  const long long n = (long long)T * M;
  if (n > 0) {
    const int threads = 256;
    tap_window_serve_cm_kernel<<<(unsigned)((n + threads - 1) / threads),
                                 threads, 0, (cudaStream_t)stream>>>(
        (const float*)pack, (const int*)rows, (const int*)delta,
        (const float*)w8t, (float*)out, rp, T, M);
  }
  return (int)cudaGetLastError();
}

// keys_sorted / perm: the T * M deposit keys rows + delta_t sorted stably
// and their flat indices t * M + m; start: int32 scratch of R + 1 entries;
// chunk_sums: f32 scratch of 8 * (T * M / CHUNK) entries (both allocated
// by the caller).
extern "C" int tap_dense_accumulate_cm(const void* keys_sorted,
                                       const void* perm, const void* w8t,
                                       const void* g, void* start,
                                       void* chunk_sums, void* out, int T,
                                       long long M, long long R,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const long long n = (long long)T * M;
  const long long nchunk = n / CHUNK;
  tap_run_starts_kernel<<<(unsigned)((R + 1 + threads - 1) / threads),
                          threads, 0, st>>>((const int*)keys_sorted, n,
                                            (int*)start, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nchunk > 0) {
    tap_chunk_sums_kernel<<<(unsigned)((nchunk + threads - 1) / threads),
                            threads, 0, st>>>(
        (const int*)keys_sorted, (const int*)perm, (const float*)w8t,
        (const float*)g, (float*)chunk_sums, M, nchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  tap_dense_accumulate_cm_kernel<<<(unsigned)((R + threads - 1) / threads),
                                   threads, 0, st>>>(
      (const int*)start, (const int*)perm, (const float*)w8t,
      (const float*)g, (const float*)chunk_sums, (float*)out, M, R, nchunk);
  return (int)cudaGetLastError();
}
