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
// Design: no float atomics.  The stream is sorted, so the samples of a
// row form one run.  A first kernel finds every run start by binary
// search, one thread per output row (start[r] = first s with
// rows[s] >= r, r = 0..cap).  The main kernel gives each output row a
// team of L lanes (L = the next power of two >= C, at most a warp; a C
// wider than a warp loops over channel groups), and each lane sums its
// channel over the row's run in sample order with round-to-nearest adds:
// the order of the serial reference, so runs of up to 2 x CHUNK samples
// equal it bit for bit.  Lanes of a team read neighbouring channels of
// one sample (coalesced), and neighbouring teams own neighbouring rows,
// whose runs are neighbours in memory; the output row is written once,
// coalesced.  For C = 8 (the 1-channel taps) four rows share a warp; for
// C = 104 / 128 (the fine / coarse field) a warp owns a row.
//
// Long runs: masked lattice slots are clipped onto boundary base cells
// (ops/scatter.py:103-109), so a few rows receive runs of most of a
// million zero-weight updates, which one lane would sum serially.  A
// second kernel therefore sums each CHUNK-sample block of the stream
// whose samples all share one row; a run longer than 2 x CHUNK adds its
// head samples one by one, its whole blocks through those block sums in
// block order, then its tail samples.  Deterministic (bit-equal on a
// repeat); for such runs the association differs from the serial
// reference (float32 reassociation).
//
// Bound on an H100: bytes.  rows and upd are read once and the dense
// [cap, C] f32 output written once: at the fine field shape (M =
// 4,194,304, C = 104, cap = 258^3) about 8.9 GB, >= 2.7 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 256

__global__ void rowmajor_run_starts(const int* __restrict__ rows, long long M,
                                    int* __restrict__ start, long long R) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r > R) return;
  long long lo = 0, hi = M;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if ((long long)__ldg(rows + mid) < r) lo = mid + 1; else hi = mid;
  }
  start[r] = (int)lo;
}

// Block sums of every full CHUNK-sample block of the stream whose samples
// share one row.  S: [nchunk, C]; rows of other blocks are left
// unwritten and never read.  One team of L lanes per block.
template <int L>
__global__ void rowmajor_chunk_sums(const int* __restrict__ rows,
                                    const float* __restrict__ upd,
                                    float* __restrict__ S, int C,
                                    long long nchunk) {
  const int lane = threadIdx.x % L;
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  if (j >= nchunk) return;
  const long long a = j * CHUNK;
  if (__ldg(rows + a) != __ldg(rows + a + CHUNK - 1)) return;
  for (int c = lane; c < C; c += L) {
    float s = 0.0f;
    for (long long i = a; i < a + CHUNK; ++i)
      s = __fadd_rn(s, __ldg(upd + i * C + c));
    S[j * C + c] = s;
  }
}

template <int L>
__global__ void rowmajor_accumulate(const int* __restrict__ start,
                                    const float* __restrict__ upd,
                                    const float* __restrict__ S,
                                    float* __restrict__ out, int C,
                                    long long R) {
  const int lane = threadIdx.x % L;
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  if (row >= R) return;
  const long long p = __ldg(start + row);
  const long long q = __ldg(start + row + 1);
  float* o = out + row * C;
  if (q - p <= 2 * CHUNK) {
    for (int c = lane; c < C; c += L) {
      float acc = 0.0f;
      for (long long s = p; s < q; ++s)
        acc = __fadd_rn(acc, __ldg(upd + s * C + c));
      o[c] = acc;
    }
    return;
  }
  const long long a = (p + CHUNK - 1) / CHUNK * CHUNK;  // first whole block
  const long long b = q / CHUNK * CHUNK;                // end of the last one
  for (int c = lane; c < C; c += L) {
    float acc = 0.0f;
    for (long long s = p; s < a; ++s)
      acc = __fadd_rn(acc, __ldg(upd + s * C + c));
    for (long long j = a / CHUNK; j < b / CHUNK; ++j)
      acc = __fadd_rn(acc, __ldg(S + j * C + c));
    for (long long s = b; s < q; ++s)
      acc = __fadd_rn(acc, __ldg(upd + s * C + c));
    o[c] = acc;
  }
}

template <int L>
static int launch(const int* rows, const float* upd, int* start, float* S,
                  float* out, int C, long long R, long long M,
                  cudaStream_t st) {
  const int threads = 256;
  const long long nchunk = M / CHUNK;
  if (nchunk > 0) {
    rowmajor_chunk_sums<L><<<(unsigned)((nchunk * L + threads - 1) / threads),
                             threads, 0, st>>>(rows, upd, S, C, nchunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rowmajor_accumulate<L><<<(unsigned)((R * L + threads - 1) / threads),
                           threads, 0, st>>>(start, upd, S, out, C, R);
  return (int)cudaGetLastError();
}

// rows: int32 [M] non-decreasing in [0, R); upd: f32 [M, C]; out: f32
// [R, C].  start: int32 scratch of R + 1 entries; chunk_sums: f32
// scratch of (M / CHUNK) * C entries (both allocated by the caller).
extern "C" int dense_accumulate(const void* rows, const void* upd,
                                void* start, void* chunk_sums, void* out,
                                int C, long long R, long long M,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  rowmajor_run_starts<<<(unsigned)((R + 1 + threads - 1) / threads), threads,
                        0, st>>>((const int*)rows, M, (int*)start, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int* r = (const int*)rows;
  const float* u = (const float*)upd;
  int* s = (int*)start;
  float* cs = (float*)chunk_sums;
  float* o = (float*)out;
  if (C <= 1) return launch<1>(r, u, s, cs, o, C, R, M, st);
  if (C <= 2) return launch<2>(r, u, s, cs, o, C, R, M, st);
  if (C <= 4) return launch<4>(r, u, s, cs, o, C, R, M, st);
  if (C <= 8) return launch<8>(r, u, s, cs, o, C, R, M, st);
  if (C <= 16) return launch<16>(r, u, s, cs, o, C, R, M, st);
  return launch<32>(r, u, s, cs, o, C, R, M, st);
}
