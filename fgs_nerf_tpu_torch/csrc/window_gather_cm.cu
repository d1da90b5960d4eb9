// Trilinear serve of a row-sorted sample stream from the channel-major
// HALF cell pack (kernel B1 of the port).
//
// Replaces the TPU kernel fgs_nerf_tpu/ops/pallas/window_gather_cm.py:156
// (sorted_window_gather_cm_pallas).  Same function as its reference
// (window_gather_cm.py:204-215):
//
//   out[c, m] = sum_k2 pack[k2*C + c, rows[m]]     * w8[2*k2,     m]
//                    + pack[k2*C + c, rows[m] + 1] * w8[2*k2 + 1, m]
//
// The TPU kernel serves a sliding window with one-hot MXU products
// because the TPU has no vector gather.  A GPU gathers directly: one
// thread per sample reads its 2 x 4C pack values.  Rows are sorted, so
// neighbouring threads read the same or neighbouring columns of each
// pack row and the loads coalesce (or hit L1/L2).
//
// Bound on an H100: bytes.  The pack is read once (4C x Rp f32), w8,
// rows and the output once each: about 677 MB at the coarse bench shape
// (C = 16, M = 2,359,296, Rp = 1,723,392), i.e. >= 0.20 ms at 3.35 TB/s.
//
// The sum runs in the reference's order with explicit round-to-nearest
// multiplies and adds (no FMA contraction), so the result equals the
// plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void window_gather_cm_kernel(
    const float* __restrict__ pack, const int* __restrict__ rows,
    const float* __restrict__ w8, float* __restrict__ out,
    int C, long long rp, long long M) {
  long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const long long r = rows[m];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = w8[(long long)k * M + m];
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      const float* col = pack + (long long)(k2 * C + c) * rp + r;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(col), w[2 * k2]));
      acc = __fadd_rn(acc, __fmul_rn(__ldg(col + 1), w[2 * k2 + 1]));
    }
    out[(long long)c * M + m] = acc;
  }
}

extern "C" int window_gather_cm(const void* pack, const void* rows,
                                const void* w8, void* out, int C,
                                long long rp, long long M, void* stream) {
  if (M > 0) {
    const int threads = 256;
    const long long blocks = (M + threads - 1) / threads;
    window_gather_cm_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        (const float*)pack, (const int*)rows, (const float*)w8,
        (float*)out, C, rp, M);
  }
  return (int)cudaGetLastError();
}
