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
// because the TPU has no vector gather.  Here a block of 256 threads owns
// a tile of TILE = 256 consecutive sorted samples, one thread a sample,
// all C channels.  Rows are sorted, so the tile's columns lie in one
// window [rows[m0], rows[m_last] + 1]; the block reads its two ends and
// chooses a branch for the whole tile:
// - staged: the window, widened to whole 16-byte chunks, fits the stage
//   (STAGE_FLOATS floats over the 4C pack rows: 128 columns at C = 16,
//   32 KB), so the block copies it into shared memory with 16-byte
//   cp.async and every sample reads its 8C values there.  Dense tiles and
//   the sentinel piles (one row, in the pack's zero tail) take it.  The
//   port's packs have 16-byte aligned rows (Rp is a multiple of 512); a
//   pack without them takes the direct branch throughout;
// - direct, in the same kernel: a wider (sparse) tile gathers from device
//   memory, 4 channels' 32 loads in flight at once (C is a template
//   parameter for the model's instances, 10 and 16, so the loops unroll).
// Each thread loads its row and 8 weights before the branch is known, so
// those loads overlap the window's.  A warp's samples are consecutive, so
// w8, rows and every channel's output row move as whole 128-byte lines.
// (A 64 KB stage, 512-sample tiles, threads split over channel groups,
// and fewer registers per thread for more blocks an SM were all slower on
// an H100.)
//
// Bound on an H100: bytes.  rows, w8 and the output once, and the pack
// columns the rows touch once, in whole 32-byte sectors of each pack row
// (what device memory moves): at the fine bench's pass 1 (C = 16,
// M = 4,194,304) ~1.40 GB, >= 0.42 ms at 3.35 TB/s.  The fine stage's
// tiles are sparse (a few samples per touched column, scattered over
// z-columns of the grid), so they take the direct branch and read
// scattered sectors.
//
// The sum runs in the reference's order with explicit round-to-nearest
// multiplies and adds (no FMA contraction), so the result equals the
// plain PyTorch version bit for bit on either branch.
#include "sorted_runs.cuh"  // cp_async16, cp_async_wait_all

#define TILE 256           // samples of a tile, one a thread
#define STAGE_FLOATS 8192  // the stage: 32 KB over the 4C pack rows
#define GROUP 4            // channels whose pack loads are in flight together

// Columns of the stage for C channels: a multiple of 4 (16-byte rows).
static inline int stage_cols(int C) { return STAGE_FLOATS / (4 * C) / 4 * 4; }

// Copy columns [a0, a0 + n) (multiples of 4) of pack rows [0, k) into
// shared memory s (row stride ld floats, a multiple of 4) with 16-byte
// copies, all in flight at once.  Completes with cp_async_wait_all() and
// __syncthreads().
__device__ __forceinline__ void stage_window(float* s, int ld,
                                             const float* __restrict__ pack,
                                             long long rp, int k, long long a0,
                                             int n) {
  const int n4 = n >> 2;
  for (int i = threadIdx.x; i < k * n4; i += blockDim.x) {
    const int row = i / n4;
    const int j = (i - row * n4) * 4;
    cp_async16(s + row * ld + j, pack + row * rp + a0 + j);
  }
}

template <bool GLOBAL>
__device__ __forceinline__ float load_f(const float* p) {
  return GLOBAL ? __ldg(p) : *p;
}

// One sample: its 4C pack values at row stride ld from `base` (the
// sample's column of pack row 0) and the next column, times w, summed in
// the reference's order; channel c goes to o[c * M].
template <int CT, bool GLOBAL>
__device__ __forceinline__ void serve_sample(const float* base, long long ld,
                                             const float w[8], float* o,
                                             long long M, int C) {
  constexpr int G = CT > 0 && CT % GROUP ? 2 : GROUP;
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += G) {
    float v[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (c0 + g < C) {
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) {
          const float* p = base + (long long)(k2 * C + c0 + g) * ld;
          v[g][2 * k2] = load_f<GLOBAL>(p);
          v[g][2 * k2 + 1] = load_f<GLOBAL>(p + 1);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (c0 + g < C) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc = __fadd_rn(acc, __fmul_rn(v[g][k], w[k]));
        o[(long long)(c0 + g) * M] = acc;
      }
    }
  }
}

template <int CT>
__global__ void __launch_bounds__(TILE)
window_gather_tiles(const float* __restrict__ pack,
                    const int* __restrict__ rows,
                    const float* __restrict__ w8, float* __restrict__ out,
                    int c_rt, long long rp, long long M, int cols,
                    bool aligned) {
  extern __shared__ __align__(16) float stage[];  // [4C][cols]
  const int C = CT > 0 ? CT : c_rt;
  const long long m0 = (long long)blockIdx.x * TILE;
  const long long m1 = M - m0 < TILE ? M : m0 + TILE;
  const long long m = m0 + threadIdx.x;
  const bool live = m < m1;
  const long long r = live ? __ldg(rows + m) : 0;
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = live ? __ldg(w8 + (long long)k * M + m) : 0.0f;
  // the window [rows[m0], rows[m1 - 1] + 1] in whole 16-byte chunks
  const long long a0 = __ldg(rows + m0) & ~3LL;
  const long long n = ((__ldg(rows + m1 - 1) + 1) | 3LL) + 1 - a0;
  const bool staged = aligned && n <= cols;
  if (staged) stage_window(stage, cols, pack, rp, 4 * C, a0, (int)n);
  cp_async_wait_all();
  __syncthreads();
  if (!live) return;
  const long long j = r - a0;
  // rows out of order could leave the window: those read device memory
  if (staged && j >= 0 && j + 1 < n)
    serve_sample<CT, false>(stage + j, cols, w, out + m, M, C);
  else
    serve_sample<CT, true>(pack + r, rp, w, out + m, M, C);
}

template <int CT>
static cudaError_t launch(const float* pack, const int* rows, const float* w8,
                          float* out, int C, long long rp, long long M,
                          cudaStream_t st) {
  const int cols = stage_cols(C);
  const size_t smem = (size_t)4 * C * cols * sizeof(float);  // <= 32 KB
  const bool aligned = (rp & 3) == 0 && ((uintptr_t)pack & 15) == 0;
  window_gather_tiles<CT><<<(unsigned)((M + TILE - 1) / TILE), TILE, smem,
                            st>>>(pack, rows, w8, out, C, rp, M, cols,
                                  aligned);
  return cudaGetLastError();
}

extern "C" int window_gather_cm(const void* pack, const void* rows,
                                const void* w8, void* out, int C,
                                long long rp, long long M, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if (C < 1) return (int)cudaErrorInvalidValue;
  const float* p = (const float*)pack;
  const int* r = (const int*)rows;
  const float* w = (const float*)w8;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 16: return (int)launch<16>(p, r, w, o, C, rp, M, st);
    case 10: return (int)launch<10>(p, r, w, o, C, rp, M, st);
    default: return (int)launch<0>(p, r, w, o, C, rp, M, st);
  }
}

// Report only: dynamic shared memory per block for C channels.
extern "C" long long window_gather_cm_smem_bytes(int C) {
  return (long long)4 * C * stage_cols(C) * (long long)sizeof(float);
}
