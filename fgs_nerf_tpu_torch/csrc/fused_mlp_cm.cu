// Fused channel-major MLP, forward (kernel B8) and backward (kernel B9).
//
// Replaces the TPU kernels fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:231
// (fused_mlp_cm_fwd_pallas) and :258 (fused_mlp_cm_bwd_pallas).  Same
// function as their reference (fused_mlp_cm.py:308-327) and the TPU
// backward kernel (:109-172):
//
//   x     = bf16(concat of the feature row blocks at 8-aligned offsets)
//   h_l+1 = bf16(relu(W_l^T h_l + b_l)),   out = W_L^T h_L + b_L  [d_out, M]
//
// with bf16 operands and fp32 sums.  The backward recomputes the hiddens
// per tile, rounds each layer's cotangent dz to bf16 before its dW and its
// dx product, and sums the bias gradients from the fp32 dz.
//
// Design.  A block owns a tile of 64 samples and keeps the tile's input
// and hidden activations in shared memory as bf16 [sample][feature] rows.
// Every product runs on the tensor cores through mma.sync m16n8k16 (bf16
// in, fp32 accumulate): the layer products and the input cotangents with
// the 64 samples as the M dimension and each warp owning a set of 8-wide
// output column tiles; the weight gradients with the output features as
// M and the tile's 64 samples as K.  Weights do not fit in shared memory
// at width 256 (one 256 x 256 layer is 128 KB), so the B fragments of the
// layer products are read straight from device memory, where the whole
// net (< 1 MB of bf16, in both [out][in] and [in][out] order) stays in
// L2.  All dims are padded to multiples of 16 by the caller with zero
// weights and biases (zero rows stay zero through relu).
//
// dW/db are sums over all samples.  The backward is persistent (one block
// per SM walks the tiles in a fixed order) and each block adds its tiles'
// contributions into its own slice of a partial buffer in device memory,
// each element owned by one lane: no atomics.  A second kernel sums the
// slices in block order, so the result is deterministic for a given grid.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): operations.  At the
// fine shading head's shapes (M = 1,048,576) the rgbnet forward is
// 2 x (106 x 256 + 3 x 256 x 256) ~ 0.45 MFLOP per sample, 469 GFLOP,
// >= 0.47 ms;
// the backward about three times that.  This first kernel reads its B
// fragments from L2 and read-modify-writes the dW partials once per
// 64-sample tile, so it stays well above the bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // mma16816, pack2

typedef __nv_bfloat16 bf16;

#define TS 64          // samples per tile
#define NTHREADS 256   // 8 warps
#define MAXB 16        // feature blocks
#define MAXL 8         // layers
#define SMEM_MAX 232448

struct MlpArgs {
  const float* blk[MAXB];
  int blk_rows[MAXB];
  int blk_off[MAXB];
  int n_blocks;
  const bf16* wt[MAXL];   // [np][kp]: out-major, the forward's B operand
  const bf16* w[MAXL];    // [kp][np]: in-major, the backward's dh operand
  const float* b[MAXL];   // [np]
  int kp[MAXL];
  int np[MAXL];
  int n_layers;
  int cin8;               // rows of the padded input (<= kp[0])
  int d_out;              // real outputs of the last layer (<= np[L-1])
  long long M;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// A fragment (16 x 16) of a row-major shared [m][k] array at (m0, k0).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* A,
                                       int sa, int m0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p0 = A + (m0 + g) * sa + k0 + t * 2;
  const bf16* p1 = p0 + 8 * sa;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// A fragment of the transpose of a row-major shared [k][m] array.
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* S,
                                         int ss, int m0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r = k0 + t * 2, c = m0 + g;
  a[0] = pack2(S[r * ss + c], S[(r + 1) * ss + c]);
  a[1] = pack2(S[r * ss + c + 8], S[(r + 1) * ss + c + 8]);
  a[2] = pack2(S[(r + 8) * ss + c], S[(r + 9) * ss + c]);
  a[3] = pack2(S[(r + 8) * ss + c + 8], S[(r + 9) * ss + c + 8]);
}

// C[64][N] = A[64][K] (shared, row-major) x B[K][N]; B's fragment for
// column tile n0 at k-step k0 comes from bload(n0, k0, b0, b1), a row of
// a k-contiguous array in device memory.  Each warp owns column tiles
// warp + 8j of each pass of 32 tiles; epi(n0, acc) gets the warp's
// [m-tile][4] accumulators of one column tile (rows mt*16 + g (+8),
// columns n0 + 2t (+1)).
template <class BL, class EP>
__device__ __forceinline__ void gemm_rows(const bf16* A, int sa, int K, int N,
                                          BL bload, EP epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = N >> 3;
  for (int base = 0; base < ntiles; base += 32) {
    float acc[4][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) load_a(a[mt], A, sa, mt * 16, k0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = base + warp + 8 * j;
        if (nt < ntiles) {
          uint32_t b0, b1;
          bload(nt * 8, k0, b0, b1);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma16816(acc[j][mt], a[mt], b0, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = base + warp + 8 * j;
      if (nt < ntiles) epi(nt * 8, acc[j]);
    }
  }
}

// x tile: X[s][c] = bf16(block value), zero in pad rows and past M.
// Ends with a barrier.
__device__ void build_x(const MlpArgs& a, long long s0, bf16* X, int sx) {
  for (int e = threadIdx.x; e < TS * sx / 2; e += NTHREADS)
    reinterpret_cast<uint32_t*>(X)[e] = 0u;
  __syncthreads();
  for (int bi = 0; bi < a.n_blocks; ++bi) {
    const float* src = a.blk[bi];
    const int rows = a.blk_rows[bi], off = a.blk_off[bi];
    for (int e = threadIdx.x; e < rows * TS; e += NTHREADS) {
      const int r = e / TS, s = e - r * TS;
      const long long gs = s0 + s;
      const float v = gs < a.M ? __ldg(src + (long long)r * a.M + gs) : 0.0f;
      X[s * sx + off + r] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();
}

// Layers 0 .. n_hidden-1 of the tile: Hs[l] = bf16(relu(W^T Hin + b)).
__device__ void forward_hidden(const MlpArgs& a, const bf16* X, int sx,
                               bf16* const* Hs, const int* sh, int n_hidden) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* hin = X;
  int sin = sx;
  for (int l = 0; l < n_hidden; ++l) {
    const bf16* wt = a.wt[l];
    const float* bias = a.b[l];
    const int kp = a.kp[l];
    bf16* hout = Hs[l];
    const int so = sh[l];
    gemm_rows(
        hin, sin, kp, a.np[l],
        [&](int n0, int k0, uint32_t& b0, uint32_t& b1) {
          const bf16* p = wt + (long long)(n0 + g) * kp + k0 + t * 2;
          b0 = ldg32(p);
          b1 = ldg32(p + 8);
        },
        [&](int n0, float (&acc)[4][4]) {
          const int n = n0 + t * 2;
          const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const int s = mt * 16 + g;
            *reinterpret_cast<uint32_t*>(hout + s * so + n) = pack2(
                __float2bfloat16_rn(fmaxf(acc[mt][0] + b0, 0.0f)),
                __float2bfloat16_rn(fmaxf(acc[mt][1] + b1, 0.0f)));
            *reinterpret_cast<uint32_t*>(hout + (s + 8) * so + n) = pack2(
                __float2bfloat16_rn(fmaxf(acc[mt][2] + b0, 0.0f)),
                __float2bfloat16_rn(fmaxf(acc[mt][3] + b1, 0.0f)));
          }
        });
    __syncthreads();
    hin = hout;
    sin = so;
  }
}

// ---------------------------------------------------------------------------
// B8: forward, one 64-sample tile per block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
fused_mlp_fwd_kernel(MlpArgs a, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char mlp_smem[];
  const int L = a.n_layers;
  int hmax = 0;
  for (int l = 0; l < L - 1; ++l) hmax = max(hmax, a.np[l]);
  const int sx = a.kp[0] + 8, shh = hmax + 8;
  bf16* X = reinterpret_cast<bf16*>(mlp_smem);
  bf16* H0 = X + TS * sx;
  bf16* H1 = H0 + TS * shh;
  const long long s0 = (long long)blockIdx.x * TS;
  build_x(a, s0, X, sx);

  // hidden layers ping-pong between H0 and H1
  bf16* Hs[MAXL];
  int sh[MAXL];
  for (int l = 0; l < L - 1; ++l) {
    Hs[l] = (l & 1) ? H1 : H0;
    sh[l] = shh;
  }
  forward_hidden(a, X, sx, Hs, sh, L - 1);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* hin = L > 1 ? Hs[L - 2] : X;
  const int sin = L > 1 ? shh : sx;
  const bf16* wt = a.wt[L - 1];
  const float* bias = a.b[L - 1];
  const int kp = a.kp[L - 1];
  gemm_rows(
      hin, sin, kp, a.np[L - 1],
      [&](int n0, int k0, uint32_t& b0, uint32_t& b1) {
        const bf16* p = wt + (long long)(n0 + g) * kp + k0 + t * 2;
        b0 = ldg32(p);
        b1 = ldg32(p + 8);
      },
      [&](int n0, float (&acc)[4][4]) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + t * 2 + c;
          if (n >= a.d_out) continue;
          const float bn = __ldg(bias + n);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const long long gs = s0 + mt * 16 + g;
            if (gs < a.M) out[(long long)n * a.M + gs] = acc[mt][c] + bn;
            if (gs + 8 < a.M) out[(long long)n * a.M + gs + 8] = acc[mt][2 + c] + bn;
          }
        }
      });
}

// ---------------------------------------------------------------------------
// B9: backward, persistent blocks
// ---------------------------------------------------------------------------

// P[o][i] += sum_s Dz[s][o] Hin[s][i] over the tile (P: this block's
// [np][kp] slice in device memory, each element owned by one lane).
__device__ void dw_accum(const bf16* Dz, int sd, const bf16* Hin, int shin,
                         int np, int kp, float* P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = np >> 4, ntiles = kp >> 3;
  for (int mt = warp; mt < mtiles; mt += 8) {
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) load_a_t(a[ks], Dz, sd, mt * 16, ks * 16, lane);
    for (int nt = 0; nt < ntiles; ++nt) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int c = nt * 8 + g;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int r = ks * 16 + t * 2;
        const uint32_t b0 = pack2(Hin[r * shin + c], Hin[(r + 1) * shin + c]);
        const uint32_t b1 = pack2(Hin[(r + 8) * shin + c], Hin[(r + 9) * shin + c]);
        mma16816(acc, a[ks], b0, b1);
      }
      float2* p0 = reinterpret_cast<float2*>(P + (long long)(mt * 16 + g) * kp +
                                             nt * 8 + t * 2);
      float2* p1 = reinterpret_cast<float2*>(reinterpret_cast<float*>(p0) + 8LL * kp);
      float2 v0 = *p0, v1 = *p1;
      v0.x += acc[0];
      v0.y += acc[1];
      v1.x += acc[2];
      v1.y += acc[3];
      *p0 = v0;
      *p1 = v1;
    }
  }
}

struct MlpGrad {
  const float* g;   // [d_out][M]
  float* dx;        // [cin8][M]
  float* part;      // [gridDim.x][n_part], zero on entry
  long long n_part;
};

__global__ void __launch_bounds__(NTHREADS)
fused_mlp_bwd_kernel(MlpArgs a, MlpGrad r) {
  extern __shared__ __align__(16) unsigned char mlp_smem[];
  const int L = a.n_layers;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int npmax = 0;
  for (int l = 0; l < L; ++l) npmax = max(npmax, a.np[l]);
  const int sx = a.kp[0] + 8, sd = npmax + 8;
  bf16* X = reinterpret_cast<bf16*>(mlp_smem);
  bf16* cur = X + TS * sx;
  bf16* Hs[MAXL];   // Hs[l] = input of layer l + 1
  int sh[MAXL];
  for (int l = 0; l < L - 1; ++l) {
    Hs[l] = cur;
    sh[l] = a.np[l] + 8;
    cur += TS * sh[l];
  }
  bf16* DzA = cur;
  bf16* DzB = DzA + TS * sd;

  // this block's partial slices: per layer [np][kp] dW then [np] db
  float* Pw[MAXL];
  float* Pb[MAXL];
  {
    float* p = r.part + (long long)blockIdx.x * r.n_part;
    for (int l = 0; l < L; ++l) {
      Pw[l] = p;
      p += (long long)a.np[l] * a.kp[l];
      Pb[l] = p;
      p += a.np[l];
    }
  }

  const long long ntiles = (a.M + TS - 1) / TS;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long s0 = tile * TS;
    build_x(a, s0, X, sx);
    forward_hidden(a, X, sx, Hs, sh, L - 1);

    // last layer: dz = g (fp32 for db, bf16 for the products)
    {
      const int np = a.np[L - 1];
      for (int o = threadIdx.x; o < np; o += NTHREADS) {
        float sum = 0.0f;
        for (int s = 0; s < TS; ++s) {
          const long long gs = s0 + s;
          const float gv = (o < a.d_out && gs < a.M)
                               ? __ldg(r.g + (long long)o * a.M + gs) : 0.0f;
          sum += gv;
          DzA[s * sd + o] = __float2bfloat16_rn(gv);
        }
        Pb[L - 1][o] += sum;
      }
    }
    __syncthreads();

    bf16* dz = DzA;
    bf16* dzn = DzB;
    for (int l = L - 1; l >= 0; --l) {
      const bf16* hin = l > 0 ? Hs[l - 1] : X;
      const int shin = l > 0 ? sh[l - 1] : sx;
      dw_accum(dz, sd, hin, shin, a.np[l], a.kp[l], Pw[l]);

      // dh[s][i] = sum_o dz[s][o] W[i][o]
      const bf16* w = a.w[l];
      const int np = a.np[l];
      if (l > 0) {
        float* pb = Pb[l - 1];
        gemm_rows(
            dz, sd, np, a.kp[l],
            [&](int n0, int k0, uint32_t& b0, uint32_t& b1) {
              const bf16* p = w + (long long)(n0 + g) * np + k0 + t * 2;
              b0 = ldg32(p);
              b1 = ldg32(p + 8);
            },
            [&](int n0, float (&acc)[4][4]) {
              const int n = n0 + t * 2;
              float part0 = 0.0f, part1 = 0.0f;
#pragma unroll
              for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int s = mt * 16 + g + 8 * h;
                  // h_l = bf16(relu(z)) > 0 exactly when z > 0 (but for
                  // z below bf16's smallest subnormal, 2^-133)
                  const float z0 = __bfloat162float(hin[s * shin + n]) > 0.0f
                                       ? acc[mt][2 * h] : 0.0f;
                  const float z1 = __bfloat162float(hin[s * shin + n + 1]) > 0.0f
                                       ? acc[mt][2 * h + 1] : 0.0f;
                  *reinterpret_cast<uint32_t*>(dzn + s * sd + n) =
                      pack2(__float2bfloat16_rn(z0), __float2bfloat16_rn(z1));
                  part0 += z0;
                  part1 += z1;
                }
              }
              // sum over the 8 lanes of this column pair, fixed order
#pragma unroll
              for (int m = 4; m < 32; m <<= 1) {
                part0 += __shfl_xor_sync(0xffffffffu, part0, m);
                part1 += __shfl_xor_sync(0xffffffffu, part1, m);
              }
              if (g == 0) {
                pb[n] += part0;
                pb[n + 1] += part1;
              }
            });
      } else {
        gemm_rows(
            dz, sd, np, a.kp[0],
            [&](int n0, int k0, uint32_t& b0, uint32_t& b1) {
              const bf16* p = w + (long long)(n0 + g) * np + k0 + t * 2;
              b0 = ldg32(p);
              b1 = ldg32(p + 8);
            },
            [&](int n0, float (&acc)[4][4]) {
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int i = n0 + t * 2 + c;
                if (i >= a.cin8) continue;
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                  const long long gs = s0 + mt * 16 + g;
                  if (gs < a.M) r.dx[(long long)i * a.M + gs] = acc[mt][c];
                  if (gs + 8 < a.M) r.dx[(long long)i * a.M + gs + 8] = acc[mt][2 + c];
                }
              }
            });
      }
      __syncthreads();
      bf16* tmp = dz;
      dz = dzn;
      dzn = tmp;
    }
  }
}

// out[e] = sum_b part[b][e], in block order.
__global__ void mlp_reduce_partials_kernel(const float* __restrict__ part,
                                           int nblk, long long n,
                                           float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < nblk; ++b) acc += part[(long long)b * n + e];
  out[e] = acc;
}

// ---------------------------------------------------------------------------
// C launchers
// ---------------------------------------------------------------------------

static int make_args(MlpArgs* a, const void* const* blk, const int* rows,
                     const int* offs, int n_blocks, const void* const* wt,
                     const void* const* w, const void* const* bias,
                     const int* kp, const int* np, int n_layers, int cin8,
                     int d_out, long long M) {
  if (n_blocks < 1 || n_blocks > MAXB || n_layers < 1 || n_layers > MAXL ||
      M < 0 || cin8 > kp[0] || d_out < 1 || d_out > np[n_layers - 1])
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_blocks; ++i) {
    a->blk[i] = (const float*)blk[i];
    a->blk_rows[i] = rows[i];
    a->blk_off[i] = offs[i];
    if (offs[i] % 8 || offs[i] + rows[i] > cin8) return (int)cudaErrorInvalidValue;
  }
  a->n_blocks = n_blocks;
  for (int l = 0; l < n_layers; ++l) {
    a->wt[l] = (const bf16*)wt[l];
    a->w[l] = w ? (const bf16*)w[l] : nullptr;
    a->b[l] = (const float*)bias[l];
    a->kp[l] = kp[l];
    a->np[l] = np[l];
    if (kp[l] % 16 || np[l] % 16 || kp[l] < 16 || np[l] < 16 ||
        (l > 0 && kp[l] != np[l - 1]))
      return (int)cudaErrorInvalidValue;
  }
  a->n_layers = n_layers;
  a->cin8 = cin8;
  a->d_out = d_out;
  a->M = M;
  return 0;
}

static size_t fwd_smem_bytes(const int* kp, const int* np, int n_layers) {
  int hmax = 0;
  for (int l = 0; l < n_layers - 1; ++l) hmax = hmax > np[l] ? hmax : np[l];
  return sizeof(bf16) * (size_t)TS * ((size_t)(kp[0] + 8) + 2 * (size_t)(hmax + 8));
}

static size_t bwd_smem_bytes(const int* kp, const int* np, int n_layers) {
  int npmax = 0;
  size_t hid = 0;
  for (int l = 0; l < n_layers; ++l) npmax = npmax > np[l] ? npmax : np[l];
  for (int l = 0; l < n_layers - 1; ++l) hid += (size_t)(np[l] + 8);
  return sizeof(bf16) * (size_t)TS *
         ((size_t)(kp[0] + 8) + hid + 2 * (size_t)(npmax + 8));
}

extern "C" int fused_mlp_fwd(const void* const* blk, const int* rows,
                             const int* offs, int n_blocks,
                             const void* const* wt, const void* const* bias,
                             const int* kp, const int* np, int n_layers,
                             int cin8, int d_out, long long M, void* out,
                             void* stream) {
  MlpArgs a;
  int rc = make_args(&a, blk, rows, offs, n_blocks, wt, nullptr, bias, kp, np,
                     n_layers, cin8, d_out, M);
  if (rc) return rc;
  if (M == 0) return (int)cudaGetLastError();
  const size_t smem = fwd_smem_bytes(kp, np, n_layers);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (M + TS - 1) / TS;
  fused_mlp_fwd_kernel<<<(unsigned)ntiles, NTHREADS, smem,
                         (cudaStream_t)stream>>>(a, (float*)out);
  return (int)cudaGetLastError();
}

// part: zeroed fp32 scratch [nblk][n_part], n_part = sum_l np*kp + np;
// dwb: fp32 [n_part] receiving the block-order sums.
extern "C" int fused_mlp_bwd(const void* const* blk, const int* rows,
                             const int* offs, int n_blocks,
                             const void* const* wt, const void* const* w,
                             const void* const* bias, const int* kp,
                             const int* np, int n_layers, int cin8, int d_out,
                             long long M, const void* g, void* dx, void* part,
                             void* dwb, int nblk, void* stream) {
  MlpArgs a;
  int rc = make_args(&a, blk, rows, offs, n_blocks, wt, w, bias, kp, np,
                     n_layers, cin8, d_out, M);
  if (rc) return rc;
  long long n_part = 0;
  for (int l = 0; l < n_layers; ++l)
    n_part += (long long)np[l] * kp[l] + np[l];
  cudaStream_t st = (cudaStream_t)stream;
  if (M > 0) {
    const size_t smem = bwd_smem_bytes(kp, np, n_layers);
    if (smem > SMEM_MAX || nblk < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    MlpGrad r;
    r.g = (const float*)g;
    r.dx = (float*)dx;
    r.part = (float*)part;
    r.n_part = n_part;
    fused_mlp_bwd_kernel<<<nblk, NTHREADS, smem, st>>>(a, r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  mlp_reduce_partials_kernel<<<(unsigned)((n_part + 255) / 256), 256, 0, st>>>(
      (const float*)part, nblk, n_part, (float*)dwb);
  return (int)cudaGetLastError();
}
