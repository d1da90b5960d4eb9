// Fused coarse shading head, forward (kernel B3) and backward (kernel B4).
//
// Replaces the TPU kernels fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:587
// (fused_shade_cm_fwd_pallas) and :620 (fused_shade_cm_bwd_pallas).
// Same function as their reference (fused_mlp_cm.py:562-580 and the
// TPU backward kernel :483-559):
//
//   x   = bf16([k0 | xyz, sin, cos | refl, sin, cos | normal | vd, sin, cos])
//         (each block zero-padded to a multiple of 8 rows, _shade_layout /
//          pad_plan, fused_mlp_cm.py:42-56, :406-446)
//   h1  = bf16(relu(W0^T x + b0)),  h2 = bf16(relu(W1^T h1 + b1))
//   out = W2^T h2 + b2                        (pre-sigmoid logits [3, M])
//
// with bf16 operands and fp32 sums.  The backward recomputes the hiddens
// per tile and rounds each layer's cotangent dz to bf16 before its two
// products, as the TPU kernel does (fused_mlp_cm.py:525-536); the bias
// gradients sum the fp32 dz; input cotangents go back through the
// sincos chain rule (_enc_bwd, fused_mlp_cm.py:449-459) with sinf/cosf.
// Hidden width 192 (the coarse refnet) or 128 (the geometry-searching
// refnet), one template instance each (B4's per-tile pass two: 2 or 3
// dx column tiles a warp, by cin8); cin8 <= 144 padded inputs (the DTU
// coarse head, viewbase_pe 3, has 144).
//
// Bound on an H100: operations (bf16 tensor cores, 989 TFLOP/s).  At the
// coarse bench shape (M = 2,359,296, cin8 128, hidden 192, 8 padded
// outputs) the forward does 2 x (128x192 + 192x192 + 192x8) = 125,952
// padded flop per sample, 297 GFLOP, >= 0.30 ms (0.26 ms unpadded).  The
// backward recomputes layers 0-1 and does a dW and a dh product per
// layer, ~884 padded GFLOP, >= 0.89 ms (0.78 ms unpadded).  Inputs,
// logits and cotangents are ~0.25 GB each way (~0.08 ms).
//
// Design.  Every product runs on the tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulate; helpers in mma_bf16.cuh), with
// fragments loaded by ldmatrix from bf16 [row][column] tiles in shared
// memory whose row strides are an odd number of 16-byte chunks, so the
// eight rows of an ldmatrix fall on distinct banks.
//
// - B3 (fused_shade_fwd_kernel): persistent blocks of 16 warps (one per
//   SM) keep the padded bf16 weights in shared memory for their life
//   (W0 128 x 192, W1 192 x 192, W2 192 x 8: 137 KB with the row pads;
//   W0 144 x 192 at the DTU coarse layout, 143 KB) and walk 64-sample
//   tiles.  The next tile's raw input rows are copied into shared memory
//   (cp.async) while the current tile computes; its encodings are built
//   with one (encoded row, sample) item per thread and step (uniform
//   work, pad rows written as zeros in the same pass).  The table of
//   what each encoded row reads and computes (EncTable) is built on the
//   host and passed as a __grid_constant__ kernel parameter: its row
//   index is uniform across a warp, so its reads are constant-bank
//   broadcasts, and its 2,880 B stay out of shared memory (at cin8 144
//   and width 192 B4's block needs all but 768 B of the 227 KB a block
//   may hold).
//   The layer products take the 64 samples as M: warp w owns the 32
//   samples (w / 8) * 32 .. and the 8-wide column tiles w % 8 + 8j; bias
//   + ReLU + bf16 rounding go from the accumulator fragments straight
//   into the next layer's shared tile.  The last layer (8 padded
//   outputs, n = 8) runs on mma too, on four warps; its logits are
//   staged through shared memory and stored as rows of 64 consecutive
//   samples.
// - B4 is two kernels.  fused_shade_bwd_kernel (persistent, weights in
//   shared memory and raw rows prefetched as in B3; the next tile's
//   cotangent rows go into one buffer once this tile's are read)
//   recomputes a tile's hiddens, forms dz2 = bf16(g), and dz1 and dz0
//   in registers from the dh fragments (dz = dh * (h > 0)), runs the dh
//   and dx products on mma with the samples as M, and writes the input
//   cotangents.  dW2 (192 x 8) and the three bias sums stay in registers
//   for the block's whole life (dW2 on mma with W2's 192 rows as M and
//   the samples as K; bias sums per lane over its rows, reduced over
//   lanes by shuffles and over the two warps of a column in a fixed
//   order at the end).  The tile's bf16 X, H1, dz1 and dz0 go to a
//   scratch buffer in device memory.  fused_shade_dw_kernel then forms
//   dW0 = X^T dz0 and dW1 = H1^T dz1 as a split-K product: a block owns a
//   64-row slice of dW0 or dW1 (M = 64 weight rows, N = the hidden width,
//   K = the samples of one of nblk equal sample ranges), streams its
//   range through shared memory in 64-sample chunks with cp.async double
//   buffering, keeps its slice in registers throughout, and writes it
//   once.  The blocks of one sample range are adjacent in launch order,
//   so the dz chunks that several slices read come from L2.
//
// Why B4 is two kernels: a single kernel cannot keep W0-W2 (137 KB)
// beside the 256-sample tiles of X, H1, dz1, dz0 (~450 KB) that flushing
// the dW partials once per 256 samples would need, and a 192 x 192 fp32
// dW1 is 144 registers a thread.  Flushing the 63,368-float partial
// slice per 64-sample tile instead reads and writes 7,921 B per sample
// (18.7 GB of L2 traffic per coarse bench call).  So the dW products
// leave the per-tile loop: B4 writes 1,408 B of bf16 activations per
// sample (X 256 at width 128; H1, dz1, dz0 384 each: 3.3 GB at the
// coarse bench shape, ~1 ms of device-memory writes at 3.35 TB/s) that
// the dW kernel reads back once (repeated dz reads mostly from L2).
//
// dW/db partial traffic.  Each dW kernel block writes its 64 x HID fp32
// slice once per call (nblk x (cin8 + HID) x HID floats, 33 MB at the
// coarse bench shape: 14 B per sample, written once and read once by the
// reduction); each backward block writes its dW2 and bias sums once
// (1,928 floats).  A second kernel sums the per-block slices in block
// order.  No float atomics: every partial element has one owner and a
// fixed summation order, so dW and db repeat bit for bit for a given
// grid.
//
// Registers, shared memory and spills: nvcc -Xptxas -v (build.py), read
// into PERF.md.  Sample indices are 64-bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

typedef __nv_bfloat16 bf16;

#define TS 64        // samples per tile
#define NT 512       // threads per B3 / B4 block: 16 warps, 2 along the
                     // samples (MTW m-tiles each) x 8 along the columns
#define MTW 2        // 16-sample m-tiles per warp
#define DW_NT 256    // threads per dW kernel block (8 warps)
#define OUT8 8       // padded rows of the last layer
#define SW2 24       // row stride of W2 and dz2 tiles: 8 values, 8 zeros, pad
#define MAXROW 144   // padded encoded rows (cin8 <= 144)
#define DW_ROWS 64   // weight rows per dW kernel block
#define SA_DW 72     // row stride of the dW kernel's staged X / H1 chunk
#define SMEM_MAX 232448

struct ShadeIn {
  const float* k0;
  const float* xyz;
  const float* refl;
  const float* normal;
  const float* vd;  // null when use_viewdir is false
  const bf16* w0;   // [cin8][HID]   (input rows at the padded offsets)
  const bf16* w1;   // [HID][HID]
  const bf16* w2;   // [HID][OUT8]
  const float* b0;  // [HID]
  const float* b1;  // [HID]
  const float* b2;  // [OUT8]
  long long M;
  int k0_dim, pos_pe, ref_pe, view_pe, use_vd, cin8;
};

__host__ __device__ inline int pad8(int r) { return (r + 7) / 8 * 8; }
__host__ __device__ inline int pad16(int r) { return (r + 15) / 16 * 16; }
__host__ __device__ inline int pad64(int r) { return (r + 63) / 64 * 64; }

// Row offsets of the padded encoding (pad_plan over _shade_layout).
struct Layout {
  int k0, xyz, xyz_s, xyz_c, refl, refl_s, refl_c, nrm, vd, vd_s, vd_c, cin8;
};

__host__ __device__ inline Layout make_layout(int k0_dim, int pos_pe,
                                              int ref_pe, int view_pe,
                                              int use_vd) {
  Layout L;
  int o = 0;
  L.k0 = o;     o += pad8(k0_dim);
  L.xyz = o;    o += 8;
  L.xyz_s = o;  o += pad8(3 * pos_pe);
  L.xyz_c = o;  o += pad8(3 * pos_pe);
  L.refl = o;   o += 8;
  L.refl_s = o; o += pad8(3 * ref_pe);
  L.refl_c = o; o += pad8(3 * ref_pe);
  L.nrm = o;    o += 8;
  L.vd = L.vd_s = L.vd_c = o;
  if (use_vd) {
    L.vd = o;   o += 8;
    L.vd_s = o; o += pad8(3 * view_pe);
    L.vd_c = o; o += pad8(3 * view_pe);
  }
  L.cin8 = o;
  return L;
}

__device__ inline bf16 tobf(float v) { return __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// encodings
// ---------------------------------------------------------------------------

// Per encoded row: the raw input row it reads (-1: a pad row), what it
// computes (0 identity, 1 sin, 2 cos) and the frequency.  Raw rows are
// k0 0..k0_dim-1, then xyz, refl, normal and vd, 3 each.
struct EncTable {
  const float* raw[MAXROW];
  int src[MAXROW];
  int kind[MAXROW];
  float freq[MAXROW];
};

static void enc_block(EncTable& T, int r, int o_id, int o_s, int o_c, int pe,
                      int raw0) {
  if (r >= o_id && r < o_id + 3) {
    T.src[r] = raw0 + r - o_id;
    T.kind[r] = 0;
  } else if (r >= o_s && r < o_s + 3 * pe) {
    T.src[r] = raw0 + (r - o_s) / pe;
    T.kind[r] = 1;
    T.freq[r] = (float)(1 << ((r - o_s) % pe));
  } else if (r >= o_c && r < o_c + 3 * pe) {
    T.src[r] = raw0 + (r - o_c) / pe;
    T.kind[r] = 2;
    T.freq[r] = (float)(1 << ((r - o_c) % pe));
  }
}

// The table of a call, on the host (every row; rows past cin8 are pad).
static EncTable make_table(const ShadeIn& a) {
  const Layout L = make_layout(a.k0_dim, a.pos_pe, a.ref_pe, a.view_pe,
                               a.use_vd);
  EncTable T;
  const int nraw = a.k0_dim + 9 + 3 * a.use_vd;
  for (int q = 0; q < MAXROW; ++q) {
    const float* p = nullptr;
    if (q < a.k0_dim) p = a.k0 + (long long)q * a.M;
    else if (q < a.k0_dim + 3) p = a.xyz + (long long)(q - a.k0_dim) * a.M;
    else if (q < a.k0_dim + 6) p = a.refl + (long long)(q - a.k0_dim - 3) * a.M;
    else if (q < a.k0_dim + 9) p = a.normal + (long long)(q - a.k0_dim - 6) * a.M;
    else if (q < nraw) p = a.vd + (long long)(q - a.k0_dim - 9) * a.M;
    T.raw[q] = p;
  }
  for (int r = 0; r < MAXROW; ++r) {
    T.src[r] = -1;
    T.kind[r] = 0;
    T.freq[r] = 1.0f;
    if (r >= L.k0 && r < L.k0 + a.k0_dim) T.src[r] = r - L.k0;
    if (r >= L.nrm && r < L.nrm + 3) T.src[r] = a.k0_dim + 6 + r - L.nrm;
    enc_block(T, r, L.xyz, L.xyz_s, L.xyz_c, a.pos_pe, a.k0_dim);
    enc_block(T, r, L.refl, L.refl_s, L.refl_c, a.ref_pe, a.k0_dim + 3);
    if (a.use_vd)
      enc_block(T, r, L.vd, L.vd_s, L.vd_c, a.view_pe, a.k0_dim + 9);
  }
  return T;
}

// Start the copies of a tile's cotangent rows into G [OUT8][TS] (zeros
// past d_out and M); one cp.async group.
__device__ void prefetch_g(long long M, long long s0, const float* g,
                           int d_out, float* G) {
  for (int e = threadIdx.x; e < OUT8 * TS; e += NT) {
    const int o = e >> 6;
    const long long gs = s0 + (e & (TS - 1));
    if (o < d_out && gs < M) cp_async4(G + e, g + (long long)o * M + gs);
    else G[e] = 0.0f;
  }
  cp_async_commit();
}

// Start the copies of a tile's raw input rows into RB [nraw][TS] (zeros
// past M); one cp.async group.
__device__ void prefetch_raw(const EncTable& T, int nraw, long long M,
                             long long s0, float* RB) {
  for (int e = threadIdx.x; e < nraw * TS; e += NT) {
    const int q = e >> 6;
    const long long gs = s0 + (e & (TS - 1));
    if (gs < M) cp_async4(RB + e, T.raw[q] + gs);
    else RB[e] = 0.0f;
  }
  cp_async_commit();
}

// Encoded tile X [TS][sx] (rows of cin16 values, pad rows zero) from the
// staged raw rows RB: one (encoded row, sample) item per thread and step.
// Ends with a barrier.
__device__ void build_x(const EncTable& T, const float* RB, int cin16,
                        bf16* X, int sx) {
  for (int e = threadIdx.x; e < TS * cin16; e += NT) {
    const int r = e >> 6, s = e & (TS - 1);
    const int src = T.src[r];
    float v = 0.0f;
    if (src >= 0) {
      v = RB[src * TS + s];
      const int kind = T.kind[r];
      if (kind) {
        const float xf = v * T.freq[r];
        v = kind == 1 ? sinf(xf) : cosf(xf);
      }
    }
    X[s * sx + r] = tobf(v);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// shared-memory weights
// ---------------------------------------------------------------------------

// dst [rows_pad][sd] <- src [rows][cols] (bf16, cols a multiple of 8);
// rows past `rows` and columns past `cols` up to `zero_cols` are zero.
__device__ void load_w(const bf16* src, int rows, int rows_pad, int cols,
                       int zero_cols, bf16* dst, int sd) {
  const int cc = zero_cols / 8;
  for (int e = threadIdx.x; e < rows_pad * cc; e += NT) {
    const int r = e / cc, c = (e - r * cc) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c < cols)
      v = __ldg(reinterpret_cast<const uint4*>(src + (long long)r * cols + c));
    *reinterpret_cast<uint4*>(dst + r * sd + c) = v;
  }
}

// ---------------------------------------------------------------------------
// tile products
// ---------------------------------------------------------------------------

// Warp w of a B3 / B4 block owns the samples of m-tiles (w / 8) * MTW ..
// + MTW - 1 (rows mt * 16 ..) and the column tiles nt = w % 8 + 8j.
__device__ __forceinline__ int warp_m0() { return (threadIdx.x >> 8) * MTW * 16; }
__device__ __forceinline__ int warp_n() { return (threadIdx.x >> 5) & 7; }

// acc[i][j] = A[64][K] x B[K][N] for the warp's m-tile i and column
// tile j (skipped past ntiles).  A is stored [sample][k]; B is stored
// [k][n] (B_KN) or [n][k].
template <int NTW, bool B_KN>
__device__ __forceinline__ void tile_mma(float (&acc)[MTW][NTW][4],
                                         const bf16* A, int sa, const bf16* B,
                                         int sb, int K, int ntiles) {
  const int lane = threadIdx.x & 31, m0 = warp_m0(), wn = warp_n();
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MTW][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i) frag_a(a[i], A, sa, m0 + i * 16, k0, lane);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int nt = wn + 8 * j;
      if (nt < ntiles) {
        uint32_t b0, b1;
        if (B_KN) frag_b_t(b0, b1, B, sb, nt * 8, k0, lane);
        else frag_b(b0, b1, B, sb, nt * 8, k0, lane);
#pragma unroll
        for (int i = 0; i < MTW; ++i) mma16816(acc[i][j], a[i], b0, b1);
      }
    }
  }
}

// H[s][n] = bf16(relu(acc + b[n])) for the warp's HID / 64 column tiles.
template <int NTW>
__device__ __forceinline__ void relu_epilogue(const float (&acc)[MTW][NTW][4],
                                              const float* bias, bf16* H,
                                              int sh) {
  const int lane = threadIdx.x & 31, m0 = warp_m0(), wn = warp_n();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int n = (wn + 8 * j) * 8 + 2 * t;
    const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int s = m0 + i * 16 + g;
      *reinterpret_cast<uint32_t*>(H + s * sh + n) =
          pack2(tobf(fmaxf(acc[i][j][0] + b0, 0.0f)),
                tobf(fmaxf(acc[i][j][1] + b1, 0.0f)));
      *reinterpret_cast<uint32_t*>(H + (s + 8) * sh + n) =
          pack2(tobf(fmaxf(acc[i][j][2] + b0, 0.0f)),
                tobf(fmaxf(acc[i][j][3] + b1, 0.0f)));
    }
  }
}

// dz = dh * (H > 0) written as bf16 over H (in place: each element is
// read and written by its own lane); the fp32 dz of the lane's rows is
// added to db[j][c] (column (w % 8 + 8j) * 8 + 2t + c).
// h = bf16(relu(z)) > 0 exactly when z > 0 (a positive z below bf16's
// smallest subnormal, 2^-133, would be the only exception).
template <int NTW>
__device__ __forceinline__ void relu_bwd_epilogue(const float (&acc)[MTW][NTW][4],
                                                  bf16* H, int sh,
                                                  float (&db)[NTW][2]) {
  const int lane = threadIdx.x & 31, m0 = warp_m0(), wn = warp_n();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int n = (wn + 8 * j) * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* p = reinterpret_cast<uint32_t*>(H + (m0 + i * 16 + g + 8 * h) * sh + n);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(p);
        const float z0 = __low2float(hv) > 0.0f ? acc[i][j][2 * h] : 0.0f;
        const float z1 = __high2float(hv) > 0.0f ? acc[i][j][2 * h + 1] : 0.0f;
        *p = pack2(tobf(z0), tobf(z1));
        db[j][0] += z0;
        db[j][1] += z1;
      }
    }
  }
}

// Copy a [TS][cols] bf16 tile (stride st, cols of it) to device memory
// rows of `width` values (zeros past cols), in 16-byte pieces.
__device__ __forceinline__ void store_tile(const bf16* S, int st, int cols,
                                           int width, bf16* dst) {
  const int cc = width / 8;
  for (int e = threadIdx.x; e < TS * cc; e += NT) {
    const int s = e / cc, c = (e - s * cc) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < cols) v = *reinterpret_cast<const uint4*>(S + s * st + c);
    *reinterpret_cast<uint4*>(dst + (long long)s * width + c) = v;
  }
}

// ---------------------------------------------------------------------------
// B3: forward
// ---------------------------------------------------------------------------

template <int HID>
__global__ void __launch_bounds__(NT, 1)
fused_shade_fwd_kernel(ShadeIn a, const __grid_constant__ EncTable T,
                       float* __restrict__ out, int d_out) {
  constexpr int SH = HID + 8;
  constexpr int NTW = HID / 64;
  extern __shared__ __align__(16) unsigned char shade_smem[];
  const Layout L = make_layout(a.k0_dim, a.pos_pe, a.ref_pe, a.view_pe,
                               a.use_vd);
  const int cin16 = pad16(L.cin8), sx = cin16 + 8;
  bf16* W0 = reinterpret_cast<bf16*>(shade_smem);
  bf16* W1 = W0 + cin16 * SH;     // [HID][SH]
  bf16* W2 = W1 + HID * SH;       // [HID][SW2]
  bf16* X = W2 + HID * SW2;       // [TS][sx]
  bf16* H1 = X + TS * sx;         // [TS][SH]
  bf16* H2 = H1 + TS * SH;        // [TS][SH]
  float* OS = reinterpret_cast<float*>(H2 + TS * SH);  // [OUT8][TS]
  float* RB = OS + OUT8 * TS;     // 2 x [nraw][TS] staged raw rows
  const int nraw = a.k0_dim + 9 + 3 * a.use_vd;
  load_w(a.w0, L.cin8, cin16, HID, HID, W0, SH);
  load_w(a.w1, HID, HID, HID, HID, W1, SH);
  load_w(a.w2, HID, HID, OUT8, 16, W2, SW2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long ntiles = (a.M + TS - 1) / TS;
  int buf = 0;
  if (blockIdx.x < ntiles)
    prefetch_raw(T, nraw, a.M, blockIdx.x * (long long)TS, RB);
  for (long long tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, buf ^= 1) {
    const long long s0 = tile * TS;
    // the next tile's raw rows load while this one computes
    if (tile + gridDim.x < ntiles)
      prefetch_raw(T, nraw, a.M, s0 + (long long)gridDim.x * TS,
                   RB + (buf ^ 1) * nraw * TS);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // also: the weights are in place (first tile)
    build_x(T, RB + buf * nraw * TS, cin16, X, sx);
    {
      float acc[MTW][NTW][4];
      tile_mma<NTW, true>(acc, X, sx, W0, SH, cin16, HID / 8);
      relu_epilogue<NTW>(acc, a.b0, H1, SH);
    }
    __syncthreads();
    {
      float acc[MTW][NTW][4];
      tile_mma<NTW, true>(acc, H1, SH, W1, SH, HID, HID / 8);
      relu_epilogue<NTW>(acc, a.b1, H2, SH);
    }
    __syncthreads();
    // last layer: 64 x 8 logits, one m-tile per warp on warps 0-3
    if (warp < 4) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < HID; k0 += 16) {
        uint32_t af[4], b0, b1;
        frag_a(af, H2, SH, warp * 16, k0, lane);
        frag_b_t(b0, b1, W2, SW2, 0, k0, lane);
        mma16816(acc, af, b0, b1);
      }
      const int s = warp * 16 + g;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int o = 2 * t + c;
        const float bo = o < d_out ? __ldg(a.b2 + o) : 0.0f;
        OS[o * TS + s] = acc[c] + bo;
        OS[o * TS + s + 8] = acc[2 + c] + bo;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < d_out * TS; e += NT) {
      const int o = e >> 6, s = e & (TS - 1);
      if (s0 + s < a.M) out[(long long)o * a.M + s0 + s] = OS[e];
    }
  }
}

// ---------------------------------------------------------------------------
// B4: backward (per-tile pass, then the dW product)
// ---------------------------------------------------------------------------

struct ShadeGrad {
  const float* g;  // [d_out][M]
  float* d_k0;
  float* d_xyz;
  float* d_refl;
  float* d_normal;
  float* d_vd;
  bf16* xs;        // [Mp][xw]   encoded inputs (zeros past cin8)
  bf16* h1s;       // [Mp][HID]  layer-0 outputs
  bf16* dz1s;      // [Mp][HID]  bf16 dz of layer 1
  bf16* dz0s;      // [Mp][HID]  bf16 dz of layer 0
  float* part;     // [nblk][n_part]
  long long n_part;
  int xw;          // pad64(cin8)
};

__device__ float enc_bwd(const float* DX, int o_id, int o_s, int o_c, int j,
                         int pe, float v) {
  float acc = DX[o_id + j];
  for (int i = 0; i < pe; ++i) {
    const float f = (float)(1 << i);
    const float xf = v * f;
    const float t = __fsub_rn(__fmul_rn(cosf(xf), DX[o_s + j * pe + i]),
                              __fmul_rn(sinf(xf), DX[o_c + j * pe + i]));
    acc = __fadd_rn(acc, __fmul_rn(f, t));
  }
  return acc;
}

// NDX: the 8-wide column tiles of the dx product a warp owns, 2 for
// cin8 <= 128 and 3 above (an idle third tile cost B4 1-3% at cin8 128
// and 120 on an H100)
template <int HID, int NDX>
__global__ void __launch_bounds__(NT, 1)
fused_shade_bwd_kernel(ShadeIn a, const __grid_constant__ EncTable T,
                       ShadeGrad r, int d_out) {
  constexpr int SH = HID + 8;
  constexpr int NTW = HID / 64;
  extern __shared__ __align__(16) unsigned char shade_smem[];
  const Layout L = make_layout(a.k0_dim, a.pos_pe, a.ref_pe, a.view_pe,
                               a.use_vd);
  const int cin16 = pad16(L.cin8), sx = cin16 + 8, sdx = cin16 + 1;
  bf16* W0 = reinterpret_cast<bf16*>(shade_smem);
  bf16* W1 = W0 + cin16 * SH;     // [HID][SH]
  bf16* W2 = W1 + HID * SH;       // [HID][SW2]
  bf16* X = W2 + HID * SW2;       // [TS][sx]
  bf16* H2 = X + TS * sx;         // [TS][SH], then dz1
  bf16* H1 = H2 + TS * SH;        // [TS][SH], then dz0
  bf16* DZ2 = H1 + TS * SH;       // [TS][SW2]: bf16(g), zeros past 8
  // [TS][sdx] fp32 over X and H2 (dead once the dx product is done), and
  // over the start of H1 where X and H2 are too small (width 128 at cin8
  // 144): it is then written only once every warp has read its dz0
  float* DX = reinterpret_cast<float*>(X);
  const bool dx_over_h1 =
      (size_t)TS * sdx * sizeof(float) > (size_t)(H1 - X) * sizeof(bf16);
  float* GB = reinterpret_cast<float*>(DZ2 + TS * SW2);  // [OUT8][TS]
  float* RB = GB + OUT8 * TS;     // 2 x [nraw][TS] staged raw rows
  const int nraw = a.k0_dim + 9 + 3 * a.use_vd;
  load_w(a.w0, L.cin8, cin16, HID, HID, W0, SH);
  load_w(a.w1, HID, HID, HID, HID, W1, SH);
  load_w(a.w2, HID, HID, OUT8, 16, W2, SW2);
  for (int e = threadIdx.x; e < TS * SW2; e += NT) DZ2[e] = tobf(0.0f);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // block-life sums: dW2 (m-tile `warp` of its HID rows), db1 / db0 per
  // lane over its rows, db2 per thread of warps 0-7 over its samples
  float dw2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float db1[NTW][2], db0[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j) db1[j][0] = db1[j][1] = db0[j][0] = db0[j][1] = 0.0f;
  float db2 = 0.0f;
  const int go = threadIdx.x >> 5;  // g row of this thread: warp

  const long long ntiles = (a.M + TS - 1) / TS;
  int buf = 0;
  if (blockIdx.x < ntiles) {
    prefetch_raw(T, nraw, a.M, blockIdx.x * (long long)TS, RB);
    prefetch_g(a.M, blockIdx.x * (long long)TS, r.g, d_out, GB);
  }
  for (long long tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, buf ^= 1) {
    const long long s0 = tile * TS;
    const bool more = tile + gridDim.x < ntiles;
    // in flight: this tile's raw and cotangent rows; the next tile's raw
    // rows join them
    if (more)
      prefetch_raw(T, nraw, a.M, s0 + (long long)gridDim.x * TS,
                   RB + (buf ^ 1) * nraw * TS);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // also: the weights and DZ2's zeros are in place
    const float* rb = RB + buf * nraw * TS;
    build_x(T, rb, cin16, X, sx);
    {
      float acc[MTW][NTW][4];
      tile_mma<NTW, true>(acc, X, sx, W0, SH, cin16, HID / 8);
      relu_epilogue<NTW>(acc, a.b0, H1, SH);
    }
    __syncthreads();
    store_tile(X, sx, cin16, r.xw, r.xs + s0 * r.xw);
    store_tile(H1, SH, HID, HID, r.h1s + s0 * HID);
    {
      float acc[MTW][NTW][4];
      tile_mma<NTW, true>(acc, H1, SH, W1, SH, HID, HID / 8);
      relu_epilogue<NTW>(acc, a.b1, H2, SH);
    }
    // dz2 = g: fp32 for db2, bf16 for the products
    if (go < OUT8) {
      for (int q = 0; q < 2; ++q) {
        const int s = lane + 32 * q;
        const float gv = GB[go * TS + s];
        db2 += gv;
        DZ2[s * SW2 + go] = tobf(gv);
      }
    }
    __syncthreads();
    // GB is read: the next tile's cotangent rows load into it
    if (more) prefetch_g(a.M, s0 + (long long)gridDim.x * TS, r.g, d_out, GB);
    // dW2 += H2^T dz2: rows i of W2 as M, samples as K
    if (warp < HID / 16) {
#pragma unroll
      for (int k0 = 0; k0 < TS; k0 += 16) {
        uint32_t af[4], b0, b1;
        frag_a_t(af, H2, SH, warp * 16, k0, lane);
        frag_b_t(b0, b1, DZ2, SW2, 0, k0, lane);
        mma16816(dw2, af, b0, b1);
      }
    }
    __syncthreads();
    // dh2 = dz2 W2^T (K = 8 values + 8 zeros); dz1 over H2
    {
      float acc[MTW][NTW][4];
      tile_mma<NTW, false>(acc, DZ2, SW2, W2, SW2, 16, HID / 8);
      relu_bwd_epilogue<NTW>(acc, H2, SH, db1);
    }
    __syncthreads();
    store_tile(H2, SH, HID, HID, r.dz1s + s0 * HID);
    // dh1 = dz1 W1^T; dz0 over H1
    {
      float acc[MTW][NTW][4];
      tile_mma<NTW, false>(acc, H2, SH, W1, SH, HID, HID / 8);
      relu_bwd_epilogue<NTW>(acc, H1, SH, db0);
    }
    __syncthreads();
    store_tile(H1, SH, HID, HID, r.dz0s + s0 * HID);
    // dx = dz0 W0^T -> DX fp32
    {
      float acc[MTW][NDX][4];
      tile_mma<NDX, false>(acc, H1, SH, W0, SH, HID, L.cin8 / 8);
      if (dx_over_h1) __syncthreads();  // uniform across the block
#pragma unroll
      for (int j = 0; j < NDX; ++j) {
        const int nt = warp_n() + 8 * j;
        if (nt < L.cin8 / 8) {
          const int n = nt * 8 + 2 * t;
#pragma unroll
          for (int i = 0; i < MTW; ++i) {
            const int s = warp_m0() + i * 16 + g;
            DX[s * sdx + n] = acc[i][j][0];
            DX[s * sdx + n + 1] = acc[i][j][1];
            DX[(s + 8) * sdx + n] = acc[i][j][2];
            DX[(s + 8) * sdx + n + 1] = acc[i][j][3];
          }
        }
      }
    }
    __syncthreads();
    // input cotangents: one (raw row, sample) item per thread and step
    for (int e = threadIdx.x; e < TS * nraw; e += NT) {
      const int q = e >> 6, s = e & (TS - 1);
      const long long gs = s0 + s;
      if (gs >= a.M) continue;
      const float* D = DX + s * sdx;
      if (q < a.k0_dim) {
        r.d_k0[(long long)q * a.M + gs] = D[L.k0 + q];
        continue;
      }
      const int c = q - a.k0_dim, j = c % 3;
      const long long o = (long long)j * a.M + gs;
      const float v = rb[q * TS + s];
      if (c < 3) {
        r.d_xyz[o] = enc_bwd(D, L.xyz, L.xyz_s, L.xyz_c, j, a.pos_pe, v);
      } else if (c < 6) {
        r.d_refl[o] = enc_bwd(D, L.refl, L.refl_s, L.refl_c, j, a.ref_pe, v);
      } else if (c < 9) {
        r.d_normal[o] = D[L.nrm + j];
      } else {
        r.d_vd[o] = enc_bwd(D, L.vd, L.vd_s, L.vd_c, j, a.view_pe, v);
      }
    }
    __syncthreads();
  }

  cp_async_wait<0>();
  // this block's slot: dW2 [HID][8], db0 [HID], db1 [HID], db2 [8]
  float* P = r.part + (long long)blockIdx.x * r.n_part;
  float* Pw2 = P + (long long)L.cin8 * HID + HID * HID;
  float* Pb0 = Pw2 + HID * OUT8;
  float* Pb1 = Pb0 + HID;
  float* Pb2 = Pb1 + HID;
  if (warp < HID / 16) {
    const int i = warp * 16 + g;
    *reinterpret_cast<float2*>(Pw2 + i * OUT8 + 2 * t) =
        make_float2(dw2[0], dw2[1]);
    *reinterpret_cast<float2*>(Pw2 + (i + 8) * OUT8 + 2 * t) =
        make_float2(dw2[2], dw2[3]);
  }
  // bias sums: over the 8 lanes of a column, then the two warps that
  // share the columns (red[2][2][HID] over the dead X tile), in order
  float* red = reinterpret_cast<float*>(X);
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v1 = db1[j][c], v0 = db0[j][c];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, m);
        v0 += __shfl_xor_sync(0xffffffffu, v0, m);
      }
      if (g == 0) {
        const int n = (warp_n() + 8 * j) * 8 + 2 * t + c;
        const int wm = warp >> 3;
        red[(0 * 2 + wm) * HID + n] = v1;
        red[(1 * 2 + wm) * HID + n] = v0;
      }
    }
  }
  if (go < OUT8) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) db2 += __shfl_xor_sync(0xffffffffu, db2, m);
    if (lane == 0) Pb2[go] = db2;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < HID; n += NT) {
    Pb1[n] = red[n] + red[HID + n];
    Pb0[n] = red[2 * HID + n] + red[3 * HID + n];
  }
}

// dW0 = X^T dz0 and dW1 = H1^T dz1: block (tile, range) owns 64 weight
// rows of one matrix and one of nblk sample ranges; writes its fp32
// [64][HID] slice into slot `range` of the partials.
template <int HID>
__global__ void __launch_bounds__(DW_NT)
fused_shade_dw_kernel(ShadeGrad r, long long mp, int cin8, int nblk) {
  constexpr int SH = HID + 8;
  constexpr int NTW = HID / 64;
  extern __shared__ __align__(16) unsigned char shade_smem[];
  bf16* As = reinterpret_cast<bf16*>(shade_smem);  // 2 x [TS][SA_DW]
  bf16* Ds = As + 2 * TS * SA_DW;                  // 2 x [TS][SH]
  const int nt0 = (cin8 + DW_ROWS - 1) / DW_ROWS;
  const int ntile = nt0 + HID / DW_ROWS;
  const int tile = blockIdx.x % ntile;
  const long long range = blockIdx.x / ntile;
  const bool first = tile < nt0;
  const int i0 = (first ? tile : tile - nt0) * DW_ROWS;
  const int lda = first ? r.xw : HID;
  const int nrows = first ? cin8 : HID;
  const bf16* A = (first ? r.xs : r.h1s) + i0;
  const bf16* D = first ? r.dz0s : r.dz1s;
  const long long nchunk = mp / TS;
  const long long c_begin = range * nchunk / nblk;
  const long long c_end = (range + 1) * nchunk / nblk;

  auto load = [&](long long c, int st) {
    bf16* as = As + st * TS * SA_DW;
    bf16* ds = Ds + st * TS * SH;
    const long long s0 = c * TS;
    for (int e = threadIdx.x; e < TS * (DW_ROWS / 8); e += DW_NT) {
      const int s = e / (DW_ROWS / 8), k = (e % (DW_ROWS / 8)) * 8;
      cp_async16(as + s * SA_DW + k, A + (s0 + s) * lda + k);
    }
    for (int e = threadIdx.x; e < TS * (HID / 8); e += DW_NT) {
      const int s = e / (HID / 8), k = (e % (HID / 8)) * 8;
      cp_async16(ds + s * SH + k, D + (s0 + s) * HID + k);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[4][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;

  if (c_begin < c_end) load(c_begin, 0);
  cp_async_commit();
  for (long long c = c_begin; c < c_end; ++c) {
    const int st = (int)((c - c_begin) & 1);
    if (c + 1 < c_end) load(c + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* as = As + st * TS * SA_DW;
    const bf16* ds = Ds + st * TS * SH;
#pragma unroll
    for (int k0 = 0; k0 < TS; k0 += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) frag_a_t(af[mt], as, SA_DW, mt * 16, k0, lane);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        uint32_t b0, b1;
        frag_b_t(b0, b1, ds, SH, (warp + 8 * j) * 8, k0, lane);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma16816(acc[mt][j], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* P = r.part + range * r.n_part + (first ? 0 : (long long)cin8 * HID);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + mt * 16 + g + 8 * h;
      if (i >= nrows) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n = (warp + 8 * j) * 8 + 2 * t;
        *reinterpret_cast<float2*>(P + (long long)i * HID + n) =
            make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
    }
  }
}

// out[e] = sum_b part[b][e], in block order.
__global__ void shade_reduce_partials_kernel(const float* __restrict__ part,
                                             int nblk, long long n,
                                             float* __restrict__ out) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < nblk; ++b) acc += part[(long long)b * n + e];
  out[e] = acc;
}

// ---------------------------------------------------------------------------
// C launchers
// ---------------------------------------------------------------------------

// The one list of compiled hidden widths: the coarse refnet (192) and the
// geometry-searching refnet (128) of every built-in config.  A width
// outside it has no kernel and check_dims rejects it.
struct ShadeKernels {
  int hid;
  void (*fwd)(ShadeIn, const EncTable, float*, int);
  void (*bwd)(ShadeIn, const EncTable, ShadeGrad, int);       // cin8 <= 128
  void (*bwd_wide)(ShadeIn, const EncTable, ShadeGrad, int);  // to MAXROW
  void (*dw)(ShadeGrad, long long, int, int);
};
static const ShadeKernels kShadeKernels[] = {
    {128, fused_shade_fwd_kernel<128>, fused_shade_bwd_kernel<128, 2>,
     fused_shade_bwd_kernel<128, 3>, fused_shade_dw_kernel<128>},
    {192, fused_shade_fwd_kernel<192>, fused_shade_bwd_kernel<192, 2>,
     fused_shade_bwd_kernel<192, 3>, fused_shade_dw_kernel<192>},
};

static const ShadeKernels* kernels_for(int hid) {
  for (const ShadeKernels& k : kShadeKernels)
    if (k.hid == hid) return &k;
  return nullptr;
}

static size_t weights_bytes(int cin8, int hid) {
  return sizeof(bf16) * ((size_t)pad16(cin8) * (hid + 8) +
                         (size_t)hid * (hid + 8) + (size_t)hid * SW2);
}

// nraw = k0_dim + 9 (+ 3 with viewdir) raw input rows, staged twice
static size_t fwd_smem_bytes(int cin8, int hid, int nraw) {
  return weights_bytes(cin8, hid) +
         sizeof(bf16) * ((size_t)TS * (pad16(cin8) + 8) +
                         2 * (size_t)TS * (hid + 8)) +
         sizeof(float) * ((size_t)OUT8 * TS + 2 * (size_t)nraw * TS);
}

// the cotangent rows staged once, the raw rows twice
static size_t bwd_smem_bytes(int cin8, int hid, int nraw) {
  return weights_bytes(cin8, hid) +
         sizeof(bf16) * ((size_t)TS * (pad16(cin8) + 8) +
                         2 * (size_t)TS * (hid + 8) + (size_t)TS * SW2) +
         sizeof(float) * ((size_t)OUT8 * TS + 2 * (size_t)nraw * TS);
}

static size_t dw_smem_bytes(int hid) {
  return sizeof(bf16) * 2 * (size_t)TS * (SA_DW + hid + 8);
}

static int check_dims(int cin8, int hid, int d_out, int k0_dim, int pos_pe,
                      int ref_pe, int view_pe, int use_vd) {
  const Layout L = make_layout(k0_dim, pos_pe, ref_pe, view_pe, use_vd);
  if (!kernels_for(hid) || L.cin8 != cin8 || cin8 > MAXROW || d_out < 1 ||
      d_out > OUT8)
    return (int)cudaErrorInvalidValue;
  return 0;
}

static ShadeIn make_in(const void* k0, const void* xyz, const void* refl,
                       const void* normal, const void* vd, const void* w0,
                       const void* w1, const void* w2, const void* b0,
                       const void* b1, const void* b2, long long M,
                       int k0_dim, int pos_pe, int ref_pe, int view_pe,
                       int use_vd, int cin8) {
  ShadeIn a;
  a.k0 = (const float*)k0;
  a.xyz = (const float*)xyz;
  a.refl = (const float*)refl;
  a.normal = (const float*)normal;
  a.vd = (const float*)vd;
  a.w0 = (const bf16*)w0;
  a.w1 = (const bf16*)w1;
  a.w2 = (const bf16*)w2;
  a.b0 = (const float*)b0;
  a.b1 = (const float*)b1;
  a.b2 = (const float*)b2;
  a.M = M;
  a.k0_dim = k0_dim;
  a.pos_pe = pos_pe;
  a.ref_pe = ref_pe;
  a.view_pe = view_pe;
  a.use_vd = use_vd;
  a.cin8 = cin8;
  return a;
}

template <class K>
static cudaError_t set_smem(K kern, size_t smem) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Dynamic shared memory of a block (not a launcher; for reports): which
// 0 = B3, 1 = B4's per-tile pass, 2 = B4's dW kernel.
extern "C" long long fused_shade_smem_bytes(int cin8, int hid, int nraw,
                                            int which) {
  if (which == 0) return (long long)fwd_smem_bytes(cin8, hid, nraw);
  if (which == 1) return (long long)bwd_smem_bytes(cin8, hid, nraw);
  return (long long)dw_smem_bytes(hid);
}

extern "C" int fused_shade_fwd(
    const void* k0, const void* xyz, const void* refl, const void* normal,
    const void* vd, const void* w0, const void* w1, const void* w2,
    const void* b0, const void* b1, const void* b2, void* out, long long M,
    int k0_dim, int pos_pe, int ref_pe, int view_pe, int use_vd, int cin8,
    int hid, int d_out, int nblk, void* stream) {
  int rc = check_dims(cin8, hid, d_out, k0_dim, pos_pe, ref_pe, view_pe,
                      use_vd);
  if (rc) return rc;
  if (M == 0) return (int)cudaGetLastError();
  const size_t smem = fwd_smem_bytes(cin8, hid, k0_dim + 9 + 3 * use_vd);
  void (*kern)(ShadeIn, const EncTable, float*, int) = kernels_for(hid)->fwd;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  ShadeIn a = make_in(k0, xyz, refl, normal, vd, w0, w1, w2, b0, b1, b2, M,
                      k0_dim, pos_pe, ref_pe, view_pe, use_vd, cin8);
  kern<<<nblk, NT, smem, (cudaStream_t)stream>>>(a, make_table(a),
                                                 (float*)out, d_out);
  return (int)cudaGetLastError();
}

// scratch: bf16 [Mp * (pad64(cin8) + 3 * hid)], Mp = M rounded up to 64;
// part: zeroed fp32 [nblk][n_part], n_part = cin8*hid + hid*hid + hid*8 +
// 2*hid + 8; dwb: fp32 [n_part] receiving the block-order sums.
extern "C" int fused_shade_bwd(
    const void* k0, const void* xyz, const void* refl, const void* normal,
    const void* vd, const void* w0, const void* w1, const void* w2,
    const void* b0, const void* b1, const void* b2, const void* g,
    void* d_k0, void* d_xyz, void* d_refl, void* d_normal, void* d_vd,
    void* scratch, void* part, void* dwb, long long M, int k0_dim,
    int pos_pe, int ref_pe, int view_pe, int use_vd, int cin8, int hid,
    int d_out, int nblk, void* stream) {
  int rc = check_dims(cin8, hid, d_out, k0_dim, pos_pe, ref_pe, view_pe,
                      use_vd);
  if (rc) return rc;
  if (nblk < 1) return (int)cudaErrorInvalidValue;
  const long long n_part = (long long)cin8 * hid + (long long)hid * hid +
                           (long long)hid * OUT8 + 2LL * hid + OUT8;
  cudaStream_t st = (cudaStream_t)stream;
  if (M > 0) {
    const ShadeKernels* ks = kernels_for(hid);
    const long long mp = (M + TS - 1) / TS * TS;
    ShadeIn a = make_in(k0, xyz, refl, normal, vd, w0, w1, w2, b0, b1, b2,
                        M, k0_dim, pos_pe, ref_pe, view_pe, use_vd, cin8);
    ShadeGrad r;
    r.g = (const float*)g;
    r.d_k0 = (float*)d_k0;
    r.d_xyz = (float*)d_xyz;
    r.d_refl = (float*)d_refl;
    r.d_normal = (float*)d_normal;
    r.d_vd = (float*)d_vd;
    r.xw = pad64(cin8);
    r.xs = (bf16*)scratch;
    r.h1s = r.xs + mp * r.xw;
    r.dz1s = r.h1s + mp * hid;
    r.dz0s = r.dz1s + mp * hid;
    r.part = (float*)part;
    r.n_part = n_part;
    const size_t smem = bwd_smem_bytes(cin8, hid, k0_dim + 9 + 3 * use_vd);
    void (*bwd)(ShadeIn, const EncTable, ShadeGrad, int) =
        cin8 <= 128 ? ks->bwd : ks->bwd_wide;
    cudaError_t err = set_smem(bwd, smem);
    if (err != cudaSuccess) return (int)err;
    bwd<<<nblk, NT, smem, st>>>(a, make_table(a), r, d_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem_dw = dw_smem_bytes(hid);
    err = set_smem(ks->dw, smem_dw);
    if (err != cudaSuccess) return (int)err;
    const int ntile = (cin8 + DW_ROWS - 1) / DW_ROWS + hid / DW_ROWS;
    ks->dw<<<ntile * nblk, DW_NT, smem_dw, st>>>(r, mp, cin8, nblk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  shade_reduce_partials_kernel<<<(unsigned)((n_part + 255) / 256), 256, 0,
                                 st>>>((const float*)part, nblk, n_part,
                                       (float*)dwb);
  return (int)cudaGetLastError();
}
