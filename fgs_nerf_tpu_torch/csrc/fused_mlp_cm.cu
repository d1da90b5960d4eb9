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
// dx product, and sums the bias gradients from the fp32 dz.  All dims are
// padded to multiples of 16 by the caller with zero weights and biases
// (zero rows stay zero through relu).
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): operations.  At the
// fine shading head's shapes (M = 1,048,576) the rgbnet forward is
// 2 x (106 x 256 + 3 x 256 x 256) ~ 0.45 MFLOP per sample, 469 GFLOP,
// >= 0.47 ms; the backward (hiddens recomputed, a dW and a dh product per
// layer) 1.27 TFLOP, >= 1.28 ms (refnet 1.32 TFLOP, >= 1.34 ms).
//
// B8 (fused_mlp_fwd_kernel), the first cut: a block owns a tile of 64
// samples and keeps the tile's input and hidden activations in shared
// memory as bf16 [sample][feature] rows.  Every product runs on the
// tensor cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
// the 64 samples as M and each warp owning a set of 8-wide output column
// tiles.  Its B fragments are read straight from device memory, where the
// whole net (< 1 MB of bf16) stays in L2.
//
// B9 is three kernels, after B4's pattern (fused_shade_cm.cu):
//
// - fused_mlp_tile_bwd_kernel, the per-tile pass: persistent blocks of 16
//   warps walk 128-sample tiles.  One bf16 activation tile [128][sa]
//   holds X, then each hidden layer, then each dz, every product written
//   back over it (the accumulators are in registers, 64 a thread: warp w
//   owns 64 samples and the column tiles w % 8 + 8j of up to 256
//   columns).  Per tile: X from the input rows; the forward layers
//   0 .. L-2, each H's ReLU mask kept as ballot bits (z > 0, 4 KB a
//   layer); dz_L-1 = bf16(g) with the fp32 bias sums of g; the backward
//   products dh = dz W^T, dz = dh * mask, fp32 bias sums per lane reduced
//   by shuffles into per-warp-half sums in shared memory; and the dx
//   passes (at most 256 columns each), written as dx [cin8, M].  Each
//   product's weights stream through shared memory in 64-row chunks
//   (cp.async, three stages, read by ldmatrix), and the next product's
//   first two chunks load during this one's epilogue.  The tile's bf16
//   X, H_1 .. H_L-1 and dz_0 .. dz_L-1 go to a scratch buffer in device
//   memory, each once.  A last layer of 16 padded outputs (the refnet's
//   3) keeps its 256 x 16 dW in registers instead (K = the tile's
//   samples).  The block writes its bias sums and that dW once, at the
//   end.
// - fused_mlp_dw_kernel forms every other dW_l = A_l^T dz_l as a split-K
//   product: a block owns a 64-row slice of one dW_l (M = 64 weight
//   rows, N = the layer's outputs <= 256, K = the samples of one of nr
//   equal ranges), streams its range through shared memory in 64-sample
//   chunks with cp.async double buffering, loads fragments by ldmatrix,
//   keeps its slice in registers and writes it once.  nr fills the card
//   about four blocks an SM (two resident, two waves); the slices of one
//   range are adjacent in launch order, so the dz chunks that a layer's
//   slices share come from L2.
// - mlp_reduce_partials_kernel sums the per-block and per-range partials
//   in a fixed order.  No float atomics and nothing read-modify-written
//   across blocks: dW and db repeat bit for bit for a given grid.
//
// Why a scratch: a 256 x 256 layer is 128 KB of bf16, so the per-tile
// pass can hold one layer's weights in chunks but not the dW partials
// of a 4-layer, 256-wide net (905 KB of fp32), and read-modify-writing a
// per-block partial copy once per tile moved ~30 GB per call.  Instead
// the scratch costs 3,968 B a sample at the fine rgbnet (X 192 wide, 3 H
// and 4 dz 256 wide: 4.16 GB at M = 1,048,576, written once and read
// back once) and 3,200 B at the refnet (X 320, 2 H, 3 dz: 3.36 GB).
//
// Shared memory of a per-tile block (limit 232,448 B): activation tile
// 128 x (max(kp0, widest layer) + 8) x 2 B, weight stages 3 x 64 x 264 x
// 2 B = 101,376, masks 4,096 B a hidden layer, bias sums 2 x L x 256 x
// 4 B, input row pointers 8 B a row, and for a 16-output last layer its
// dz tile 128 x 24 x 2 B.  Fine rgbnet (kp0 144, 4 x 256): 67,584 +
// 101,376 + 12,288 + 8,192 + 1,152 = 190,592 B; fine refnet (kp0 320,
// 3 x 256, 16): 83,968 + 101,376 + 12,288 + 8,192 + 2,560 + 6,144 =
// 214,528 B.  A dW block: 2 x 64 x (72 + 264) x 2 B = 86,016 B, two an
// SM.  Output widths past 256 are refused.
//
// What sets the pace on an H100 (PERF.md): the per-tile pass, about
// three quarters of B9, at ~13% of the bf16 peak.  No one part of it
// dominates: leaving out its tensor-core products, its input loads or
// its scratch stores each saves 13-18% of it.  One block an SM runs its
// loads, products, epilogues and barriers one after another.  64-sample
// tiles at two blocks an SM, 8 or 32 warps a block instead of 16, and
// 128-row dW slices were all slower.
//
// Registers, shared memory and spills: nvcc -Xptxas -v (build.py), read
// into PERF.md.  Sample indices are 64-bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // mma16816, pack2, ldmatrix fragments, cp.async

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
// B9: backward (per-tile pass, split-K dW kernel, fixed-order sums)
// ---------------------------------------------------------------------------

#define BT 128          // samples per tile of the per-tile pass
#define BNT 512         // threads of a per-tile block
#define WM 2            // warps along the samples; the rest along the columns
#define KC 64           // weight rows per staged chunk
#define NSTAGE 3        // staged chunks (two in flight beside the one in use)
#define NPASS 256       // most output columns of one product
#define SWS (NPASS + 8) // largest row stride of a staged chunk
#define SMALL_NP 16     // a last layer this narrow keeps its dW in registers
#define SZ 24           // row stride of that layer's dz tile (16 + 8)
#define WN (BNT / 32 / WM)                    // warps along the columns
#define MTW (BT / WM / 16)                    // 16-sample m-tiles a warp
#define NTW (NPASS / 8 / WN)                  // 8-column tiles a warp
#define MASK_WORDS (BT / 8 * (NPASS / 8) * 2) // ReLU mask words of a layer
#define SMALL_MT ((NPASS / 16 + BNT / 32 - 1) / (BNT / 32))  // its m-tiles a warp
#define DW_NT 256       // threads of a dW block (8 warps)
#define DW_ROWS 64      // weight rows of a dW slice
#define DW_CH 64        // samples per dW chunk
#define SA_DW 72        // row stride of a dW block's staged activation chunk

// The backward's scratch and partials, planned by the launcher.  Layers
// l < n_dwl go through the dW kernel: their input activations A_l
// ([mp][aw_l], X for l = 0, else H_l) and cotangents D_l ([mp][np_l],
// bf16 dz_l) are written to the scratch by the per-tile pass.  A last
// layer of SMALL_NP outputs (n_dwl = L - 1) keeps its dW in the per-tile
// pass's registers.
struct BwdPlan {
  bf16* a_s[MAXL];
  bf16* d_s[MAXL];
  int aw[MAXL];             // pad64(kp_l): the dW kernel's 64-row slices
  long long dw_off[MAXL];   // dW_l's offset in dwb and a part_dw row
  long long db_off[MAXL];   // db_l's offset in a part_t row
  long long mp;             // samples rounded up to BT
  long long n_dw;           // part_dw row: dW of the layers l < n_dwl
  long long n_t;            // part_t row: [small last dW][db_0 .. db_L-1]
  int n_dwl;
  int sa;                   // row stride of the per-tile activation tile
  int n_slices;             // dW slices: sum of aw_l / 64 over l < n_dwl
  int nr;                   // sample ranges of the dW kernel
};

struct BwdIo {
  const float* g;   // [d_out][M]
  float* dx;        // [cin8][M]
  float* part_t;    // [gridDim.x][n_t] of the per-tile pass
};

// One product of a tile: acc[BT][ncols] = act[BT][K] x B, where B's rows
// k are rows of a bf16 [K][ldb] array in device memory (columns n0 ..
// n0 + ncols).  FWD: layer l's forward (B = W_l [kp][np]); BWD: dh_l =
// dz_l W_l^T (B = W_l^T [np][kp]); DX: the same for l = 0, written as dx,
// in passes of NPASS columns.
enum { P_FWD = 0, P_BWD = 1, P_DX = 2 };
struct Prod {
  const bf16* B;
  int ldb, n0, ncols, K, kind, layer;
};

__device__ __forceinline__ int n_prods(const MlpArgs& a) {
  return 2 * (a.n_layers - 1) + (a.kp[0] + NPASS - 1) / NPASS;
}

// The tile's products in order: forward layers 0 .. L-2, backward layers
// L-1 .. 1, then the dx passes.
__device__ __forceinline__ Prod prod_at(const MlpArgs& a, int it) {
  const int L = a.n_layers;
  Prod p;
  p.n0 = 0;
  if (it < L - 1) {
    p.kind = P_FWD;
    p.layer = it;
    p.B = a.w[it];
    p.ldb = p.ncols = a.np[it];
    p.K = a.kp[it];
    return p;
  }
  it -= L - 1;
  if (it < L - 1) {
    const int l = L - 1 - it;
    p.kind = P_BWD;
    p.layer = l;
    p.B = a.wt[l];
    p.ldb = p.ncols = a.kp[l];
    p.K = a.np[l];
    return p;
  }
  it -= L - 1;
  p.kind = P_DX;
  p.layer = 0;
  p.B = a.wt[0];
  p.ldb = a.kp[0];
  p.n0 = it * NPASS;
  p.ncols = min(NPASS, a.kp[0] - p.n0);
  p.K = a.np[0];
  return p;
}

// Start the copy of chunk c of p's B rows into stage c % NSTAGE of WS;
// one cp.async group (empty past the last chunk).
__device__ __forceinline__ void issue_chunk(const Prod& p, int c, bf16* WS) {
  const int r0 = c * KC;
  if (r0 < p.K) {
    const int rows = min(KC, p.K - r0), cc = p.ncols >> 3, sw = p.ncols + 8;
    bf16* dst = WS + (c % NSTAGE) * (KC * SWS);
    const bf16* src = p.B + (long long)r0 * p.ldb + p.n0;
    for (int e = threadIdx.x; e < rows * cc; e += BNT) {
      const int r = e / cc, k = (e - r * cc) * 8;
      cp_async16(dst + r * sw + k, src + (long long)r * p.ldb + k);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void issue_first(const Prod& p, bf16* WS) {
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) issue_chunk(p, c, WS);
}

// acc = A[BT][K] (shared, stride sa) x p's B, streamed through WS chunk by
// chunk; chunks 0 .. NSTAGE-2 must be in flight (issue_first).  Warp w
// owns the MTW m-tiles from sample (w / WN) * (BT / WM) and the column
// tiles w % WN + WN j.  Ends with a barrier, after which WS and A are
// free.
__device__ __forceinline__ void tile_product(float (&acc)[MTW][NTW][4],
                                             const bf16* A, int sa,
                                             const Prod& p, bf16* WS) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp / WN) * (BT / WM), wn = warp % WN;
  const int ntiles = p.ncols >> 3, sw = p.ncols + 8;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
  const int nch = (p.K + KC - 1) / KC;
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    issue_chunk(p, c + NSTAGE - 1, WS);
    const bf16* ws = WS + (c % NSTAGE) * (KC * SWS);
    const int ks = min(KC, p.K - c * KC);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      if (kk < ks) {
        // A fragments of every m-tile, then each column tile's B fragment
        uint32_t af[MTW][4];
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt)
          frag_a(af[mt], A, sa, m0 + mt * 16, c * KC + kk, lane);
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          if (wn + WN * j < ntiles) {
            uint32_t b0, b1;
            frag_b_t(b0, b1, ws, sw, (wn + WN * j) * 8, kk, lane);
#pragma unroll
            for (int mt = 0; mt < MTW; ++mt) mma16816(acc[mt][j], af[mt], b0, b1);
          }
        }
      }
    }
  }
  __syncthreads();
}

// Mask word of (8-sample row block rb, column tile nt, column parity c):
// bit `lane` is the lane's element of that fragment position.
__device__ __forceinline__ int mask_word(int rb, int nt, int c) {
  return (rb * (NPASS / 8) + nt) * 2 + c;
}

// H = bf16(relu(acc + b)) over act (in place), and the bits z > 0 of the
// layer's pre-activations z into mk (the twin's mask, `zs[li] > 0`).
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[MTW][NTW][4],
                                             const Prod& p, const float* bias,
                                             bf16* act, int sa, uint32_t* mk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / WN) * (BT / WM), wn = warp % WN;
  const int ntiles = p.ncols >> 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = wn + WN * j;
    if (nt >= ntiles) continue;  // uniform across the warp
    const int n = nt * 8 + 2 * t;
    const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = m0 + mt * 16 + 8 * h + g;
        const float z0 = acc[mt][j][2 * h] + b0, z1 = acc[mt][j][2 * h + 1] + b1;
        *reinterpret_cast<uint32_t*>(act + s * sa + n) =
            pack2(__float2bfloat16_rn(fmaxf(z0, 0.0f)),
                  __float2bfloat16_rn(fmaxf(z1, 0.0f)));
        const uint32_t w0 = __ballot_sync(0xffffffffu, z0 > 0.0f);
        const uint32_t w1 = __ballot_sync(0xffffffffu, z1 > 0.0f);
        if (lane == 0) {
          const int rb = (m0 + mt * 16 + 8 * h) >> 3;
          mk[mask_word(rb, nt, 0)] = w0;
          mk[mask_word(rb, nt, 1)] = w1;
        }
      }
    }
  }
}

// dz = acc * (z > 0) as bf16 over act (in place); the fp32 dz summed over
// the warp's samples is added to db[n] by the lanes with g == 0 (each
// column of a warp row owned by one lane: no atomics).
__device__ __forceinline__ void bwd_epilogue(const float (&acc)[MTW][NTW][4],
                                             const Prod& p, bf16* act, int sa,
                                             const uint32_t* mk, float* db) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / WN) * (BT / WM), wn = warp % WN;
  const int ntiles = p.ncols >> 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = wn + WN * j;
    if (nt >= ntiles) continue;  // uniform across the warp
    const int n = nt * 8 + 2 * t;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = m0 + mt * 16 + 8 * h + g;
        const int rb = (m0 + mt * 16 + 8 * h) >> 3;
        const float d0 = (mk[mask_word(rb, nt, 0)] >> lane) & 1u
                             ? acc[mt][j][2 * h] : 0.0f;
        const float d1 = (mk[mask_word(rb, nt, 1)] >> lane) & 1u
                             ? acc[mt][j][2 * h + 1] : 0.0f;
        *reinterpret_cast<uint32_t*>(act + s * sa + n) =
            pack2(__float2bfloat16_rn(d0), __float2bfloat16_rn(d1));
        s0 += d0;
        s1 += d1;
      }
    }
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
    }
    if (g == 0) {
      db[n] += s0;
      db[n + 1] += s1;
    }
  }
}

// dx[i][s0 + s] = acc for the pass's columns i < cin8 and samples < M.
__device__ __forceinline__ void dx_epilogue(const float (&acc)[MTW][NTW][4],
                                            const Prod& p, float* dx,
                                            long long M, long long s0,
                                            int cin8) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / WN) * (BT / WM), wn = warp % WN;
  const int ntiles = p.ncols >> 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = wn + WN * j;
    if (nt >= ntiles) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = p.n0 + nt * 8 + 2 * t + c;
      if (i >= cin8) continue;
      float* row = dx + (long long)i * M + s0;
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = m0 + mt * 16 + 8 * h + g;
          if (s0 + s < M) row[s] = acc[mt][j][2 * h + c];
        }
      }
    }
  }
}

// Rows of channel-major f32 inputs -> a bf16 [BT][ncol] tile Z (stride
// sz): column pair (c, c + 1) reads rows src(c), src(c + 1) (null: zeros)
// at samples s0 .. s0 + BT - 1 (zeros past M).  Lane (q, s8) of warp w
// takes pair w * 4 + q (+ BNT / 8 k) and samples s8 + 8i: 32-byte row pieces
// in, conflict-free 4-byte shared stores out.  With db, the pair's f32
// sums over the tile are added to db[c], db[c + 1] (fixed order; one
// owning lane per pair).
template <class SRC>
__device__ __forceinline__ void load_rows(SRC src, int ncol, long long M,
                                          long long s0, bf16* Z, int sz,
                                          float* db) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3, s8 = lane >> 2;
  for (int p0 = warp * 4; p0 < ncol / 2; p0 += BNT / 8) {  // uniform
    const int c = 2 * (p0 + q);
    const float* r0 = src(c);
    const float* r1 = src(c + 1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll 4
    for (int i = 0; i < BT / 8; ++i) {
      const int s = s8 + 8 * i;
      const long long gs = s0 + s;
      const float v0 = (r0 && gs < M) ? __ldg(r0 + gs) : 0.0f;
      const float v1 = (r1 && gs < M) ? __ldg(r1 + gs) : 0.0f;
      sum0 += v0;
      sum1 += v1;
      *reinterpret_cast<uint32_t*>(Z + s * sz + c) =
          pack2(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    }
    if (db) {
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, m);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, m);
      }
      if (s8 == 0) {
        db[c] += sum0;
        db[c + 1] += sum1;
      }
    }
  }
}

// Copy a [BT][cols] bf16 tile (stride st) to device memory rows of
// `width` values (zeros past cols), in 16-byte pieces.
__device__ __forceinline__ void store_rows(const bf16* S, int st, int cols,
                                           int width, bf16* dst) {
  const int cc = width / 8;
  for (int e = threadIdx.x; e < BT * cc; e += BNT) {
    const int s = e / cc, c = (e - s * cc) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < cols) v = *reinterpret_cast<const uint4*>(S + s * st + c);
    *reinterpret_cast<uint4*>(dst + (long long)s * width + c) = v;
  }
}

// The per-tile pass.  Persistent: block b takes tiles b, b + gridDim.x, ..
// Per tile: X into the activation tile (stored as A_0), the forward
// layers 0 .. L-2 in place (each H stored as its A_l, its ReLU mask kept
// as bits), dz_L-1 = bf16(g) (stored as D_L-1, or into Z for a small
// last layer, whose dW is summed here), then the backward products in
// place (each dz stored as its D_l) and the dx passes.  Every product's
// weights stream through WS, the next product's first chunks loading
// during this one's epilogue.  At the end the block writes its row of
// part_t once: the small last layer's dW and every layer's bias sums.
__global__ void __launch_bounds__(BNT, 1)
fused_mlp_tile_bwd_kernel(MlpArgs a, BwdPlan pl, BwdIo r) {
  extern __shared__ __align__(16) unsigned char mlp_smem[];
  const int L = a.n_layers, kp0 = a.kp[0], sa = pl.sa;
  const bool small = pl.n_dwl < L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* act = reinterpret_cast<bf16*>(mlp_smem);   // [BT][sa]
  bf16* WS = act + BT * sa;                         // NSTAGE x [KC][SWS]
  bf16* Z = WS + NSTAGE * KC * SWS;                 // [BT][SZ] if small
  uint32_t* MK = reinterpret_cast<uint32_t*>(Z + (small ? BT * SZ : 0));
  float* DB = reinterpret_cast<float*>(MK + (L - 1) * MASK_WORDS);  // [WM][L][NPASS]
  const float** XR = reinterpret_cast<const float**>(DB + WM * L * NPASS);

  for (int e = threadIdx.x; e < WM * L * NPASS; e += BNT) DB[e] = 0.0f;
  for (int c = threadIdx.x; c < kp0; c += BNT) {
    const float* p = nullptr;
    for (int bi = 0; bi < a.n_blocks; ++bi)
      if (c >= a.blk_off[bi] && c < a.blk_off[bi] + a.blk_rows[bi])
        p = a.blk[bi] + (long long)(c - a.blk_off[bi]) * a.M;
    XR[c] = p;
  }
  // small last layer: W rows (warp + BNT / 32 i) * 16 .., 2 column tiles
  float dwl[SMALL_MT][2][4];
#pragma unroll
  for (int i = 0; i < SMALL_MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dwl[i][j][e] = 0.0f;

  const int nit = n_prods(a);
  const long long ntiles = pl.mp / BT;
  if (blockIdx.x < ntiles) issue_first(prod_at(a, 0), WS);
  __syncthreads();
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long s0 = tile * BT;
    load_rows([&](int c) { return XR[c]; }, kp0, a.M, s0, act, sa, nullptr);
    __syncthreads();
    if (pl.n_dwl > 0) store_rows(act, sa, kp0, pl.aw[0], pl.a_s[0] + s0 * pl.aw[0]);
    for (int it = 0; it < nit; ++it) {
      const Prod p = prod_at(a, it);
      const bool last = p.kind != P_FWD && p.layer == L - 1;
      if (p.kind != P_FWD && p.n0 == 0) {
        const int l = p.layer, np = a.np[l];
        float* dbl = DB + l * NPASS;
        const float* gl = r.g;
        const int d_out = a.d_out;
        auto grow = [&](int o) {
          return o < d_out ? gl + (long long)o * a.M : (const float*)nullptr;
        };
        if (last && small) {
          load_rows(grow, np, a.M, s0, Z, SZ, dbl);
          __syncthreads();
          // dW_L-1 += H^T dz over the tile: W rows as M, samples as K
#pragma unroll
          for (int i = 0; i < SMALL_MT; ++i) {
            const int mt = warp + (BNT / 32) * i;
            if (mt >= a.kp[l] / 16) continue;
#pragma unroll
            for (int k0 = 0; k0 < BT; k0 += 16) {
              uint32_t af[4], b0, b1;
              frag_a_t(af, act, sa, mt * 16, k0, lane);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                frag_b_t(b0, b1, Z, SZ, j * 8, k0, lane);
                mma16816(dwl[i][j], af, b0, b1);
              }
            }
          }
        } else if (last) {
          __syncthreads();  // the tile's last A rows are stored
          load_rows(grow, np, a.M, s0, act, sa, dbl);
          __syncthreads();
          store_rows(act, sa, np, np, pl.d_s[l] + s0 * np);
        } else {
          store_rows(act, sa, np, np, pl.d_s[l] + s0 * np);
        }
      }
      float acc[MTW][NTW][4];
      tile_product(acc, last && small ? Z : act, last && small ? SZ : sa, p,
                   WS);
      if (it + 1 < nit) issue_first(prod_at(a, it + 1), WS);
      else if (tile + gridDim.x < ntiles) issue_first(prod_at(a, 0), WS);
      if (p.kind == P_FWD) {
        const int l1 = p.layer + 1;
        fwd_epilogue(acc, p, a.b[p.layer], act, sa, MK + p.layer * MASK_WORDS);
        __syncthreads();
        if (l1 < pl.n_dwl)
          store_rows(act, sa, p.ncols, pl.aw[l1], pl.a_s[l1] + s0 * pl.aw[l1]);
      } else if (p.kind == P_BWD) {
        bwd_epilogue(acc, p, act, sa, MK + (p.layer - 1) * MASK_WORDS,
                     DB + ((warp / WN) * L + p.layer - 1) * NPASS);
        __syncthreads();
      } else {
        dx_epilogue(acc, p, r.dx, a.M, s0, a.cin8);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's row of part_t: [small dW [kp][SMALL_NP]][db_0 .. db_L-1]
  float* P = r.part_t + (long long)blockIdx.x * pl.n_t;
#pragma unroll
  for (int i = 0; i < SMALL_MT; ++i) {
    const int mt = warp + (BNT / 32) * i;
    if (!small || mt >= a.kp[L - 1] / 16) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = mt * 16 + g, n = j * 8 + 2 * t;
      *reinterpret_cast<float2*>(P + r * SMALL_NP + n) =
          make_float2(dwl[i][j][0], dwl[i][j][1]);
      *reinterpret_cast<float2*>(P + (r + 8) * SMALL_NP + n) =
          make_float2(dwl[i][j][2], dwl[i][j][3]);
    }
  }
  for (int e = threadIdx.x; e < L * NPASS; e += BNT) {
    const int l = e / NPASS, n = e - l * NPASS;
    float v = 0.0f;
#pragma unroll
    for (int h = 0; h < WM; ++h) v += DB[h * L * NPASS + e];
    if (n < a.np[l]) P[pl.db_off[l] + n] = v;
  }
}

// dW_l = A_l^T D_l as a split-K product: block (range, slice) owns the
// 64 weight rows of one slice of one layer and the samples of one of nr
// equal ranges, streams them through shared memory in DW_CH-sample
// chunks (cp.async, double-buffered), keeps its [64][np] slice in
// registers and writes it once into row `range` of part_dw.  The slices
// of one range are adjacent in launch order, so the D chunks that the
// slices of a layer share come from L2.
__global__ void __launch_bounds__(DW_NT, 2)
fused_mlp_dw_kernel(MlpArgs a, BwdPlan pl, float* __restrict__ part_dw) {
  extern __shared__ __align__(16) unsigned char mlp_smem[];
  bf16* As = reinterpret_cast<bf16*>(mlp_smem);  // 2 x [DW_CH][SA_DW]
  bf16* Ds = As + 2 * DW_CH * SA_DW;             // 2 x [DW_CH][SWS]
  const long long range = blockIdx.x / pl.n_slices;
  int i0 = (blockIdx.x % pl.n_slices) * DW_ROWS, l = 0;
  while (i0 >= pl.aw[l]) i0 -= pl.aw[l++];
  const int kp = a.kp[l], np = a.np[l], aw = pl.aw[l], sd = np + 8;
  const int ntiles = np >> 3;
  const bf16* A = pl.a_s[l] + i0;
  const bf16* D = pl.d_s[l];
  const long long nchunk = pl.mp / DW_CH;
  const long long c_begin = range * nchunk / pl.nr;
  const long long c_end = (range + 1) * nchunk / pl.nr;

  auto load = [&](long long c, int st) {
    bf16* as = As + st * DW_CH * SA_DW;
    bf16* ds = Ds + st * DW_CH * SWS;
    const long long s0 = c * DW_CH;
    for (int e = threadIdx.x; e < DW_CH * (DW_ROWS / 8); e += DW_NT) {
      const int s = e / (DW_ROWS / 8), k = (e % (DW_ROWS / 8)) * 8;
      cp_async16(as + s * SA_DW + k, A + (s0 + s) * aw + k);
    }
    const int cc = np >> 3;
    for (int e = threadIdx.x; e < DW_CH * cc; e += DW_NT) {
      const int s = e / cc, k = (e - s * cc) * 8;
      cp_async16(ds + s * sd + k, D + (s0 + s) * np + k);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
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
    const bf16* as = As + st * DW_CH * SA_DW;
    const bf16* ds = Ds + st * DW_CH * SWS;
#pragma unroll
    for (int k0 = 0; k0 < DW_CH; k0 += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) frag_a_t(af[mt], as, SA_DW, mt * 16, k0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (warp + 8 * j >= ntiles) continue;  // uniform across the warp
        uint32_t b0, b1;
        frag_b_t(b0, b1, ds, sd, (warp + 8 * j) * 8, k0, lane);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma16816(acc[mt][j], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* P = part_dw + range * pl.n_dw + pl.dw_off[l];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + mt * 16 + 8 * h + g;
      if (i >= kp) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (warp + 8 * j >= ntiles) continue;
        const int n = (warp + 8 * j) * 8 + 2 * t;
        *reinterpret_cast<float2*>(P + (long long)i * np + n) =
            make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
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

static int pad64(int r) { return (r + 63) / 64 * 64; }

// B9's plan for a call (the wrapper's bwd_plan mirrors it); scratch may
// be null to size it.  Returns the scratch's bf16 elements, or -1 for
// widths the kernels do not take (an output width past NPASS).
static long long plan_bwd(const int* kp, const int* np, int n_layers,
                          long long M, bf16* scratch, BwdPlan* p) {
  int npmax = 0;
  for (int l = 0; l < n_layers; ++l) npmax = npmax > np[l] ? npmax : np[l];
  if (npmax > NPASS) return -1;
  const int last = n_layers - 1;
  const bool small = np[last] == SMALL_NP && kp[last] <= NPASS;
  p->n_dwl = n_layers - (small ? 1 : 0);
  p->sa = (kp[0] > npmax ? kp[0] : npmax) + 8;
  p->mp = (M + BT - 1) / BT * BT;
  long long off = 0, dw = 0, db = small ? (long long)kp[last] * SMALL_NP : 0;
  p->n_slices = 0;
  for (int l = 0; l < n_layers; ++l) {
    p->a_s[l] = p->d_s[l] = nullptr;
    p->aw[l] = pad64(kp[l]);
    p->dw_off[l] = dw;
    dw += (long long)kp[l] * np[l];
    p->db_off[l] = db;
    db += np[l];
    if (l < p->n_dwl) {
      if (scratch) p->a_s[l] = scratch + off;
      off += p->mp * p->aw[l];
      if (scratch) p->d_s[l] = scratch + off;
      off += p->mp * np[l];
      p->n_slices += p->aw[l] / DW_ROWS;
    }
  }
  p->n_dw = small ? p->dw_off[last] : dw;
  p->n_t = db;
  return off;
}

// Dynamic shared memory of the per-tile pass's block.
static size_t tile_smem_bytes(const int* kp, const int* np, int n_layers) {
  BwdPlan p;
  if (plan_bwd(kp, np, n_layers, 0, nullptr, &p) < 0) return SIZE_MAX;
  const bool small = p.n_dwl < n_layers;
  return sizeof(bf16) * ((size_t)BT * p.sa + (size_t)NSTAGE * KC * SWS +
                         (small ? (size_t)BT * SZ : 0)) +
         sizeof(uint32_t) * (size_t)(n_layers - 1) * MASK_WORDS +
         sizeof(float) * WM * (size_t)n_layers * NPASS +
         sizeof(float*) * (size_t)kp[0];
}

static size_t dw_smem_bytes() {
  return sizeof(bf16) * 2 * (size_t)DW_CH * (SA_DW + SWS);
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
// Dynamic shared memory of a block (not a launcher; for reports and the
// wrapper's check): which 0 = B9's per-tile pass, 1 = its dW kernel.
extern "C" long long fused_mlp_bwd_smem_bytes(const int* kp, const int* np,
                                              int n_layers, int which) {
  if (n_layers < 1 || n_layers > MAXL) return -1;
  return which == 0 ? (long long)tile_smem_bytes(kp, np, n_layers)
                    : (long long)dw_smem_bytes();
}

template <class K>
static cudaError_t set_smem(K kern, size_t smem) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// scratch: bf16 [scratch_elems] (plan_bwd); part_t: fp32 [nblk][n_t];
// part_dw: fp32 [nr][n_dw]; dwb: fp32 [sum_l kp*np + sum_l np] receiving
// dW_l [kp][np] for every layer, then db_l, each the sum of its partials
// in block order.  Every partial element is written once: none is
// zeroed or read before the sums.
extern "C" int fused_mlp_bwd(const void* const* blk, const int* rows,
                             const int* offs, int n_blocks,
                             const void* const* wt, const void* const* w,
                             const void* const* bias, const int* kp,
                             const int* np, int n_layers, int cin8, int d_out,
                             long long M, const void* g, void* dx,
                             void* scratch, long long scratch_elems,
                             void* part_t, int nblk, void* part_dw, int nr,
                             void* dwb, void* stream) {
  MlpArgs a;
  int rc = make_args(&a, blk, rows, offs, n_blocks, wt, w, bias, kp, np,
                     n_layers, cin8, d_out, M);
  if (rc) return rc;
  BwdPlan pl;
  if (plan_bwd(kp, np, n_layers, M, (bf16*)scratch, &pl) != scratch_elems ||
      nblk < 1 || nr < 1)
    return (int)cudaErrorInvalidValue;
  pl.nr = nr;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = tile_smem_bytes(kp, np, n_layers);
  cudaError_t err = set_smem(fused_mlp_tile_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  BwdIo r;
  r.g = (const float*)g;
  r.dx = (float*)dx;
  r.part_t = (float*)part_t;
  fused_mlp_tile_bwd_kernel<<<nblk, BNT, smem, st>>>(a, pl, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (pl.n_slices > 0) {
    err = set_smem(fused_mlp_dw_kernel, dw_smem_bytes());
    if (err != cudaSuccess) return (int)err;
    fused_mlp_dw_kernel<<<pl.n_slices * nr, DW_NT, dw_smem_bytes(), st>>>(
        a, pl, (float*)part_dw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mlp_reduce_partials_kernel<<<(unsigned)((pl.n_dw + 255) / 256), 256, 0,
                                 st>>>((const float*)part_dw, nr, pl.n_dw,
                                       (float*)dwb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  mlp_reduce_partials_kernel<<<(unsigned)((pl.n_t + 255) / 256), 256, 0, st>>>(
      (const float*)part_t, nblk, pl.n_t, (float*)dwb + pl.n_dw);
  return (int)cudaGetLastError();
}
