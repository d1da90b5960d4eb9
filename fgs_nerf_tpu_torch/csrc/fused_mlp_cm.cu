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
// Bounds on an H100 (989 TFLOP/s bf16, 3.35 TB/s), at the fine shading
// head's shapes (M = 1,048,576).  The rgbnet forward is 2 x (106 x 256 +
// 3 x 256 x 256) ~ 0.45 MFLOP a sample, 469 GFLOP, >= 0.474 ms of
// operations, and it moves 445 MB of fp32 input rows and 1,074 MB of fp32
// output, >= 0.453 ms of bytes; the refnet forward 0.446 ms of operations,
// 0.388 ms of bytes (1,288 MB in).  Both roofs are close, so B8 has to run
// its memory traffic under its products: done one after the other, the
// two take >= 0.93 / 0.83 ms.  The backward (hiddens recomputed, a dW and
// a dh product per layer) 1.27 TFLOP, >= 1.28 ms (refnet 1.32 TFLOP,
// >= 1.34 ms).
//
// B8 (fused_mlp_fwd_kernel): one persistent block an SM (grid = min(SMs,
// tiles)) walks 128-sample tiles with a producer warpgroup and two
// consumer warpgroups, each owning 64 of the tile's samples
// (setmaxnreg: 40 registers a producer thread, 232 a consumer thread).
// The products take the samples as M: D[64 samples x outputs] = X[64 x k]
// W[k x outputs] by wgmma (m64nNk16, N = the layer's outputs rounded up to
// 16, 32, 64, 128 or 256), both operands K-major in shared memory in the
// 32-byte swizzle layout: rows of 16 inputs (32 B) whose two 16-byte
// halves swap on rows 4-7 of every 8.  The weights come in that layout
// from the wrapper (16-input slabs [kp/16][np][16]); X and H are kept so
// ([k/16][128 samples][16]).  What the design does about the three
// limits of PR 4's first cut (64-sample tiles, B fragments read from L2
// by 4-byte loads, nothing overlapped):
//
// - Each weight byte serves 128 samples.  A chunk is at most 16 KB of a
//   layer's consecutive slabs (32 inputs of a 256-wide layer, the whole
//   256 x 16 last layer of the refnet); one producer thread copies every
//   tile's chunks in order, one bulk copy each (cp.async.bulk, the TMA
//   engine), into a ring of 2-7 stages, completing on an mbarrier, and
//   reuses a stage when both consumer warpgroups have released it on a
//   second mbarrier.  L2 -> shared weight bytes a call: tiles x the
//   padded net, 8,192 x 466,944 B = 3.83 GB (rgbnet) and 8,192 x 434,176
//   B = 3.56 GB (refnet), against ~7.6 / 7.1 GB of 4-byte fragment loads
//   in PR 4's kernel.  No padding byte crosses L2.
// - Memory runs beside the products.  A consumer warpgroup commits a
//   chunk's wgmmas and waits only for the chunk before (releasing its
//   stage).  The next tile's fp32 input rows load during the chunks of
//   layers 1 .. L-1 (layer 0 no longer reads X): at each chunk a warp
//   copies one unit (8 rows x 32 samples, 128 contiguous bytes a row) by
//   cp.async into a 1 KB staging slot (two a warp, 16 KB in all) and, one
//   chunk later, writes the unit before it to X as bf16 with stmatrix
//   .trans, which transposes it into X's layout without bank conflicts.
//   No register waits on the copies: loaded into registers instead, they
//   held up the fences that ptxas puts before each wgmma and cost ~0.6 ms
//   a call.  Units past those chunks (a one-layer net, 3 of 20 a warp at
//   the refnet) load at the tile's end.  The last layer's sums plus bias are
//   staged as fp32 rows of 64 samples in the warpgroup's half of H (free
//   once its products are done) and leave by bulk stores, 256 B a row,
//   which the TMA engine drains while the warpgroup starts the next tile
//   (a ragged tile, or M not a multiple of 4, stores from the registers
//   instead).  The warpgroups meet only on the ring: their barriers are
//   their own (named barriers: one a tile for X, two a hidden layer for
//   the in-place H, two a pass of the staged output).
// - The tensor cores: wgmma, both operands read from shared memory by the
//   tensor cores (no ldmatrix, no fragment registers), fp32 sums in
//   registers (128 a consumer thread).  ptxas serializes the wgmmas
//   (C7520: a fence it adds sits on a path it cannot prove uniform);
//   broadcasting the warp index from lane 0 lifts that but spills and
//   doubles the kernel's waits-and-epilogues skeleton, so the kernel
//   keeps threadIdx-derived indices.  Why wgmma and not mma.sync: the
//   same design on mma.sync with ldmatrix fragments (16 warps of 64
//   features x 32 samples) took 1.9 ms without any product, its fragment
//   loads and their address arithmetic issuing ~60 instructions a warp
//   for every 16-input slab; wgmma issues one (PERF.md, PR 12).
//
// What sets the pace (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, PR 12):
// the kernel takes 2.25 / 1.96 ms at the fine rgbnet / refnet (21% / 23%
// of the bound), the wrapper's weight layout 0.46 / 0.57 ms more a call.
// The skeleton of waits, barriers and epilogues alone takes ~1.2 ms, the
// serialized products add ~0.5-0.65 ms, the input copies and output
// stores ~0.1-0.25 ms.
//
// Shared memory of a B8 block (limit 232,448 B): 1,024 B to align, 1,024
// B of mbarriers, the ring stages x 16,384 B (as many as fit, at most 7),
// the input staging 16,384 B, X kp0 x 256 B, H (the widest hidden layer)
// x 256 B and an input row table of 8 B a row of kp0.  Fine rgbnet (kp0
// 144): 2,048 + 6 x 16,384 + 16,384 + 36,864 + 65,536 + 1,152 = 220,288 B;
// fine refnet (kp0 320): 2,048 + 3 x 16,384 + 16,384 + 81,920 + 65,536 +
// 2,560 = 217,600 B.  kp0 is at most 432 beside 256-wide hidden layers
// (two stages), 560 beside 128-wide ones.  Output widths past 256 are
// refused, as for B9.
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

#include <type_traits>

#include "mma_bf16.cuh"  // mma16816, pack2, ldmatrix fragments, cp.async

typedef __nv_bfloat16 bf16;

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
// B8: forward; persistent blocks, two consumer warpgroups (wgmma) on
// 128-sample tiles and a producer warp that streams each layer's weights
// once per tile by bulk copies
// ---------------------------------------------------------------------------

#define FT 128               // samples per tile
#define FGS 64               // samples of a consumer warpgroup (half the tile)
#define FGT 128              // threads of a consumer warpgroup
#define FNT (3 * FGT)        // threads: a producer and two consumer warpgroups
#define FRS 2                // staging slots a warp for its input units
#define FRAW (2 * FGT / 32 * FRS * 1024)  // bytes of the input staging
#define FACC 128             // fp32 accumulators a thread: 64 x 256 / 128
#define FSTAGE (32 * NPASS)  // bf16 elements of a ring stage (16,384 B)
#define FSLAB (FT * 16)      // bf16 elements of an X / H slab: 16 features
#define FST_MAX 7            // most ring stages
#define FMAXQ 96             // most weight chunks a tile
#define FALIGN 1024          // alignment of the ring, X and H (the swizzle)
#define FBAR 1024            // bytes for the mbarriers, before the ring

// The launcher's plan.  A tile's weight chunks, in order: layer l in
// chunks of kc[l] inputs (whole 16-input slabs, at most FSTAGE elements),
// chunk i copied from q_src[i] (q_bytes[i] bytes, contiguous).
struct FwdPlan {
  const bf16* q_src[FMAXQ];
  int q_bytes[FMAXQ];
  int kc[MAXL];
  int nq;         // chunks a tile
  int nst;        // ring stages
  int hmax;       // rows of H: the widest hidden layer (0 for one layer)
  int vec;        // M % 4 == 0 and 16-byte aligned rows: 16-byte loads/stores
  long long ntiles;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  The
// loop lives inside the asm, so the compiler sees no divergent branch
// before the wgmmas that follow.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy (the TMA engine) of `bytes` contiguous bytes into shared
// memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One bulk copy (the TMA engine) of `bytes` contiguous bytes from shared
// to device memory, in this thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory
// (READ) or completed.
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Barrier of one consumer warpgroup's 128 threads (named barriers 1, 2).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(FGT) : "memory");
}

// Make this thread's shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// wgmma descriptor of a K-major bf16 operand in shared memory laid out
// with the 32-byte swizzle: rows of 16 inputs (32 B) whose two 16-byte
// halves swap on rows 4-7 of every 8, 8-row groups 256 B apart (stride
// byte offset), layout type 3.  `p` lies on a 256-byte boundary of the
// swizzle pattern (the ring, X and H start on 1,024-byte boundaries).
__device__ __forceinline__ uint64_t desc_sw32(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N]: A and B K-major in shared memory,
// fp32 sums in the wgmma fragment layout (warp w of the warpgroup holds
// rows 16 w + g and + 8, columns 8 i + 2 t and + 1 in d[4 i .. 4 i + 3]).
__device__ __forceinline__ void wgmma_n16(float (&d)[FACC], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[FACC], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[FACC], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[FACC], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[FACC], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Pin the accumulators in their registers around a run of wgmmas, so the
// compiler moves none of them while the products are in flight.
__device__ __forceinline__ void fence_acc(float (&d)[FACC]) {
#pragma unroll
  for (int i = 0; i < FACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[FACC], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (N == 256) wgmma_n256(d, da, db, scale_d);
  else if constexpr (N == 128) wgmma_n128(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_n64(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_n32(d, da, db, scale_d);
  else wgmma_n16(d, da, db, scale_d);
}

// Copy 4 bytes to shared memory without registers (cp.async), filling
// zeros when n == 0 (no row, or a sample past M).
__device__ __forceinline__ void cp_async4z(void* dst, const void* src, uint32_t n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// Store four 8 x 8 bf16 matrices transposed (stmatrix .trans): lane 8 m +
// j gives the address of memory row j of matrix m, which receives column
// j of the matrix whose rows the lanes hold as in an mma fragment.
__device__ __forceinline__ void stsm_x4_t(void* p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          smem_addr(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// Input unit i of a warp: X rows 8 o .. 8 o + 7 (an octet) at 32 of its
// group's samples.  Lane (g, t) copies row 8 o + g at samples 8 m + 2 t,
// + 1 (m = 0 .. 3) into its 32 B of a staging slot (cp.async: 8 rows of
// 128 contiguous bytes a unit, no register waits on them); stmatrix
// .trans then writes the unit to X's slab layout, 16 B (8 features) a
// sample.
__device__ __forceinline__ void store_unit(bf16* X, int o, int r0, int lane,
                                           const float* v) {
  const float4 a = *reinterpret_cast<const float4*>(v);
  const float4 b = *reinterpret_cast<const float4*>(v + 4);
  const uint32_t w[4] = {pack2(__float2bfloat16_rn(a.x), __float2bfloat16_rn(a.y)),
                         pack2(__float2bfloat16_rn(a.z), __float2bfloat16_rn(a.w)),
                         pack2(__float2bfloat16_rn(b.x), __float2bfloat16_rn(b.y)),
                         pack2(__float2bfloat16_rn(b.z), __float2bfloat16_rn(b.w))};
  const int r = r0 + lane;  // memory row: sample r0 + 8 (lane / 8) + lane % 8
  stsm_x4_t(X + (o >> 1) * FSLAB + r * 16 + ((((o & 1) ^ ((r >> 2) & 1))) << 3), w);
}

// out[s .. s + 3] = v (samples past M left out).
__device__ __forceinline__ void store_out4(float* row, long long s, long long M,
                                           int vec, float4 v) {
  if (vec && s + 3 < M) {
    __stcs(reinterpret_cast<float4*>(row + s), v);
    return;
  }
  if (s < M) __stcs(row + s, v.x);
  if (s + 1 < M) __stcs(row + s + 1, v.y);
  if (s + 2 < M) __stcs(row + s + 2, v.z);
  if (s + 3 < M) __stcs(row + s + 3, v.w);
}

// Block b takes tiles b, b + gridDim.x, ...  Thread 0 (the producer
// warpgroup) copies every tile's weight chunks, in order, into the ring.
// Consumer warpgroup grp owns the tile's samples grp * 64 .. + 63; for
// each chunk of a layer it issues one wgmma a 16-input slab (M = its 64
// samples, N = the layer's outputs rounded up to 16, 32, 64, 128 or 256:
// the columns past them are never read), then writes the hidden layer
// back over H in place, or stores the last layer's sums plus bias.  Its
// warp's input unit i (kp0 / 16 of them a tile) is the octet of X rows
// u / 2 * 8 .. + 7 at 32 of its samples, u = 4 i + the warp's index in
// the warpgroup.
__global__ void __launch_bounds__(FNT, 1)
fused_mlp_fwd_kernel(MlpArgs a, const __grid_constant__ FwdPlan p,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char mlp_smem[];
  unsigned char* base = mlp_smem + ((FALIGN - (smem_addr(mlp_smem) & (FALIGN - 1))) &
                                    (FALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // [FST_MAX]
  uint64_t* empty = full + FST_MAX;                     // [FST_MAX]
  bf16* ring = reinterpret_cast<bf16*>(base + FBAR);    // nst x FSTAGE
  float* RAW = reinterpret_cast<float*>(ring + p.nst * FSTAGE);  // FRAW B
  bf16* X = reinterpret_cast<bf16*>(RAW) + FRAW / 2;    // kp0 / 16 slabs
  bf16* H = X + (a.kp[0] >> 4) * FSLAB;                 // hmax / 16 slabs
  const float** XR = reinterpret_cast<const float**>(H + (p.hmax >> 4) * FSLAB);

  const int L = a.n_layers, kp0 = a.kp[0], tid = threadIdx.x;
  // the warp's index broadcast from lane 0, so that the compiler knows
  // the role branch is uniform in the warp (the consumers index their
  // work from threadIdx: the header says why)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const long long M = a.M;
  const long long my_tiles =
      blockIdx.x < p.ntiles ? (p.ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < p.nst; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * FGT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < kp0 * FT / 2; e += FNT)
    reinterpret_cast<uint32_t*>(X)[e] = 0u;  // pad rows stay zero
  for (int c = tid; c < kp0; c += FNT) {
    const float* r = nullptr;
    for (int bi = 0; bi < a.n_blocks; ++bi)
      if (c >= a.blk_off[bi] && c < a.blk_off[bi] + a.blk_rows[bi])
        r = a.blk[bi] + (long long)(c - a.blk_off[bi]) * M;
    XR[c] = r;
  }
  __syncthreads();

  if (warp < FGT / 32) {  // the producer warpgroup: one lane copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const long long nchunks = my_tiles * p.nq;
      int st = 0, c = 0;
      uint32_t use = 0;  // rounds of the ring so far
      for (long long qi = 0; qi < nchunks; ++qi) {
        if (use > 0) mbar_wait(empty + st, (use - 1) & 1u);
        mbar_expect_tx(full + st, (uint32_t)p.q_bytes[c]);
        bulk_load(ring + st * FSTAGE, p.q_src[c], (uint32_t)p.q_bytes[c], full + st);
        if (++c == p.nq) c = 0;
        if (++st == p.nst) {
          st = 0;
          ++use;
        }
      }
    }
  } else {  // the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

    const int cw = tid >> 5;  // this warp, from threadIdx
    const int grp = (cw >> 2) - 1, tg = tid & (FGT - 1);
    const int g = lane >> 2, t = lane & 3;
    const int row0 = grp * FGS + (cw & 3) * 16 + g;  // the thread's D rows: + 0, + 8
    const int upt = kp0 >> 4;                          // input units a warp, a tile
    int S = 0;  // chunks of layers 1 .. L-1: the steps that prefetch X
    for (int l = 1; l < L; ++l) S += (a.kp[l] + p.kc[l] - 1) / p.kc[l];

    // unit i of this warp: octet o, tile samples r0 .. r0 + 31
    const int wq = cw & 3;
    auto unit = [&](int i, int& o, int& r0) {
      const int u = i * 4 + wq;
      o = u >> 1;
      r0 = grp * FGS + (u & 1) * 32;
    };
    auto live = [&](int o) {  // an octet with a real input row
      bool any = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) any |= XR[8 * o + j] != nullptr;
      return any;
    };
    float* raw = RAW + (grp * 4 + wq) * FRS * 256 + lane * 8;  // slot 0
    auto issue = [&](int i, long long s0, int sl) {  // one cp.async group
      int o, r0;
      unit(i, o, r0);
      const float* row = XR[8 * o + g];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long s = s0 + r0 + 8 * m + 2 * t + e;
          const bool ok = row != nullptr && s < M;
          cp_async4z(raw + sl * 256 + 2 * m + e, ok ? row + s : a.blk[0], ok ? 4u : 0u);
        }
    };
    auto put = [&](int i, int sl) {
      int o, r0;
      unit(i, o, r0);
      if (live(o)) store_unit(X, o, r0, lane, raw + sl * 256);
    };
    auto fill = [&](int i, long long s0) {  // copy and store unit i now
      issue(i, s0, 0);
      cp_async_commit();
      cp_async_wait<0>();
      put(i, 0);
    };
    if (my_tiles > 0)
      for (int i = 0; i < upt; ++i) fill(i, (long long)blockIdx.x * FT);
    fence_async_smem();

    float acc[FACC];
    int st = 0;
    uint32_t ph = 0;  // stage and phase parity of the chunk being consumed
    for (long long tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      const long long s0 = tile * FT, s1 = s0 + (long long)gridDim.x * FT;
      const bool has_next = s1 < M;
      group_sync(grp);  // X holds this tile's inputs; the group is done with H
      int k = 0;        // prefetch step
      for (int l = 0; l < L; ++l) {
        const bf16* A = (l == 0 ? X : H) + grp * FGS * 16;  // the group's rows
        const int kp = a.kp[l], np = a.np[l], kc = p.kc[l];
        // the layer's products, chunk by chunk, with one wgmma shape (N =
        // np rounded up to 16, 32, 64, 128 or 256: columns past np unused)
        auto products = [&](auto n_tag) {
          constexpr int N = decltype(n_tag)::value;
          int pend = -1;  // the stage of the chunk whose products are in flight
#pragma unroll
          for (int i = 0; i < FACC; ++i) acc[i] = 0.0f;
          fence_acc(acc);
          wgmma_fence();  // only wgmmas touch acc until the layer's last wait
          for (int k0 = 0; k0 < kp; k0 += kc) {
            mbar_wait(full + st, ph);
            if (l > 0) {
              if (has_next) {  // copy unit k; store the one copied FRS - 1 steps ago
                if (k < upt) issue(k, s1, k % FRS);
                cp_async_commit();
                cp_async_wait<FRS - 1>();
                const int kd = k - (FRS - 1);
                if (kd >= 0 && kd < upt) put(kd, kd % FRS);
              }
              ++k;
            }
            const bf16* ws = ring + st * FSTAGE;
            const int nslab = min(kc, kp - k0) >> 4;
            for (int j = 0; j < nslab; ++j) {
              const uint64_t da = desc_sw32(A + ((k0 >> 4) + j) * FSLAB);
              const uint64_t db = desc_sw32(ws + j * np * 16);
              const int sd = k0 + j > 0;
              wgmma_n<N>(acc, da, db, sd);
            }
            wgmma_commit();
            wgmma_wait<1>();  // the previous chunk's products are done
            if (pend >= 0 && lane == 0) mbar_arrive(empty + pend);
            pend = st;
            if (++st == p.nst) {
              st = 0;
              ph ^= 1u;
            }
          }
          wgmma_wait<0>();
          fence_acc(acc);
          if (lane == 0) mbar_arrive(empty + pend);
        };
        if (np > 128) products(std::integral_constant<int, 256>{});
        else if (np > 64) products(std::integral_constant<int, 128>{});
        else if (np > 32) products(std::integral_constant<int, 64>{});
        else if (np > 16) products(std::integral_constant<int, 32>{});
        else products(std::integral_constant<int, 16>{});
        const float* bias = a.b[l];
        if (l < L - 1) {
          bulk_wait<true>();  // the last tile's output stores have read H
          group_sync(grp);  // every warp's products of this layer are done
#pragma unroll
          for (int i = 0; i < FACC / 4; ++i) {
            if (8 * i >= np) continue;  // uniform
            const int f = 8 * i + 2 * t;
            const float b0 = __ldg(bias + f), b1 = __ldg(bias + f + 1);
            bf16* slab = H + (f >> 4) * FSLAB + (f & 7);
            const int hf = (f >> 3) & 1;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = row0 + 8 * h;
              *reinterpret_cast<uint32_t*>(slab + r * 16 + ((hf ^ ((r >> 2) & 1)) << 3)) =
                  pack2(__float2bfloat16_rn(fmaxf(acc[4 * i + 2 * h] + b0, 0.0f)),
                        __float2bfloat16_rn(fmaxf(acc[4 * i + 2 * h + 1] + b1, 0.0f)));
            }
          }
          fence_async_smem();
          group_sync(grp);  // H holds layer l + 1's input
        } else if (p.vec && p.hmax >= 16 && s0 + (grp + 1) * FGS <= M) {
          // the group's 64 rows of each H slab (2 KB) hold 8 output rows of
          // its 64 samples in fp32; as many rows as H gives a pass, each row
          // then written by one thread's bulk store of 256 B
          const int rows = p.hmax >> 1;
          unsigned char* stage = reinterpret_cast<unsigned char*>(H) + grp * FGS * 32;
          for (int base = 0; base < np; base += rows) {
            bulk_wait<true>();  // the pass before has been read
            group_sync(grp);    // and the group is done with H
#pragma unroll
            for (int i = 0; i < FACC / 4; ++i) {
              const int f = 8 * i + 2 * t;
              if (8 * i >= np || 8 * i < base || 8 * i >= base + rows) continue;  // uniform
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float bn = f + c < a.d_out ? __ldg(bias + f + c) : 0.0f;
                const int r = f + c - base;
                float* row = reinterpret_cast<float*>(stage + (r >> 3) * (FSLAB * 2) + (r & 7) * 256);
                row[row0 - grp * FGS] = acc[4 * i + c] + bn;
                row[row0 - grp * FGS + 8] = acc[4 * i + 2 + c] + bn;
              }
            }
            fence_async_smem();
            group_sync(grp);  // the pass is staged
            if (tg < rows && base + tg < a.d_out)
              bulk_store(out + (long long)(base + tg) * M + s0 + grp * FGS,
                         stage + (tg >> 3) * (FSLAB * 2) + (tg & 7) * 256, FGS * 4);
            bulk_commit();
          }
        } else {
          // lanes 4 g + t, g = 4 a + b: a 4 x 4 transpose over b (lane bits
          // 2, 3) leaves lane b with samples 4 a .. + 3 (+ 8 (b / 2)) of
          // feature 8 i + 2 t + b % 2
          const int b0s = (g & 1), b1s = (g >> 1) & 1;
          const int c = g & 1, hh = (g >> 1) & 1;
#pragma unroll
          for (int i = 0; i < FACC / 4; ++i) {
            if (8 * i >= np) continue;  // uniform
            const int f = 8 * i + 2 * t;
            const float bf0 = f < a.d_out ? __ldg(bias + f) : 0.0f;
            const float bf1 = f + 1 < a.d_out ? __ldg(bias + f + 1) : 0.0f;
            float r[4] = {acc[4 * i] + bf0, acc[4 * i + 1] + bf1,
                          acc[4 * i + 2] + bf0, acc[4 * i + 3] + bf1};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float y = __shfl_xor_sync(0xffffffffu, b1s ? r[e] : r[2 + e], 8);
              if (b1s) r[e] = y;
              else r[2 + e] = y;
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float y = __shfl_xor_sync(0xffffffffu, b0s ? r[2 * e] : r[2 * e + 1], 4);
              if (b0s) r[2 * e] = y;
              else r[2 * e + 1] = y;
            }
            const int fo = f + c;
            if (fo < a.d_out)
              store_out4(out + (long long)fo * M,
                         s0 + grp * FGS + (cw & 3) * 16 + 4 * (g >> 2) + 8 * hh, M,
                         p.vec, make_float4(r[0], r[1], r[2], r[3]));
          }
        }
      }
      if (has_next) {  // the rest of the next tile's X
        // the units copied at steps S - FRS + 1 .. S - 1 are still staged
        cp_async_wait<0>();
        for (int kk = max(S - (FRS - 1), 0); kk < min(S, upt); ++kk) put(kk, kk % FRS);
        if (upt > S) {
          if (L == 1) group_sync(grp);  // the group is done reading X
          for (int i = S; i < upt; ++i) fill(i, s1);
        }
        fence_async_smem();
      }
    }
    bulk_wait<false>();
  }
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

// B8's plan: the rows of H, each layer's chunk width and the dynamic
// shared memory (ring stages into nst); 0 for nets the kernel does not
// take (an output width past NPASS, fewer than two stages that fit).
static int fwd_hmax(const int* np, int n_layers) {
  int h = 0;
  for (int l = 0; l < n_layers - 1; ++l) h = h > np[l] ? h : np[l];
  return h;
}

static int fwd_kc(int kp, int np) {
  const int kc = FSTAGE / np / 16 * 16;
  return kc < kp ? kc : kp;
}

static size_t fwd_smem(const int* kp, const int* np, int n_layers, int* nst) {
  for (int l = 0; l < n_layers; ++l)
    if (np[l] > NPASS) return 0;
  const long long fixed = FALIGN + FBAR + FRAW +
                          2LL * FT * (kp[0] + fwd_hmax(np, n_layers)) +
                          (long long)sizeof(float*) * kp[0];
  const long long room = (SMEM_MAX - fixed) / (2 * FSTAGE);
  if (room < 2) return 0;
  const int n = room < FST_MAX ? (int)room : FST_MAX;
  if (nst) *nst = n;
  return (size_t)(fixed + 2LL * n * FSTAGE);
}

// Dynamic shared memory of a B8 block (for reports and the wrapper's
// check), or -1 for nets it does not take.
extern "C" long long fused_mlp_fwd_smem_bytes(const int* kp, const int* np,
                                              int n_layers) {
  if (n_layers < 1 || n_layers > MAXL) return -1;
  const size_t smem = fwd_smem(kp, np, n_layers, nullptr);
  return smem ? (long long)smem : -1;
}

// wt[l]: layer l's weights in the chunk layout ([kp/16][np][16] bf16
// slabs, 16-byte aligned); out: fp32 [d_out][M].
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
  FwdPlan p;
  const size_t smem = fwd_smem(kp, np, n_layers, &p.nst);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  p.hmax = fwd_hmax(np, n_layers);
  p.vec = M % 4 == 0 && (uintptr_t)out % 16 == 0;
  for (int i = 0; i < n_blocks; ++i)
    if ((uintptr_t)blk[i] % 16) p.vec = 0;
  p.nq = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int kc = fwd_kc(kp[l], np[l]);
    p.kc[l] = kc;
    if ((uintptr_t)wt[l] % 16) return (int)cudaErrorInvalidValue;
    for (int k0 = 0; k0 < kp[l]; k0 += kc) {
      if (p.nq == FMAXQ) return (int)cudaErrorInvalidValue;
      p.q_src[p.nq] = (const bf16*)wt[l] + (size_t)k0 * np[l];
      p.q_bytes[p.nq] = 2 * np[l] * (kc < kp[l] - k0 ? kc : kp[l] - k0);
      ++p.nq;
    }
  }
  p.ntiles = (M + FT - 1) / FT;
  if (M == 0) return (int)cudaGetLastError();
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem(fused_mlp_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = p.ntiles < n_sm ? p.ntiles : n_sm;
  fused_mlp_fwd_kernel<<<(unsigned)grid, FNT, smem, (cudaStream_t)stream>>>(
      a, p, (float*)out);
  return (int)cudaGetLastError();
}
