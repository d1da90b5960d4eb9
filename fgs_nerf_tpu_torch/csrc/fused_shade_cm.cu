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
// sincos chain rule (_enc_bwd, fused_mlp_cm.py:449-459).
//
// Hidden width 192 (the coarse refnet) or 128 (the geometry-searching
// refnet), one template instance each.
//
// Design.  A block of 256 threads walks tiles of 64 samples
// (persistent: one block per SM, launched with grid = #SMs).  The
// padded bf16 weights stay in shared memory for the block's life
// (128x192 + 192x192 + 192x8 values, ~126 KB with the bank padding), the
// encoded tile and the hidden activations of a tile live in shared
// memory too, and nothing but the raw inputs, the logits and the
// cotangents touches device memory.  Products run on CUDA cores with
// fp32 FMAs over bf16 values; every thread owns an 8-sample x (W/32)
// output tile.  Shared arrays keep a row stride of (columns + 2) bf16 so
// rows fall on distinct banks.
//
// dW/db are sums over all samples.  GPU blocks run in no order, so
// each block adds its tiles' contributions, in a fixed tile order, into
// its own slice of a partial buffer in device memory (each element owned
// by one thread: no atomics), and a second kernel sums the slices in
// block order.  The result is deterministic for a given grid size.
//
// Bound on an H100: operations.  The forward does 2 x (90x192 + 192x192
// + 192x3) = 109,440 flop per sample, 258 GFLOP at M = 2,359,296:
// >= 0.26 ms at 989 TFLOP/s bf16 (inputs and logits are ~0.25 GB,
// 0.08 ms).  The backward does about three times the operations:
// >= 0.78 ms.  This first kernel uses CUDA cores (67 TFLOP/s fp32), not
// the tensor cores, so it is far from that bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define TS 64      // samples per tile
#define NT 256     // threads per block
#define OUT8 8     // padded rows of the last layer

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

__device__ inline float bf(bf16 v) { return __bfloat162float(v); }
__device__ inline bf16 tobf(float v) { return __float2bfloat16_rn(v); }

__device__ inline float load_in(const float* p, int row, long long M,
                                long long s) {
  return s < M ? __ldg(p + (long long)row * M + s) : 0.0f;
}

// x[s] identity / sin / cos rows of one raw 3-vector (component-major
// frequency order: row j*pe + i holds f(v_j * 2^i)).
__device__ void enc3(bf16* xs, int o_id, int o_s, int o_c, const float* v,
                     int pe, long long M, long long s) {
  for (int j = 0; j < 3; ++j) {
    const float vj = load_in(v, j, M, s);
    xs[o_id + j] = tobf(vj);
    for (int i = 0; i < pe; ++i) {
      const float xf = vj * (float)(1 << i);
      xs[o_s + j * pe + i] = tobf(sinf(xf));
      xs[o_c + j * pe + i] = tobf(cosf(xf));
    }
  }
}

// Encoded tile X [TS][cin8 + 2] (pad rows zero).  Ends with a barrier.
__device__ void build_x(const ShadeIn& a, const Layout& L, long long s0,
                        bf16* X) {
  const int sx = L.cin8 + 2;
  for (int e = threadIdx.x; e < TS * sx; e += NT) X[e] = tobf(0.0f);
  __syncthreads();
  const int s = threadIdx.x % TS;
  const int q = threadIdx.x / TS;  // 4 work groups of one sample each
  const long long gs = s0 + s;
  bf16* xs = X + s * sx;
  if (q == 0) {
    for (int c = 0; c < a.k0_dim; ++c)
      xs[L.k0 + c] = tobf(load_in(a.k0, c, a.M, gs));
    for (int j = 0; j < 3; ++j)
      xs[L.nrm + j] = tobf(load_in(a.normal, j, a.M, gs));
  } else if (q == 1) {
    enc3(xs, L.xyz, L.xyz_s, L.xyz_c, a.xyz, a.pos_pe, a.M, gs);
  } else if (q == 2) {
    enc3(xs, L.refl, L.refl_s, L.refl_c, a.refl, a.ref_pe, a.M, gs);
  } else if (a.use_vd) {
    enc3(xs, L.vd, L.vd_s, L.vd_c, a.vd, a.view_pe, a.M, gs);
  }
  __syncthreads();
}

// Copy a dense [rows][cols] bf16 matrix into shared memory with row
// stride cols + 2.
__device__ void load_w(const bf16* src, int rows, int cols, bf16* dst) {
  const int st = cols + 2;
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols;
    dst[r * st + (e - r * cols)] = src[e];
  }
}

// H[s][o] = bf16(relu(sum_i X[s][i] W[i][o] + b[o])), o < OUT.
// Thread t owns outputs o0..o0+OUT/32-1 for samples (t & 7) + 8q.
template <int OUT>
__device__ void layer_relu(const bf16* W, int IN, const float* b,
                           const bf16* Xin, bf16* Hout) {
  constexpr int TO = OUT / 32;
  const int o0 = (threadIdx.x >> 3) * TO;
  const int sl = threadIdx.x & 7;
  const int sxi = IN + 2, swo = OUT + 2;
  float acc[8][TO];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[q][j] = 0.0f;
  for (int i = 0; i < IN; ++i) {
    float w[TO], x[8];
#pragma unroll
    for (int j = 0; j < TO; ++j) w[j] = bf(W[i * swo + o0 + j]);
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = bf(Xin[(sl + 8 * q) * sxi + i]);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int j = 0; j < TO; ++j) acc[q][j] = fmaf(x[q], w[j], acc[q][j]);
  }
#pragma unroll
  for (int j = 0; j < TO; ++j) {
    const float bj = __ldg(b + o0 + j);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      Hout[(sl + 8 * q) * swo + o0 + j] = tobf(fmaxf(acc[q][j] + bj, 0.0f));
  }
}

// ---------------------------------------------------------------------------
// B3: forward
// ---------------------------------------------------------------------------

template <int HID>
__global__ void __launch_bounds__(NT)
fused_shade_fwd_kernel(ShadeIn a, float* __restrict__ out, int d_out) {
  extern __shared__ __align__(16) unsigned char shade_smem[];
  const Layout L = make_layout(a.k0_dim, a.pos_pe, a.ref_pe, a.view_pe,
                               a.use_vd);
  const int cin8 = L.cin8;
  bf16* W0 = (bf16*)shade_smem;           // [cin8][HID + 2]
  bf16* W1 = W0 + cin8 * (HID + 2);       // [HID][HID + 2]
  bf16* W2 = W1 + HID * (HID + 2);        // [HID][OUT8 + 2]
  bf16* X = W2 + HID * (OUT8 + 2);        // [TS][cin8 + 2]
  bf16* H1 = X + TS * (cin8 + 2);         // [TS][HID + 2]
  bf16* H2 = H1 + TS * (HID + 2);         // [TS][HID + 2]
  load_w(a.w0, cin8, HID, W0);
  load_w(a.w1, HID, HID, W1);
  load_w(a.w2, HID, OUT8, W2);
  __syncthreads();

  const long long ntiles = (a.M + TS - 1) / TS;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long s0 = tile * TS;
    build_x(a, L, s0, X);
    layer_relu<HID>(W0, cin8, a.b0, X, H1);
    __syncthreads();
    layer_relu<HID>(W1, HID, a.b1, H1, H2);
    __syncthreads();
    // last layer: 8 (padded) outputs x 64 samples, 2 per thread
    const int o = threadIdx.x & 7;
    for (int q = 0; q < 2; ++q) {
      const int s = (threadIdx.x >> 3) + 32 * q;
      float acc = 0.0f;
      for (int i = 0; i < HID; ++i)
        acc = fmaf(bf(H2[s * (HID + 2) + i]), bf(W2[i * (OUT8 + 2) + o]), acc);
      if (o < d_out && s0 + s < a.M)
        out[(long long)o * a.M + s0 + s] = acc + __ldg(a.b2 + o);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// B4: backward
// ---------------------------------------------------------------------------

// P[i][o] += sum_s Dz[s][o] * Hin[s][i] over the tile (P in device
// memory, this block's slice; each element owned by one thread).
__device__ void dw_accum(const bf16* Dz, int OUTS, const bf16* Hin, int IN,
                         float* P) {
  const int noc = OUTS / 8;
  const int nchunk = (IN / 4) * noc;
  const int sd = OUTS + 2, sh = IN + 2;
  for (int c = threadIdx.x; c < nchunk; c += NT) {
    const int i0 = (c / noc) * 4;
    const int o0 = (c % noc) * 8;
    float acc[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.0f;
    for (int s = 0; s < TS; ++s) {
      float h[4], d[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] = bf(Hin[s * sh + i0 + k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = bf(Dz[s * sd + o0 + j]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[k][j] = fmaf(d[j], h[k], acc[k][j]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) P[(i0 + k) * OUTS + o0 + j] += acc[k][j];
  }
}

// dh[s][i] = sum_o W[i][o] Dz[s][o] for i < IN (IN a multiple of 32).
// Thread t owns i0..i0+IN/32-1 for samples (t & 7) + 8q; returns the
// sums in acc.
template <int TI>
__device__ void dh_tile(const bf16* W, int OUTS, const bf16* Dz,
                        float (&acc)[8][TI]) {
  const int i0 = (threadIdx.x >> 3) * TI;
  const int sl = threadIdx.x & 7;
  const int sw = OUTS + 2;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int j = 0; j < TI; ++j) acc[q][j] = 0.0f;
  for (int o = 0; o < OUTS; ++o) {
    float w[TI], d[8];
#pragma unroll
    for (int j = 0; j < TI; ++j) w[j] = bf(W[(i0 + j) * sw + o]);
#pragma unroll
    for (int q = 0; q < 8; ++q) d[q] = bf(Dz[(sl + 8 * q) * sw + o]);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int j = 0; j < TI; ++j) acc[q][j] = fmaf(w[j], d[q], acc[q][j]);
  }
}

// dz = dh * (H > 0) stored as bf16 into Dz_out [TS][HID + 2]; the fp32
// dz summed over the tile is added to Pdb[HID].  Ends with a barrier.
template <int HID>
__device__ void relu_bwd(const float (&acc)[8][HID / 32], const bf16* H,
                         bf16* Dz_out, float* dbpart, float* Pdb) {
  constexpr int TI = HID / 32;
  const int i0 = (threadIdx.x >> 3) * TI;
  const int sl = threadIdx.x & 7;
  const int st = HID + 2;
#pragma unroll
  for (int j = 0; j < TI; ++j) {
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int s = sl + 8 * q;
      // h = bf16(relu(z)) > 0 exactly when z > 0 (a positive z below
      // bf16's smallest subnormal, 2^-133, would be the only exception)
      const float dz = bf(H[s * st + i0 + j]) > 0.0f ? acc[q][j] : 0.0f;
      Dz_out[s * st + i0 + j] = tobf(dz);
      part += dz;
    }
    dbpart[sl * HID + i0 + j] = part;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HID; i += NT) {
    float sum = 0.0f;
    for (int k = 0; k < 8; ++k) sum += dbpart[k * HID + i];
    Pdb[i] += sum;
  }
  __syncthreads();
}

__device__ void enc3_bwd(const float* DX, int sx, int o_id, int o_s,
                         int o_c, const float* v, int pe, float* dv,
                         long long M, long long gs, int s) {
  if (gs >= M) return;
  for (int j = 0; j < 3; ++j) {
    const float vj = __ldg(v + (long long)j * M + gs);
    float acc = DX[s * sx + o_id + j];
    for (int i = 0; i < pe; ++i) {
      const float f = (float)(1 << i);
      const float xf = vj * f;
      const float t = __fsub_rn(__fmul_rn(cosf(xf), DX[s * sx + o_s + j * pe + i]),
                                __fmul_rn(sinf(xf), DX[s * sx + o_c + j * pe + i]));
      acc = __fadd_rn(acc, __fmul_rn(f, t));
    }
    dv[(long long)j * M + gs] = acc;
  }
}

struct ShadeGrad {
  const float* g;  // [d_out][M]
  float* d_k0;
  float* d_xyz;
  float* d_refl;
  float* d_normal;
  float* d_vd;
  float* part;     // [gridDim.x][n_part], zero on entry
  long long n_part;
};

template <int HID>
__global__ void __launch_bounds__(NT)
fused_shade_bwd_kernel(ShadeIn a, ShadeGrad r, int d_out) {
  extern __shared__ __align__(16) unsigned char shade_smem[];
  const Layout L = make_layout(a.k0_dim, a.pos_pe, a.ref_pe, a.view_pe,
                               a.use_vd);
  const int cin8 = L.cin8;
  float* dbpart = (float*)shade_smem;      // [8][HID]
  float* gt = dbpart + 8 * HID;             // [TS][OUT8]
  bf16* W0 = (bf16*)(gt + TS * OUT8);       // [cin8][HID + 2]
  bf16* W1 = W0 + cin8 * (HID + 2);         // [HID][HID + 2]
  bf16* W2 = W1 + HID * (HID + 2);          // [HID][OUT8 + 2]
  bf16* X = W2 + HID * (OUT8 + 2);          // [TS][cin8 + 2]
  bf16* Dz2 = X + TS * (cin8 + 2);          // [TS][OUT8 + 2]
  bf16* H2 = Dz2 + TS * (OUT8 + 2);         // [TS][HID + 2], later dz0
  bf16* H1 = H2 + TS * (HID + 2);           // [TS][HID + 2]
  bf16* A = H1 + TS * (HID + 2);            // [TS][HID + 2], dz1
  float* DX = (float*)H1;                   // [TS][cin8 + 1] over H1 and A

  float* P = r.part + (long long)blockIdx.x * r.n_part;
  float* Pw0 = P;
  float* Pw1 = Pw0 + cin8 * HID;
  float* Pw2 = Pw1 + HID * HID;
  float* Pb0 = Pw2 + HID * OUT8;
  float* Pb1 = Pb0 + HID;
  float* Pb2 = Pb1 + HID;

  load_w(a.w0, cin8, HID, W0);
  load_w(a.w1, HID, HID, W1);
  load_w(a.w2, HID, OUT8, W2);
  __syncthreads();

  constexpr int TI = HID / 32;
  const long long ntiles = (a.M + TS - 1) / TS;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long s0 = tile * TS;
    // forward recompute
    build_x(a, L, s0, X);
    layer_relu<HID>(W0, cin8, a.b0, X, H1);
    __syncthreads();
    layer_relu<HID>(W1, HID, a.b1, H1, H2);
    // last layer: dz = g (fp32; bf16 copy for the products)
    for (int e = threadIdx.x; e < TS * OUT8; e += NT) {
      const int s = e / OUT8, o = e - s * OUT8;
      const float gv = (o < d_out && s0 + s < a.M)
                           ? __ldg(r.g + (long long)o * a.M + s0 + s) : 0.0f;
      gt[e] = gv;
      Dz2[s * (OUT8 + 2) + o] = tobf(gv);
    }
    __syncthreads();
    if (threadIdx.x < OUT8) {
      float sum = 0.0f;
      for (int s = 0; s < TS; ++s) sum += gt[s * OUT8 + threadIdx.x];
      Pb2[threadIdx.x] += sum;
    }
    dw_accum(Dz2, OUT8, H2, HID, Pw2);
    {
      float acc[8][TI];
      dh_tile<TI>(W2, OUT8, Dz2, acc);
      relu_bwd<HID>(acc, H2, A, dbpart, Pb1);       // A = dz1
    }
    dw_accum(A, HID, H1, HID, Pw1);
    {
      float acc[8][TI];
      dh_tile<TI>(W1, HID, A, acc);
      relu_bwd<HID>(acc, H1, H2, dbpart, Pb0);      // H2 = dz0
    }
    dw_accum(H2, HID, X, cin8, Pw0);
    {
      // dx = W0 dz0 -> DX [TS][cin8 + 1] fp32; rows i = t/8 + 32j
      const int sx = cin8 + 1;
      const int sl = threadIdx.x & 7;
      for (int i = threadIdx.x >> 3; i < cin8; i += 32) {
        float acc[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
        for (int o = 0; o < HID; ++o) {
          const float w = bf(W0[i * (HID + 2) + o]);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[q] = fmaf(w, bf(H2[(sl + 8 * q) * (HID + 2) + o]), acc[q]);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) DX[(sl + 8 * q) * sx + i] = acc[q];
      }
    }
    __syncthreads();
    {
      const int sx = cin8 + 1;
      const int s = threadIdx.x % TS;
      const int q = threadIdx.x / TS;
      const long long gs = s0 + s;
      if (q == 0 && gs < a.M) {
        for (int c = 0; c < a.k0_dim; ++c)
          r.d_k0[(long long)c * a.M + gs] = DX[s * sx + L.k0 + c];
        for (int j = 0; j < 3; ++j)
          r.d_normal[(long long)j * a.M + gs] = DX[s * sx + L.nrm + j];
      } else if (q == 1) {
        enc3_bwd(DX, sx, L.xyz, L.xyz_s, L.xyz_c, a.xyz, a.pos_pe,
                 r.d_xyz, a.M, gs, s);
      } else if (q == 2) {
        enc3_bwd(DX, sx, L.refl, L.refl_s, L.refl_c, a.refl, a.ref_pe,
                 r.d_refl, a.M, gs, s);
      } else if (q == 3 && a.use_vd) {
        enc3_bwd(DX, sx, L.vd, L.vd_s, L.vd_c, a.vd, a.view_pe, r.d_vd,
                 a.M, gs, s);
      }
    }
    __syncthreads();
  }
}

// out[e] = sum_b part[b][e], in block order.
__global__ void reduce_partials_kernel(const float* __restrict__ part,
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
  void (*fwd)(ShadeIn, float*, int);
  void (*bwd)(ShadeIn, ShadeGrad, int);
};
static const ShadeKernels kShadeKernels[] = {
    {128, fused_shade_fwd_kernel<128>, fused_shade_bwd_kernel<128>},
    {192, fused_shade_fwd_kernel<192>, fused_shade_bwd_kernel<192>},
};

static const ShadeKernels* kernels_for(int hid) {
  for (const ShadeKernels& k : kShadeKernels)
    if (k.hid == hid) return &k;
  return nullptr;
}

static size_t fwd_smem_bytes(int cin8, int hid) {
  return sizeof(bf16) * ((size_t)cin8 * (hid + 2) + (size_t)hid * (hid + 2) +
                         (size_t)hid * (OUT8 + 2) + (size_t)TS * (cin8 + 2) +
                         2 * (size_t)TS * (hid + 2));
}

static size_t bwd_smem_bytes(int cin8, int hid) {
  return sizeof(float) * ((size_t)8 * hid + (size_t)TS * OUT8) +
         sizeof(bf16) * ((size_t)cin8 * (hid + 2) + (size_t)hid * (hid + 2) +
                         (size_t)hid * (OUT8 + 2) + (size_t)TS * (cin8 + 2) +
                         (size_t)TS * (OUT8 + 2) + 3 * (size_t)TS * (hid + 2));
}

static int check_dims(int cin8, int hid, int d_out, int k0_dim, int pos_pe,
                      int ref_pe, int view_pe, int use_vd) {
  const Layout L = make_layout(k0_dim, pos_pe, ref_pe, view_pe, use_vd);
  if (!kernels_for(hid) || L.cin8 != cin8 || cin8 > 128 || d_out < 1 ||
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
  const size_t smem = fwd_smem_bytes(cin8, hid);
  void (*kern)(ShadeIn, float*, int) = kernels_for(hid)->fwd;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ShadeIn a = make_in(k0, xyz, refl, normal, vd, w0, w1, w2, b0, b1, b2, M,
                      k0_dim, pos_pe, ref_pe, view_pe, use_vd, cin8);
  kern<<<nblk, NT, smem, (cudaStream_t)stream>>>(a, (float*)out, d_out);
  return (int)cudaGetLastError();
}

// part: zeroed fp32 scratch [nblk][n_part], n_part = cin8*hid + hid*hid +
// hid*8 + 2*hid + 8; dwb: fp32 [n_part] receiving the block-order sums.
extern "C" int fused_shade_bwd(
    const void* k0, const void* xyz, const void* refl, const void* normal,
    const void* vd, const void* w0, const void* w1, const void* w2,
    const void* b0, const void* b1, const void* b2, const void* g,
    void* d_k0, void* d_xyz, void* d_refl, void* d_normal, void* d_vd,
    void* part, void* dwb, long long M, int k0_dim, int pos_pe, int ref_pe,
    int view_pe, int use_vd, int cin8, int hid, int d_out, int nblk,
    void* stream) {
  int rc = check_dims(cin8, hid, d_out, k0_dim, pos_pe, ref_pe, view_pe,
                      use_vd);
  if (rc) return rc;
  const long long n_part = (long long)cin8 * hid + (long long)hid * hid +
                           (long long)hid * OUT8 + 2LL * hid + OUT8;
  cudaStream_t st = (cudaStream_t)stream;
  if (M > 0) {
    const size_t smem = bwd_smem_bytes(cin8, hid);
    void (*kern)(ShadeIn, ShadeGrad, int) = kernels_for(hid)->bwd;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ShadeIn a = make_in(k0, xyz, refl, normal, vd, w0, w1, w2, b0, b1, b2,
                        M, k0_dim, pos_pe, ref_pe, view_pe, use_vd, cin8);
    ShadeGrad r;
    r.g = (const float*)g;
    r.d_k0 = (float*)d_k0;
    r.d_xyz = (float*)d_xyz;
    r.d_refl = (float*)d_refl;
    r.d_normal = (float*)d_normal;
    r.d_vd = (float*)d_vd;
    r.part = (float*)part;
    r.n_part = n_part;
    kern<<<nblk, NT, smem, st>>>(a, r, d_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials_kernel<<<(unsigned)((n_part + 255) / 256), 256, 0, st>>>(
      (const float*)part, nblk, n_part, (float*)dwb);
  return (int)cudaGetLastError();
}
