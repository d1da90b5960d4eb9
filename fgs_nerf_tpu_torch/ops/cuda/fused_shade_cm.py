"""Kernels B3/B4: the fused coarse shading head, forward and backward.

Replaces ``fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:587``
(``fused_shade_cm_fwd_pallas``) and ``:620`` (``fused_shade_cm_bwd_pallas``);
the CUDA source is ``csrc/fused_shade_cm.cu`` (design and bound in its
header: bf16 tensor-core products (mma.sync) over 64-sample tiles in
persistent blocks that keep the bf16 weights in shared memory; the
backward writes each tile's bf16 X, H1, dz1, dz0 to a scratch buffer and
a split-K kernel forms dW0/dW1 from it, each block writing its slice
once, summed in block order; operations-bound, >= 0.30 ms forward and
>= 0.89 ms backward on an H100 at the coarse bench shape, padded).

The plain twins are the port of ``fused_shade_cm_reference``
(``fused_mlp_cm.py:562-580``) and of the TPU backward kernel's
arithmetic (``:483-559``: recompute, bf16 ``dz`` before both products,
fp32 bias sums, sincos chain rule of ``_enc_bwd``).  ``fused_shade_cm``
is the autograd entry point the model calls (``fused_mlp_cm.py:677``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from fgs_nerf_tpu_torch.ops.cuda.build import I32, I64, P, CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "fused_shade_cm", "fused_shade_cm.cu",
    "fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:587 and :620",
    {
        "fused_shade_fwd": (P,) * 12 + (I64,) + (I32,) * 9 + (P,),
        "fused_shade_bwd": (P,) * 20 + (I64,) + (I32,) * 9 + (P,),
    },
)

# hidden widths with a CUDA instance: kShadeKernels in the source, which
# also rejects any other width
KERNEL_HIDDENS = (128, 192)
# padded input rows of the CUDA kernels (MAXROW in the source): the DTU
# coarse head (k0 12, pe 5 / 5 / 3, viewdir) has 144
MAX_CIN8 = 144
OUT8 = 8
TILE = 64  # samples per tile of the CUDA kernels


def bwd_scratch_elems(m: int, cin8: int, hid: int) -> int:
    """bf16 values of B4's scratch: X (width cin8 rounded up to 64), H1,
    dz1 and dz0 for ``m`` samples rounded up to a whole tile."""
    mp = -(-m // TILE) * TILE
    return mp * (-(-cin8 // 64) * 64 + 3 * hid)


def pad8(r: int) -> int:
    return (r + 7) // 8 * 8


def pad_plan(block_rows: Sequence[int]) -> Tuple[Tuple[int, ...], int]:
    """(8-aligned offsets, padded total rows) (`fused_mlp_cm.py:46-53`)."""
    offs, o = [], 0
    for r in block_rows:
        offs.append(o)
        o += pad8(r)
    return tuple(offs), o


def shade_layout(k0_dim, pos_pe, ref_pe, view_pe, use_viewdir):
    """Unpadded row sizes of the refnet input, in reference order
    (`fused_mlp_cm.py:406-413`)."""
    rows = [k0_dim, 3, 3 * pos_pe, 3 * pos_pe, 3, 3 * ref_pe, 3 * ref_pe, 3]
    if use_viewdir:
        rows += [3, 3 * view_pe, 3 * view_pe]
    return tuple(rows)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to the input's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _enc_sub(v: torch.Tensor, pe: int):
    """[3, M] -> (identity, sin, cos), rows j*pe + i (`fused_mlp_cm.py:416-424`)."""
    xf = torch.stack([v * (2.0**i) for i in range(pe)], dim=1).reshape(
        3 * pe, v.shape[-1])
    return v, torch.sin(xf), torch.cos(xf)


def build_shade_x(k0, xyz, refl, normal, vd, pos_pe, ref_pe, view_pe):
    """The padded encoded input [Cin8, M] as bf16-rounded f32
    (`fused_mlp_cm.py:427-446`)."""
    subs = [k0, *_enc_sub(xyz, pos_pe), *_enc_sub(refl, ref_pe), normal]
    if vd is not None:
        subs += list(_enc_sub(vd, view_pe))
    parts = []
    for v in subs:
        parts.append(bf16_round(v))
        pad = pad8(v.shape[0]) - v.shape[0]
        if pad:
            parts.append(v.new_zeros((pad, v.shape[-1])))
    return torch.cat(parts, dim=0)


def pad_weights(weights, biases, block_rows):
    """[in, out] weights -> padded [in8, out8] f32 list: layer 0's input
    rows move to the aligned offsets (zero rows between), the last
    layer's outputs pad to 8 (zero columns + zero bias).  Hidden widths
    must be multiples of 8 (`fused_mlp_cm.py:175-201`, not transposed)."""
    offs, cin8 = pad_plan(block_rows)
    w0 = weights[0]
    parts, src = [], 0
    for r, o in zip(block_rows, offs):
        parts.append(w0[src:src + r])
        if pad8(r) - r:
            parts.append(w0.new_zeros((pad8(r) - r, w0.shape[1])))
        src += r
    wps = [torch.cat(parts, dim=0)] + list(weights[1:])
    bps = list(biases)
    pad_out = pad8(weights[-1].shape[1]) - weights[-1].shape[1]
    if pad_out:
        wps[-1] = torch.nn.functional.pad(wps[-1], (0, pad_out))
        bps[-1] = torch.nn.functional.pad(bps[-1], (0, pad_out))
    return wps, bps


def _unpad_grads(dws, dbs, weights, block_rows):
    """Padded [in8, out8] dW / [out8] db -> shapes of the weights."""
    offs, _ = pad_plan(block_rows)
    d_out = weights[-1].shape[1]
    dws = list(dws)
    dbs = list(dbs)
    dws[0] = torch.cat([dws[0][o:o + r] for r, o in zip(block_rows, offs)],
                       dim=0)
    dws[-1] = dws[-1][:, :d_out]
    dbs[-1] = dbs[-1][:d_out]
    return dws, dbs


def _enc_bwd(v, pe, d_id, d_sin, d_cos):
    """Cotangent of a sincos block back to the raw [3, M] vector
    (`fused_mlp_cm.py:449-459`)."""
    m = v.shape[-1]
    ds = d_sin.reshape(3, pe, m)
    dc = d_cos.reshape(3, pe, m)
    out = d_id
    for i in range(pe):
        f = 2.0**i
        xf = v * f
        out = out + f * (torch.cos(xf) * ds[:, i] - torch.sin(xf) * dc[:, i])
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _as(ts, x):
    """The twins sum in the inputs' dtype, whatever the weights' is."""
    return [t.to(x.dtype) for t in ts]


def fused_shade_cm_fwd_plain(k0, xyz, refl, normal, vd, weights, biases,
                             pos_pe, ref_pe, view_pe) -> torch.Tensor:
    """Plain PyTorch B3: [3, M] pre-sigmoid logits."""
    x = build_shade_x(k0, xyz, refl, normal, vd, pos_pe, ref_pe, view_pe)
    rows = shade_layout(k0.shape[0], pos_pe, ref_pe, view_pe, vd is not None)
    wps, bps = pad_weights(_as(weights, x), _as(biases, x), rows)
    h = x
    n = len(wps)
    for li in range(n):
        z = bf16_round(wps[li]).T @ h + bps[li][:, None]
        h = z if li == n - 1 else bf16_round(torch.relu(z))
    return h[:weights[-1].shape[1]]


def fused_shade_cm_bwd_plain(k0, xyz, refl, normal, vd, weights, biases, g,
                             pos_pe, ref_pe, view_pe):
    """Plain PyTorch B4 -> (input cotangents (k0, xyz, refl, normal, vd
    or None), dW list, db list)."""
    x = build_shade_x(k0, xyz, refl, normal, vd, pos_pe, ref_pe, view_pe)
    rows = shade_layout(k0.shape[0], pos_pe, ref_pe, view_pe, vd is not None)
    offs, _ = pad_plan(rows)
    wps, bps = pad_weights(_as(weights, x), _as(biases, x), rows)
    w16 = [bf16_round(w) for w in wps]
    n = len(wps)
    zs, hs = [], [x]
    h = x
    for li in range(n):
        z = w16[li].T @ h + bps[li][:, None]
        zs.append(z)
        if li < n - 1:
            h = bf16_round(torch.relu(z))
            hs.append(h)
    dh = torch.nn.functional.pad(g, (0, 0, 0, wps[-1].shape[1] - g.shape[0]))
    dws, dbs = [None] * n, [None] * n
    for li in range(n - 1, -1, -1):
        dz = dh if li == n - 1 else dh * (zs[li] > 0)
        dz16 = bf16_round(dz)
        dws[li] = hs[li] @ dz16.T
        dbs[li] = dz.sum(dim=1)
        dh = w16[li] @ dz16
    dws, dbs = _unpad_grads(dws, dbs, weights, rows)

    def sub(j):
        return dh[offs[j]:offs[j] + rows[j]]

    d_vd = None
    if vd is not None:
        d_vd = _enc_bwd(vd, view_pe, sub(8), sub(9), sub(10))
    d_ins = (sub(0), _enc_bwd(xyz, pos_pe, sub(1), sub(2), sub(3)),
             _enc_bwd(refl, ref_pe, sub(4), sub(5), sub(6)), sub(7), d_vd)
    return d_ins, dws, dbs


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_operands(k0, xyz, refl, normal, vd, weights, biases, pos_pe,
                     ref_pe, view_pe):
    rows = shade_layout(k0.shape[0], pos_pe, ref_pe, view_pe, vd is not None)
    _, cin8 = pad_plan(rows)
    hid = weights[0].shape[1]
    d_out = weights[-1].shape[1]
    if (len(weights) != 3 or hid not in KERNEL_HIDDENS
            or weights[1].shape != (hid, hid) or cin8 > MAX_CIN8
            or d_out > OUT8):
        raise ValueError(
            f"fused_shade_cm kernel: supports a 3-layer refnet of width "
            f"{KERNEL_HIDDENS} with <= {MAX_CIN8} padded inputs and <= 8 "
            f"outputs; "
            f"got widths {[tuple(w.shape) for w in weights]}, cin8 {cin8}")
    ins = [k0, xyz, refl, normal] + ([vd] if vd is not None else [])
    m = k0.shape[-1]
    for t in ins:
        if (not t.is_cuda or t.dtype != torch.float32 or t.shape[-1] != m
                or not t.is_contiguous()):
            raise ValueError("fused_shade_cm kernel: inputs must be "
                             "contiguous CUDA f32 [rows, M]")
    wps, bps = pad_weights(weights, biases, rows)
    w16 = [w.to(torch.bfloat16).contiguous() for w in wps]
    b32 = [b.to(torch.float32).contiguous() for b in bps]
    nblk = torch.cuda.get_device_properties(k0.device).multi_processor_count
    nblk = max(1, min(nblk, -(-m // TILE)))
    scal = (m, k0.shape[0], pos_pe, ref_pe, view_pe, int(vd is not None),
            cin8, hid, d_out, nblk)
    ptrs = [t.data_ptr() for t in (k0, xyz, refl, normal)]
    ptrs.append(vd.data_ptr() if vd is not None else None)
    ptrs += [w.data_ptr() for w in w16] + [b.data_ptr() for b in b32]
    return rows, cin8, hid, d_out, nblk, scal, ptrs, (w16, b32)


def fused_shade_cm_fwd(k0, xyz, refl, normal, vd, weights, biases,
                       pos_pe, ref_pe, view_pe) -> torch.Tensor:
    """B3: [3, M] logits.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if not k0.is_cuda:
        return fused_shade_cm_fwd_plain(k0, xyz, refl, normal, vd, weights,
                                        biases, pos_pe, ref_pe, view_pe)
    _, _, _, d_out, _, scal, ptrs, keep = _kernel_operands(
        k0, xyz, refl, normal, vd, weights, biases, pos_pe, ref_pe, view_pe)
    out = torch.empty((d_out, k0.shape[-1]), dtype=torch.float32,
                      device=k0.device)
    KERNEL.call("fused_shade_fwd", *ptrs, out.data_ptr(), *scal,
                stream_ptr(k0.device))
    del keep
    return out


def fused_shade_cm_bwd(k0, xyz, refl, normal, vd, weights, biases, g,
                       pos_pe, ref_pe, view_pe):
    """B4: (input cotangents, dW list, db list).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not k0.is_cuda:
        return fused_shade_cm_bwd_plain(k0, xyz, refl, normal, vd, weights,
                                        biases, g, pos_pe, ref_pe, view_pe)
    rows, cin8, hid, d_out, nblk, scal, ptrs, keep = _kernel_operands(
        k0, xyz, refl, normal, vd, weights, biases, pos_pe, ref_pe, view_pe)
    m = k0.shape[-1]
    g = g.contiguous()
    if g.shape != (d_out, m) or g.dtype != torch.float32:
        raise ValueError("fused_shade_cm_bwd: g must be f32 [d_out, M]")
    dev = k0.device
    d_ins = [torch.empty_like(t) for t in (k0, xyz, refl, normal)]
    d_vd = torch.empty_like(vd) if vd is not None else None
    n_part = cin8 * hid + hid * hid + hid * OUT8 + 2 * hid + OUT8
    scratch = torch.empty((bwd_scratch_elems(m, cin8, hid),),
                          dtype=torch.bfloat16, device=dev)
    part = torch.zeros((nblk, n_part), dtype=torch.float32, device=dev)
    dwb = torch.empty((n_part,), dtype=torch.float32, device=dev)
    KERNEL.call(
        "fused_shade_bwd", *ptrs, g.data_ptr(),
        *[t.data_ptr() for t in d_ins],
        d_vd.data_ptr() if d_vd is not None else None, scratch.data_ptr(),
        part.data_ptr(), dwb.data_ptr(), *scal, stream_ptr(dev))
    del keep, scratch
    sizes = [cin8 * hid, hid * hid, hid * OUT8, hid, hid, OUT8]
    p0, p1, p2, q0, q1, q2 = torch.split(dwb, sizes)
    dws, dbs = _unpad_grads(
        [p0.view(cin8, hid), p1.view(hid, hid), p2.view(hid, OUT8)],
        [q0, q1, q2], weights, rows)
    return (*d_ins, d_vd), dws, dbs


# ---------------------------------------------------------------------------
# autograd entry point
# ---------------------------------------------------------------------------


class _FusedShade(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pe, n_layers, k0, xyz, refl, normal, vd, *wb):
        weights, biases = list(wb[:n_layers]), list(wb[n_layers:])
        ctx.pe = pe
        ctx.n_layers = n_layers
        ctx.has_vd = vd is not None
        ctx.save_for_backward(k0, xyz, refl, normal,
                              vd if vd is not None else k0, *wb)
        return fused_shade_cm_fwd(k0, xyz, refl, normal, vd, weights, biases,
                                  *pe)

    @staticmethod
    def backward(ctx, g):
        k0, xyz, refl, normal, vd, *wb = ctx.saved_tensors
        vd = vd if ctx.has_vd else None
        n = ctx.n_layers
        d_ins, dws, dbs = fused_shade_cm_bwd(
            k0, xyz, refl, normal, vd, wb[:n], wb[n:], g.contiguous(),
            *ctx.pe)
        return (None, None, *d_ins, *dws, *dbs)


def fused_shade_cm(k0, xyz, refl, normal, vd: Optional[torch.Tensor],
                   weights: List[torch.Tensor], biases: List[torch.Tensor],
                   pos_pe: int, ref_pe: int, view_pe: int) -> torch.Tensor:
    """The whole coarse shading head from raw channel-major inputs ->
    [3, M] pre-sigmoid logits (`fused_mlp_cm.py:677-726`).  ``vd`` may
    be None (use_viewdir=False); hidden widths must be multiples of 8."""
    return _FusedShade.apply((pos_pe, ref_pe, view_pe), len(weights), k0,
                             xyz, refl, normal, vd, *weights, *biases)
