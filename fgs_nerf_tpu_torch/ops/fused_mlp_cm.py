"""The fused channel-major MLP op (kernels B8/B9) and its plain twins.

Port of ``fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:42-389``:
``fused_mlp_cm(blocks, weights, biases, bs)`` runs a bf16 MLP (fp32 sums,
ReLU between layers, none after the last) over channel-major feature row
blocks ``[r_i, M]`` and returns ``[d_out, M]`` float32.  The blocks sit
at 8-aligned row offsets of the padded input (``pad_plan``), with zero
weight rows between them, and the last layer is padded to 8 outputs.

``fused_mlp_cm_fwd_plain`` is the port of ``fused_mlp_cm_reference``
(``:308-327``).  ``fused_mlp_cm_bwd_plain`` is the TPU backward kernel's
function (``_make_bwd_kernel``, ``:109-172``), not autodiff of the
reference: hiddens recomputed, each layer's ``dz`` rounded to bf16 before
its dW and its dx product, ``db`` summed from the fp32 ``dz`` (the JAX CPU
path differentiates the reference with fp32 cotangents, ``:374-381``, so
the two agree at bf16 scale, as for B4).  ``fused_mlp_cm_fwd`` /
``fused_mlp_cm_bwd`` take the twins for CPU tensors and launch B8 / B9
(``ops/cuda/fused_mlp_cm.py``) for CUDA tensors.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as K


def pad8(r: int) -> int:
    return (r + 7) // 8 * 8


def pad_plan(block_rows: Sequence[int]) -> Tuple[Tuple[int, ...], int]:
    """(8-aligned offsets, padded total rows) (`fused_mlp_cm.py:46-53`)."""
    offs, o = [], 0
    for r in block_rows:
        offs.append(o)
        o += pad8(r)
    return tuple(offs), o


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def build_x(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The padded input [Cin8, M]: bf16-rounded blocks at the aligned
    offsets, zero rows between (`fused_mlp_cm.py:56-70`)."""
    parts = []
    for b in blocks:
        parts.append(bf16_round(b))
        pad = pad8(b.shape[0]) - b.shape[0]
        if pad:
            parts.append(b.new_zeros((pad, b.shape[-1])))
    return torch.cat(parts, dim=0)


def pad_weights_t(weights, biases, block_rows):
    """[in, out] weights -> transposed padded [out(8), in] f32 list and
    [out(8)] biases: layer 0's columns move to the aligned offsets, the
    last layer's rows pad to 8 (`fused_mlp_cm.py:175-201`)."""
    offs, cin8 = pad_plan(block_rows)
    w0 = weights[0]
    w0p = w0.new_zeros((cin8, w0.shape[1]))
    src = 0
    for r, o in zip(block_rows, offs):
        w0p[o:o + r] = w0[src:src + r]
        src += r
    wts = [w0p.T] + [w.T for w in weights[1:]]
    bs = list(biases)
    pad_out = pad8(weights[-1].shape[1]) - weights[-1].shape[1]
    if pad_out:
        wts[-1] = torch.nn.functional.pad(wts[-1], (0, 0, 0, pad_out))
        bs[-1] = torch.nn.functional.pad(bs[-1], (0, pad_out))
    return wts, bs


def unpad_grads(dwts, dbs, weights, block_rows):
    """Padded transposed dW [out(8), in(8)] / db -> the shapes of the
    weights [in, out] and biases [out] (`fused_mlp_cm.py:204-225`)."""
    offs, _ = pad_plan(block_rows)
    d_out = weights[-1].shape[1]
    dws = []
    for li, w in enumerate(weights):
        dw = dwts[li][:w.shape[1], :].T
        if li == 0:
            dw = torch.cat([dw[o:o + r] for r, o in zip(block_rows, offs)],
                           dim=0)
        else:
            dw = dw[:w.shape[0]]
        dws.append(dw.contiguous())
    dbs = [db[:d_out] if li == len(weights) - 1 else db[:w.shape[1]]
           for li, (db, w) in enumerate(zip(dbs, weights))]
    return dws, dbs


def check_shapes(blocks, weights, biases, bs: int) -> None:
    """The op's preconditions (`fused_mlp_cm.py:335-343`)."""
    m = blocks[0].shape[-1]
    if any(b.ndim != 2 or b.shape[-1] != m for b in blocks):
        raise ValueError("fused_mlp_cm: blocks must be [r_i, M] with one M")
    if m % bs:
        raise ValueError(f"fused_mlp_cm: M={m} must be a multiple of bs={bs}")
    if weights[0].shape[0] != sum(b.shape[0] for b in blocks):
        raise ValueError("fused_mlp_cm: weights[0] rows must equal the "
                         "blocks' total rows")
    if any(w.shape[1] % 8 for w in weights[:-1]):
        raise ValueError("fused_mlp_cm: hidden widths must be multiples of 8")
    if len(biases) != len(weights):
        raise ValueError("fused_mlp_cm: one bias per layer")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _round_if(x: torch.Tensor, on: bool) -> torch.Tensor:
    return bf16_round(x) if on else x


def fused_mlp_cm_fwd_plain(blocks, weights, biases,
                           round_hidden: bool = True) -> torch.Tensor:
    """Plain PyTorch B8 -> [d_out, M] f32.  ``round_hidden=False`` keeps
    the hiddens in f32: a control that the kernel checks must reject."""
    x = build_x(blocks)
    wts, bs = pad_weights_t(weights, biases, [b.shape[0] for b in blocks])
    h = x
    n = len(wts)
    for li in range(n):
        z = bf16_round(wts[li]) @ h + bs[li][:, None]
        h = z if li == n - 1 else _round_if(torch.relu(z), round_hidden)
    return h[:weights[-1].shape[1]]


def fused_mlp_cm_bwd_plain(blocks, weights, biases, g,
                           round_hidden: bool = True, round_dz: bool = True):
    """Plain PyTorch B9 -> (dx_pad [Cin8, M] f32, dW list like
    weights, db list like biases).  ``round_hidden=False`` /
    ``round_dz=False`` drop the bf16 rounding of the hiddens / of each
    ``dz``: controls that the kernel checks must reject."""
    rows = [b.shape[0] for b in blocks]
    x = build_x(blocks)
    wts, bs = pad_weights_t(weights, biases, rows)
    w16 = [bf16_round(w) for w in wts]
    n = len(wts)
    zs, hs = [], [x]
    h = x
    for li in range(n):
        z = w16[li] @ h + bs[li][:, None]
        zs.append(z)
        if li < n - 1:
            h = _round_if(torch.relu(z), round_hidden)
            hs.append(h)
    dh = torch.nn.functional.pad(g, (0, 0, 0, wts[-1].shape[0] - g.shape[0]))
    dwts, dbs = [None] * n, [None] * n
    for li in range(n - 1, -1, -1):
        dz = dh if li == n - 1 else dh * (zs[li] > 0)
        dz16 = _round_if(dz, round_dz)
        dwts[li] = dz16 @ hs[li].T
        dbs[li] = dz.sum(dim=1)
        dh = w16[li].T @ dz16
    dws, dbs = unpad_grads(dwts, dbs, weights, rows)
    return dh, dws, dbs


# ---------------------------------------------------------------------------
# wrappers: plain twin on the CPU, kernel on the card
# ---------------------------------------------------------------------------


def fused_mlp_cm_fwd(blocks, weights, biases) -> torch.Tensor:
    """B8: [d_out, M] f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if not blocks[0].is_cuda:
        return fused_mlp_cm_fwd_plain(blocks, weights, biases)
    return K.launch_fwd(blocks, weights, biases)


def fused_mlp_cm_bwd(blocks, weights, biases, g):
    """B9: (dx_pad [Cin8, M], dW list, db list).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not blocks[0].is_cuda:
        return fused_mlp_cm_bwd_plain(blocks, weights, biases, g)
    rows = [b.shape[0] for b in blocks]
    dx, dwts, dbs = K.launch_bwd(blocks, weights, biases, g)
    dws, dbs = unpad_grads(dwts, dbs, weights, rows)
    return dx, dws, dbs


# ---------------------------------------------------------------------------
# autograd entry point
# ---------------------------------------------------------------------------


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n_blocks, n_layers, *tensors):
        ctx.n = (n_blocks, n_layers)
        ctx.save_for_backward(*tensors)
        blocks = tensors[:n_blocks]
        weights = tensors[n_blocks:n_blocks + n_layers]
        biases = tensors[n_blocks + n_layers:]
        return fused_mlp_cm_fwd(blocks, weights, biases)

    @staticmethod
    def backward(ctx, g):
        n_blocks, n_layers = ctx.n
        tensors = ctx.saved_tensors
        blocks = tensors[:n_blocks]
        weights = tensors[n_blocks:n_blocks + n_layers]
        biases = tensors[n_blocks + n_layers:]
        dx, dws, dbs = fused_mlp_cm_bwd(blocks, weights, biases, g.contiguous())
        offs, _ = pad_plan([b.shape[0] for b in blocks])
        dblocks = [dx[o:o + b.shape[0]] for b, o in zip(blocks, offs)]
        return (None, None, *dblocks, *dws, *dbs)


def fused_mlp_cm(blocks: Sequence[torch.Tensor], weights: List[torch.Tensor],
                 biases: List[torch.Tensor], bs: int = 1024) -> torch.Tensor:
    """bf16 MLP over channel-major feature row blocks -> [d_out, M] f32
    (`fused_mlp_cm.py:335-343`).  ``blocks``: [r_i, M] f32; ``weights``:
    [in, out] (layer 0's in = sum r_i); ``biases``: [out].  M must be a
    multiple of ``bs`` and hidden widths multiples of 8, as for the TPU
    kernel; the CUDA kernels tile the samples by 64 whatever ``bs``."""
    check_shapes(blocks, weights, biases, bs)
    return _FusedMLP.apply(len(blocks), len(weights), *blocks, *weights,
                           *biases)
