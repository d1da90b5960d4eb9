"""Kernels B8/B9: the fused channel-major MLP, forward and backward.

Replaces ``fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:231``
(``fused_mlp_cm_fwd_pallas``) and ``:258`` (``fused_mlp_cm_bwd_pallas``);
the CUDA source is ``csrc/fused_mlp_cm.cu`` (design and bound in its
header: 64-sample tiles in shared memory, bf16 ``mma.sync`` tensor-core
products with B fragments from L2, deterministic per-block dW/db
partials; operations-bound).  The function, its plain twins and the
autograd op live in ``ops/fused_mlp_cm.py``; this module prepares the
kernels' operands (every dim padded to 16 with zeros, the weights in bf16
in both [out][in] and [in][out] order) and launches them.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from fgs_nerf_tpu_torch.ops.cuda.build import I32, I64, P, CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "fused_mlp_cm", "fused_mlp_cm.cu",
    "fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:231 and :258",
    {
        "fused_mlp_fwd": (P, P, P, I32, P, P, P, P, I32, I32, I32, I64, P, P),
        "fused_mlp_bwd": (P, P, P, I32, P, P, P, P, P, I32, I32, I32, I64,
                          P, P, P, P, I32, P),
    },
)

MAX_BLOCKS = 16
MAX_LAYERS = 8
TILE = 64
SMEM_MAX = 232448  # bytes of shared memory a block can use on an H100


def _pad16(r: int) -> int:
    return (r + 15) // 16 * 16


def _arr(ctype, values):
    return (ctype * len(values))(*values)


class _Operands:
    """The kernels' padded operands; keeps every tensor alive while the
    launch reads them."""

    def __init__(self, blocks, weights, biases, backward: bool):
        from fgs_nerf_tpu_torch.ops.fused_mlp_cm import pad_plan

        m = blocks[0].shape[-1]
        rows = [b.shape[0] for b in blocks]
        offs, cin8 = pad_plan(rows)
        if len(blocks) > MAX_BLOCKS or len(weights) > MAX_LAYERS:
            raise ValueError(f"fused_mlp_cm kernel: at most {MAX_BLOCKS} "
                             f"blocks and {MAX_LAYERS} layers")
        for b in blocks:
            if (not b.is_cuda or b.dtype != torch.float32
                    or not b.is_contiguous() or b.shape[-1] != m):
                raise ValueError("fused_mlp_cm kernel: blocks must be "
                                 "contiguous CUDA f32 [r_i, M]")
        self.blocks = blocks
        self.m, self.cin8, self.d_out = m, cin8, weights[-1].shape[1]
        self.kp, self.np_ = [], []
        self.wt, self.w, self.b = [], [], []
        for li, (w, bias) in enumerate(zip(weights, biases)):
            if li == 0:
                w_in = w.new_zeros((cin8, w.shape[1]))
                src = 0
                for r, o in zip(rows, offs):
                    w_in[o:o + r] = w[src:src + r]
                    src += r
            else:
                w_in = w
            kp, np_ = _pad16(w_in.shape[0]), _pad16(w_in.shape[1])
            wp = torch.nn.functional.pad(
                w_in.float(), (0, np_ - w_in.shape[1], 0, kp - w_in.shape[0]))
            self.kp.append(kp)
            self.np_.append(np_)
            self.wt.append(wp.T.contiguous().to(torch.bfloat16))
            if backward:
                self.w.append(wp.contiguous().to(torch.bfloat16))
            self.b.append(torch.nn.functional.pad(
                bias.float(), (0, np_ - bias.shape[0])).contiguous())
        smem = TILE * 2 * (self.kp[0] + 8)
        hid = [n + 8 for n in self.np_[:-1]]
        smem += (TILE * 2 * (sum(hid) + 2 * (max(self.np_) + 8)) if backward
                 else TILE * 2 * 2 * (max(hid, default=8)))
        if smem > SMEM_MAX:
            raise ValueError(
                f"fused_mlp_cm kernel: needs {smem} bytes of shared memory "
                f"for widths {[tuple(w.shape) for w in weights]}; the card "
                f"gives a block {SMEM_MAX}")
        self.ptr_blocks = _arr(ctypes.c_void_p, [b.data_ptr() for b in blocks])
        self.c_rows = _arr(ctypes.c_int, rows)
        self.c_offs = _arr(ctypes.c_int, offs)
        self.ptr_wt = _arr(ctypes.c_void_p, [t.data_ptr() for t in self.wt])
        self.ptr_w = (_arr(ctypes.c_void_p, [t.data_ptr() for t in self.w])
                      if backward else None)
        self.ptr_b = _arr(ctypes.c_void_p, [t.data_ptr() for t in self.b])
        self.c_kp = _arr(ctypes.c_int, self.kp)
        self.c_np = _arr(ctypes.c_int, self.np_)

    def head(self):
        return (ctypes.addressof(self.ptr_blocks), ctypes.addressof(self.c_rows),
                ctypes.addressof(self.c_offs), len(self.blocks))


def launch_fwd(blocks: Sequence[torch.Tensor], weights, biases) -> torch.Tensor:
    """Launch B8 -> [d_out, M] f32."""
    ops = _Operands(blocks, weights, biases, backward=False)
    dev = blocks[0].device
    out = torch.empty((ops.d_out, ops.m), dtype=torch.float32, device=dev)
    KERNEL.call("fused_mlp_fwd", *ops.head(), ctypes.addressof(ops.ptr_wt),
                ctypes.addressof(ops.ptr_b), ctypes.addressof(ops.c_kp),
                ctypes.addressof(ops.c_np), len(weights), ops.cin8, ops.d_out,
                ops.m, out.data_ptr(), stream_ptr(dev))
    return out


def launch_bwd(blocks, weights, biases, g: torch.Tensor):
    """Launch B9 -> (dx_pad [Cin8, M] f32, padded transposed dW list
    [np, kp], padded db list [np]); ``ops/fused_mlp_cm.py`` unpads."""
    ops = _Operands(blocks, weights, biases, backward=True)
    dev = blocks[0].device
    if (g.shape != (ops.d_out, ops.m) or g.dtype != torch.float32
            or not g.is_cuda or not g.is_contiguous()):
        raise ValueError("fused_mlp_cm_bwd: g must be contiguous CUDA f32 "
                         "[d_out, M]")
    dx = torch.empty((ops.cin8, ops.m), dtype=torch.float32, device=dev)
    sizes: List[int] = []
    for kp, np_ in zip(ops.kp, ops.np_):
        sizes += [np_ * kp, np_]
    n_part = sum(sizes)
    nblk = torch.cuda.get_device_properties(dev).multi_processor_count
    nblk = max(1, min(nblk, (ops.m + TILE - 1) // TILE))
    part = torch.zeros((nblk, n_part), dtype=torch.float32, device=dev)
    dwb = torch.empty((n_part,), dtype=torch.float32, device=dev)
    KERNEL.call("fused_mlp_bwd", *ops.head(), ctypes.addressof(ops.ptr_wt),
                ctypes.addressof(ops.ptr_w), ctypes.addressof(ops.ptr_b),
                ctypes.addressof(ops.c_kp), ctypes.addressof(ops.c_np),
                len(weights), ops.cin8, ops.d_out, ops.m, g.data_ptr(),
                dx.data_ptr(), part.data_ptr(), dwb.data_ptr(), nblk,
                stream_ptr(dev))
    del part
    pieces = torch.split(dwb, sizes)
    dwts = [pieces[2 * i].view(np_, kp)
            for i, (kp, np_) in enumerate(zip(ops.kp, ops.np_))]
    dbs = [pieces[2 * i + 1] for i in range(len(ops.kp))]
    return dx, dwts, dbs
