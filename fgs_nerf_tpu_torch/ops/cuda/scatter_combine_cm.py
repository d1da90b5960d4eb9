"""Kernel B2: deterministic dense accumulate (the backward of B1).

Replaces ``fgs_nerf_tpu/ops/pallas/scatter_combine_cm.py:182``
(``dense_accumulate_cm_pallas``); the CUDA source is
``csrc/scatter_combine_cm.cu`` (design and bound in its header: run
starts by binary search, one thread per (row, channel) summing its runs
in sample order, long runs through deterministic block sums, no
atomics; bytes-bound, >= 0.20 ms on an H100 at the coarse bench shape).  The plain twin ports the JAX reference
``scatter_combine_cm.py:261-275``.  The output is always float32: the
JAX package's bf16 flush (past 2 GiB) exists only on its TPU path.
"""
from __future__ import annotations

import torch

from fgs_nerf_tpu_torch.ops.cuda.build import I32, I64, P, CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "dense_accumulate_cm", "scatter_combine_cm.cu",
    "fgs_nerf_tpu/ops/pallas/scatter_combine_cm.py:182",
    {"dense_accumulate_cm": (P, P, P, P, P, P, I32, I64, I64, P)},
)


CHUNK = 256  # samples per block sum (csrc/scatter_combine_cm.cu)


def dense_updates(w8: torch.Tensor, g: torch.Tensor):
    """The dz = 0 / dz = 1 outer-product updates, each [4C, M]."""
    c, m = g.shape
    upd0 = (w8[0::2][:, None, :] * g[None, :, :]).reshape(4 * c, m)
    upd1 = (w8[1::2][:, None, :] * g[None, :, :]).reshape(4 * c, m)
    return upd0, upd1


def dense_accumulate_cm_plain(rows: torch.Tensor, w8: torch.Tensor,
                              g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version -> [4C, n_rows] f32: the dz = 0 updates
    scattered first, then the dz = 1 updates one row up."""
    upd0, upd1 = dense_updates(w8, g)
    r = rows.long()
    dense = torch.zeros((upd0.shape[0], n_rows), dtype=torch.float32,
                        device=g.device)
    dense.index_add_(1, r, upd0)
    dense.index_add_(1, r + 1, upd1)
    return dense


def dense_accumulate_cm(rows: torch.Tensor, w8: torch.Tensor,
                        g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """D[k2*C + c, row + dz] += w8[2*k2 + dz, s] * g[c, s] -> [4C, n_rows].

    ``rows`` must be non-decreasing int32 in [0, n_rows - 2].  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if not g.is_cuda:
        return dense_accumulate_cm_plain(rows, w8, g, n_rows)
    c, m = g.shape
    if (g.dtype != torch.float32 or w8.dtype != torch.float32
            or rows.dtype != torch.int32 or w8.shape != (8, m)
            or rows.shape != (m,)
            or not (rows.is_cuda and w8.is_cuda and rows.is_contiguous()
                    and w8.is_contiguous() and g.is_contiguous())):
        raise ValueError("dense_accumulate_cm: expects contiguous CUDA "
                         "int32 rows [M], f32 w8 [8, M], f32 g [C, M]")
    out = torch.empty((4 * c, n_rows), dtype=torch.float32, device=g.device)
    start = torch.empty((n_rows + 1,), dtype=torch.int32, device=g.device)
    chunk_sums = torch.empty((2 * 4 * c * (m // CHUNK),), dtype=torch.float32,
                             device=g.device)
    KERNEL.call("dense_accumulate_cm", rows.data_ptr(), w8.data_ptr(),
                g.data_ptr(), start.data_ptr(), chunk_sums.data_ptr(),
                out.data_ptr(), c, n_rows, m, stream_ptr(g.device))
    return out
