"""Kernel B2: deterministic dense accumulate (the backward of B1).

Replaces ``fgs_nerf_tpu/ops/pallas/scatter_combine_cm.py:182``
(``dense_accumulate_cm_pallas``); the CUDA source is
``csrc/scatter_combine_cm.cu`` with ``csrc/sorted_runs.cuh`` (design and
bound in its header: a block per tile of 512 output rows finds its
samples with two searches of the stream, stages them in shared memory
(a dense tile in several passes) and writes all 4C channels of its rows
with vector stores; runs in sample order; long runs through
deterministic block sums; no atomics and no per-row scratch;
bytes-bound, >= 2.0 ms on an H100 at the fine bench shape).  The plain
twin ports the JAX reference ``scatter_combine_cm.py:261-275``.  The
output is always float32: the JAX package's bf16 flush (past 2 GiB)
exists only on its TPU path.
"""
from __future__ import annotations

import torch

from fgs_nerf_tpu_torch.ops.cuda.build import I32, I64, P, CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "dense_accumulate_cm", "scatter_combine_cm.cu",
    "fgs_nerf_tpu/ops/pallas/scatter_combine_cm.py:182",
    {"dense_accumulate_cm": (P, P, P, P, P, I32, I64, I64, P)},
)


CHUNK = 256  # samples per block sum (csrc/sorted_runs.cuh)
TILE_ROWS = 512  # output rows of a tile (csrc/scatter_combine_cm.cu)
STAGE_BYTES = 64 * 1024  # shared memory for a pass's samples (sorted_runs.cuh)
MAX_C = 128  # 8C (dz, channel) outputs per run total, one thread each


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
            or rows.shape != (m,) or not 1 <= c <= MAX_C or m >= 2**31
            or n_rows < 2
            or not (rows.is_cuda and w8.is_cuda and rows.is_contiguous()
                    and w8.is_contiguous() and g.is_contiguous())):
        raise ValueError("dense_accumulate_cm: expects contiguous CUDA "
                         "int32 rows [M], f32 w8 [8, M], f32 g [C, M] with "
                         f"1 <= C <= {MAX_C}, M < 2**31 and n_rows >= 2")
    out = torch.empty((4 * c, n_rows), dtype=torch.float32, device=g.device)
    block_sums = torch.empty((max(1, (m // CHUNK) * 8 * c),),
                             dtype=torch.float32, device=g.device)
    KERNEL.call("dense_accumulate_cm", rows.data_ptr(), w8.data_ptr(),
                g.data_ptr(), block_sums.data_ptr(), out.data_ptr(), c,
                n_rows, m, stream_ptr(g.device))
    return out
