"""Kernel B7: deterministic row-major sorted scatter-add (the lattice
engine's grid-gradient accumulate).

Replaces ``fgs_nerf_tpu/ops/pallas/scatter_combine.py:118``
(``dense_accumulate_pallas``); the CUDA source is
``csrc/scatter_combine.cu`` with ``csrc/sorted_runs.cuh`` (design and
bound in its header: a block per tile of T rows finds its samples with
two searches of the stream, stages them in shared memory (a dense tile
in several passes) and writes the tile's contiguous [T, C] output with
float4 stores, each float the sum of its channel over its row's run in
sample order; long runs through deterministic block sums; no atomics
and no per-row scratch; bytes-bound).  The plain twin is the JAX CPU path
``ops/scatter.py:57-64``: ``index_add_`` over the sorted stream, which on
the CPU adds serially in operand order.  The output is always float32:
the JAX package's bf16 output (and the updates' bf16 cast) exist only
on its TPU path.
"""
from __future__ import annotations

import torch

from fgs_nerf_tpu_torch.ops.cuda.build import I32, I64, P, CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "dense_accumulate", "scatter_combine.cu",
    "fgs_nerf_tpu/ops/pallas/scatter_combine.py:118",
    {"dense_accumulate": (P, P, P, P, I32, I64, I64, P)},
)

CHUNK = 256  # samples per block sum (csrc/sorted_runs.cuh)
TILE_FLOATS = 16384  # output floats of a tile (csrc/scatter_combine.cu)
STAGE_BYTES = 64 * 1024  # shared memory for a pass's samples (sorted_runs.cuh)
MAX_C = 1024  # one thread per channel in a run total


def dense_accumulate_plain(rows: torch.Tensor, upd: torch.Tensor,
                           cap: int) -> torch.Tensor:
    """Plain PyTorch version -> [cap, C] f32."""
    return torch.zeros((cap, upd.shape[1]), dtype=torch.float32,
                       device=upd.device).index_add_(0, rows.long(),
                                                     upd.float())


def dense_accumulate(rows: torch.Tensor, upd: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """D[rows[s]] += upd[s] -> [cap, C] f32, every row written.

    ``rows`` must be non-decreasing int32 in [0, cap).  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if not upd.is_cuda:
        return dense_accumulate_plain(rows, upd, cap)
    m, c = upd.shape
    if (upd.dtype != torch.float32 or rows.dtype != torch.int32
            or rows.shape != (m,) or cap < 1 or m >= 2**31
            or not 1 <= c <= MAX_C
            or not (rows.is_cuda and rows.is_contiguous()
                    and upd.is_contiguous())):
        raise ValueError("dense_accumulate: expects contiguous CUDA int32 "
                         f"rows [M], f32 upd [M, C] with 1 <= C <= {MAX_C}, "
                         "M < 2**31 and cap >= 1")
    out = torch.empty((cap, c), dtype=torch.float32, device=upd.device)
    block_sums = torch.empty((max(1, (m // CHUNK) * c),), dtype=torch.float32,
                             device=upd.device)
    KERNEL.call("dense_accumulate", rows.data_ptr(), upd.data_ptr(),
                block_sums.data_ptr(), out.data_ptr(), c, cap, m,
                stream_ptr(upd.device))
    return out
