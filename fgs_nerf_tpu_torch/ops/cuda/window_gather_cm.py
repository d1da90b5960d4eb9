"""Kernel B1: trilinear serve of a row-sorted stream from the half pack.

Replaces ``fgs_nerf_tpu/ops/pallas/window_gather_cm.py:156``
(``sorted_window_gather_cm_pallas``); the CUDA source is
``csrc/window_gather_cm.cu`` (design and bound in its header: tiles of
``TILE`` sorted samples, each served from a shared-memory copy of its
pack window when the window fits the stage, else by gathers from device
memory; bytes-bound).  The plain twin is the port of the JAX reference
``window_gather_cm.py:204-215``.

``staged_tiles`` says from the rows alone which tiles take the staged
branch, with the kernel's own constants.
"""
from __future__ import annotations

import torch

from fgs_nerf_tpu_torch.ops.cuda.build import I32, I64, P, CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "window_gather_cm", "window_gather_cm.cu",
    "fgs_nerf_tpu/ops/pallas/window_gather_cm.py:156",
    {"window_gather_cm": (P, P, P, P, I32, I64, I64, P)},
)

TILE = 256  # samples of a tile (csrc/window_gather_cm.cu)
STAGE_FLOATS = 8192  # the stage, over the 4C pack rows (the same)


def stage_cols(c: int) -> int:
    """Pack columns the stage holds for C channels (``stage_cols``)."""
    return STAGE_FLOATS // (4 * c) // 4 * 4


def tile_windows(rows: torch.Tensor) -> torch.Tensor:
    """Pack columns each tile of ``TILE`` sorted samples stages: its window
    [rows[first], rows[last] + 1] widened to whole 16-byte chunks."""
    first = torch.arange(0, rows.numel(), TILE, device=rows.device)
    last = torch.clamp(first + TILE, max=rows.numel()) - 1
    return (rows[last].long() + 1 | 3) + 1 - rows[first].long() // 4 * 4


def staged_tiles(rows: torch.Tensor, c: int) -> torch.Tensor:
    """Whether each tile of the sorted ``rows`` takes the staged branch
    (its window fits the stage) on a pack of 16-byte aligned rows."""
    return tile_windows(rows) <= stage_cols(c)


def window_gather_cm_plain(pack: torch.Tensor, rows: torch.Tensor,
                           w8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [4C, Rp] pack, [M] rows, [8, M] w8 ->
    [C, M] f32 (`window_gather_cm.py:204-215`)."""
    c = pack.shape[0] // 4
    m = rows.shape[0]
    r = rows.long()
    v0 = pack[:, r].reshape(4, c, m)
    v1 = pack[:, r + 1].reshape(4, c, m)
    out = torch.zeros((c, m), dtype=torch.float32, device=pack.device)
    for k2 in range(4):
        out = out + v0[k2] * w8[2 * k2:2 * k2 + 1, :]
        out = out + v1[k2] * w8[2 * k2 + 1:2 * k2 + 2, :]
    return out


def window_gather_cm(pack: torch.Tensor, rows: torch.Tensor,
                     w8: torch.Tensor) -> torch.Tensor:
    """out[c, m] = sum_k w8[k, m] * pack[(k//2)*C + c, rows[m] + (k&1)].

    ``rows`` must be non-decreasing int32 with ``rows + 1 < Rp``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if not pack.is_cuda:
        return window_gather_cm_plain(pack, rows, w8)
    c4, rp = pack.shape
    m = rows.shape[0]
    if (pack.dtype != torch.float32 or w8.dtype != torch.float32
            or rows.dtype != torch.int32 or c4 % 4 or w8.shape != (8, m)
            or not (pack.is_contiguous() and rows.is_contiguous()
                    and w8.is_contiguous())
            or not (rows.is_cuda and w8.is_cuda)):
        raise ValueError("window_gather_cm: expects contiguous CUDA f32 "
                         "pack [4C, Rp], int32 rows [M], f32 w8 [8, M]")
    out = torch.empty((c4 // 4, m), dtype=torch.float32, device=pack.device)
    KERNEL.call("window_gather_cm", pack.data_ptr(), rows.data_ptr(),
                w8.data_ptr(), out.data_ptr(), c4 // 4, rp, m,
                stream_ptr(pack.device))
    return out
