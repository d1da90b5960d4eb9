"""Sort-based deterministic scatter-add for trilinear-gather backwards.

Port of ``fgs_nerf_tpu/ops/scatter.py:48-192`` on the JAX package's CPU
semantics: float32 updates, no z-fold and a float32 dense buffer (the
bf16 updates, the fold and the bf16 flush are memory valves of its TPU
path only).  One stable sort of the base-cell rows orders every corner's
updates, the ``[M, 8C]`` updates are gathered into that order, kernel B7
(``ops/cuda/scatter_combine.py``) accumulates them into the dense padded
row space, and eight shifted dense adds combine the corners.
"""
from __future__ import annotations

from typing import Tuple

import torch

from fgs_nerf_tpu_torch.device import to_device
from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7

CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))

# The call site of kernel B7 (``chip_smoke.py`` routes it to the plain
# twin to compare whole steps).
dense_accumulate = B7.dense_accumulate


def corner_scatter_grid_grad(i0: torch.Tensor, fracs: torch.Tensor,
                             g: torch.Tensor,
                             grid_shape: Tuple[int, int, int, int]
                             ) -> torch.Tensor:
    """Gradient of an 8-corner trilinear gather w.r.t. the grid
    (`ops/scatter.py:88-192`): i0 [M, 3] integer base cells, fracs
    [M, 3], g [M, C] f32 -> [X, Y, Z, C] f32.  Corners outside the grid
    contribute nothing (the zero-padding forward)."""
    x, y, z, c = grid_shape
    dev = g.device
    sizes = to_device((x, y, z), dev, torch.int64)
    offs = to_device(CORNERS, dev, torch.int64)
    # bases in a virtual (+2)-padded volume; bases outside [-1, size-1]
    # have no valid corner, so clipping them into range is harmless
    xp, yp, zp = x + 2, y + 2, z + 2
    i0 = i0.long()
    base_p = torch.minimum(torch.clamp(i0, min=-1), sizes - 1) + 1
    rows_base = (base_p[:, 0] * yp + base_p[:, 1]) * zp + base_p[:, 2]
    m = rows_base.shape[0]

    w8_cols = []
    for k, off in enumerate(CORNERS):
        ci = i0 + offs[k]
        inb = torch.all((ci >= 0) & (ci < sizes), dim=-1)
        w = ((fracs[:, 0] if off[0] else 1.0 - fracs[:, 0])
             * (fracs[:, 1] if off[1] else 1.0 - fracs[:, 1])
             * (fracs[:, 2] if off[2] else 1.0 - fracs[:, 2]))
        w8_cols.append(w * inb.to(w.dtype))
    w8 = torch.stack(w8_cols, dim=-1)  # [M, 8]
    upd_unsorted = (w8[:, :, None] * g[:, None, :]).reshape(m, 8 * c)
    del w8, w8_cols

    rows_s, order = torch.sort(rows_base, stable=True)
    upd_all = upd_unsorted[order]
    del upd_unsorted, order
    dense = dense_accumulate(rows_s.to(torch.int32).contiguous(), upd_all,
                             xp * yp * zp)
    del upd_all
    dense = dense.reshape(xp, yp, zp, 8 * c)
    # the contribution to node v from corner offset o comes from base
    # v - o, i.e. padded coord v - o + 1: eight shifted dense adds (in
    # place, into one buffer: the sums are the reference's)
    grid_grad = torch.zeros((x, y, z, c), dtype=torch.float32, device=dev)
    for k, (dx, dy, dz) in enumerate(CORNERS):
        sx, sy, sz = 1 - dx, 1 - dy, 1 - dz
        grid_grad.add_(dense[sx:sx + x, sy:sy + y, sz:sz + z,
                             k * c:(k + 1) * c])
    return grid_grad
