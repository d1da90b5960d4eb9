"""Total-variation regularizers: loss-form TV and the analytic
gradient-injection TV.

Port of ``fgs_nerf_tpu/ops/tv.py:26-147``.  Grids are [X, Y, Z, C].
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fgs_nerf_tpu_torch.ops.stencils import tv_smooth


def total_variation_loss(v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute difference over the three grid axes
    (`ops/tv.py:34-57`)."""
    dx = torch.abs(torch.diff(v, dim=0))
    dy = torch.abs(torch.diff(v, dim=1))
    dz = torch.abs(torch.diff(v, dim=2))
    if mask is not None:
        m = mask.to(v.dtype)
        num = ((dx * (m[1:] * m[:-1])).sum()
               + (dy * (m[:, 1:] * m[:, :-1])).sum()
               + (dz * (m[:, :, 1:] * m[:, :, :-1])).sum())
        return num / 3.0 / (m.sum() * v.shape[-1])
    return (dx.sum() + dy.sum() + dz.sum()) / 3.0 / v.sum()


def density_tv_loss(sdf, gradient, voxel_size: float, sdf_tv: float,
                    smooth_grad_tv: float,
                    nonempty_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``density_total_variation`` (`ops/tv.py:60-86`): SDF TV plus the
    deviation of the gradient field from its detached smoothed copy."""
    tv = torch.zeros((), dtype=sdf.dtype, device=sdf.device)
    if sdf_tv > 0:
        tv = tv + total_variation_loss(sdf, nonempty_mask) / 2.0 / voxel_size * sdf_tv
    if smooth_grad_tv > 0:
        smoothed = tv_smooth(gradient).detach()
        err = (smoothed - gradient) ** 2
        if nonempty_mask is not None:
            m = nonempty_mask.to(err.dtype)
            tv = tv + (err * m).sum() / (m.sum() * 3.0) * smooth_grad_tv
        else:
            tv = tv + err.mean() * smooth_grad_tv
    return tv


def k0_tv_loss(k0, nonempty_mask, k0_tv: float = 1.0) -> torch.Tensor:
    """``k0_total_variation`` (`ops/tv.py:89-95`)."""
    if k0_tv <= 0:
        return torch.zeros((), dtype=k0.dtype, device=k0.device)
    return k0_tv * total_variation_loss(k0, nonempty_mask)


def tv_grad(grid: torch.Tensor, grad: torch.Tensor, wx: float, wy: float,
            wz: float, dense_mode: bool,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Analytic TV gradient added to a parameter gradient
    (`ops/tv.py:98-140`): ``w/6 * clamp(v - v_neighbor, -1, 1)`` per
    existing neighbor; sparse mode updates only voxels with nonzero
    incoming grad; the mask multiplies by mask[center] * mask[neighbor]."""
    ws = (wx / 6.0, wy / 6.0, wz / 6.0)
    m = None if mask is None else mask.to(grid.dtype)
    tv = torch.zeros_like(grid)
    nd = grid.ndim
    for axis, w in enumerate(ws):
        n = grid.shape[axis]
        fwd = torch.clamp(grid.narrow(axis, 0, n - 1) - grid.narrow(axis, 1, n - 1),
                          -1.0, 1.0)
        if m is not None:
            fwd = fwd * (m.narrow(axis, 0, n - 1) * m.narrow(axis, 1, n - 1))
        pad_hi = [0] * (2 * nd)
        pad_lo = [0] * (2 * nd)
        pad_hi[2 * (nd - 1 - axis) + 1] = 1
        pad_lo[2 * (nd - 1 - axis)] = 1
        tv = tv + w * (F.pad(fwd, pad_hi) + F.pad(-fwd, pad_lo))
    if not dense_mode:
        tv = torch.where(grad != 0.0, tv, torch.zeros_like(tv))
    return grad + tv
