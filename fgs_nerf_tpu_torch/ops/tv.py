"""Total-variation regularizers: loss-form TV and the analytic
gradient-injection TV.

Port of ``fgs_nerf_tpu/ops/tv.py:26-147``.  Grids are [X, Y, Z, C].
With a ``mesh`` whose sp > 1 the grid is this rank's x-slab: each term
is summed over the slab with a one-plane halo (replicated past the
global edges, where a difference is then zero, as the dense op has no
pair there) and the sums are all-reduced over sp.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fgs_nerf_tpu_torch.ops.stencils import tv_smooth
from fgs_nerf_tpu_torch.parallel.spatial import (
    halo_exchange, sharded_stencil, sp_mesh, sum_over_sp,
)


def _sums(mesh, *xs):
    """Slab sums -> sums over the whole grid (one all-reduce)."""
    if mesh is None:
        return xs
    return sum_over_sp(torch.stack(xs), mesh).unbind(0)


def _right_halo(v, mesh):
    """The slab with its right neighbour's first plane appended (dense:
    the grid itself)."""
    if mesh is None:
        return v
    return halo_exchange(v, 1, mesh, edge="replicate")[1:]


def total_variation_loss(v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         mesh=None) -> torch.Tensor:
    """Mean absolute difference over the three grid axes
    (`ops/tv.py:34-57`)."""
    mesh = sp_mesh(mesh)
    dx = torch.abs(torch.diff(_right_halo(v, mesh), dim=0))
    dy = torch.abs(torch.diff(v, dim=1))
    dz = torch.abs(torch.diff(v, dim=2))
    if mask is not None:
        m = mask.to(v.dtype)
        mx = _right_halo(m, mesh)
        num = ((dx * (mx[1:] * mx[:-1])).sum()
               + (dy * (m[:, 1:] * m[:, :-1])).sum()
               + (dz * (m[:, :, 1:] * m[:, :, :-1])).sum())
        num, denom = _sums(mesh, num, m.sum() * v.shape[-1])
        return num / 3.0 / denom
    num, denom = _sums(mesh, dx.sum() + dy.sum() + dz.sum(), v.sum())
    return num / 3.0 / denom


def density_tv_loss(sdf, gradient, voxel_size: float, sdf_tv: float,
                    smooth_grad_tv: float,
                    nonempty_mask: Optional[torch.Tensor] = None,
                    mesh=None) -> torch.Tensor:
    """``density_total_variation`` (`ops/tv.py:60-86`): SDF TV plus the
    deviation of the gradient field from its detached smoothed copy."""
    mesh = sp_mesh(mesh)
    tv = torch.zeros((), dtype=sdf.dtype, device=sdf.device)
    if sdf_tv > 0:
        tv = tv + (total_variation_loss(sdf, nonempty_mask, mesh) / 2.0
                   / voxel_size * sdf_tv)
    if smooth_grad_tv > 0:
        if mesh is None:
            smoothed = tv_smooth(gradient).detach()
        else:
            smoothed = sharded_stencil(tv_smooth, gradient.detach(), 1, mesh)
        err = (smoothed - gradient) ** 2
        if nonempty_mask is not None:
            m = nonempty_mask.to(err.dtype)
            num, denom = _sums(mesh, (err * m).sum(), m.sum() * 3.0)
            tv = tv + num / denom * smooth_grad_tv
        elif mesh is None:
            tv = tv + err.mean() * smooth_grad_tv
        else:
            num, denom = _sums(mesh, err.sum(), torch.tensor(
                float(err.numel()), device=err.device))
            tv = tv + num / denom * smooth_grad_tv
    return tv


def k0_tv_loss(k0, nonempty_mask, k0_tv: float = 1.0, mesh=None) -> torch.Tensor:
    """``k0_total_variation`` (`ops/tv.py:89-95`)."""
    if k0_tv <= 0:
        return torch.zeros((), dtype=k0.dtype, device=k0.device)
    return k0_tv * total_variation_loss(k0, nonempty_mask, mesh)


def tv_grad(grid: torch.Tensor, grad: torch.Tensor, wx: float, wy: float,
            wz: float, dense_mode: bool,
            mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Analytic TV gradient added to a parameter gradient
    (`ops/tv.py:98-140`): ``w/6 * clamp(v - v_neighbor, -1, 1)`` per
    existing neighbor; sparse mode updates only voxels with nonzero
    incoming grad; the mask multiplies by mask[center] * mask[neighbor].
    On an x-slab (sp) it runs on the slab with a one-plane halo each
    side, replicated past the global edges (a zero difference there)."""
    mesh = sp_mesh(mesh)
    if mesh is not None:
        ext = halo_exchange(grid, 1, mesh, edge="replicate")
        m_ext = (None if mask is None
                 else halo_exchange(mask.to(grid.dtype), 1, mesh, "replicate"))
        tv = tv_grad(ext, torch.zeros_like(ext), wx, wy, wz, True, m_ext)
        tv = tv[1:1 + grid.shape[0]]
        if not dense_mode:
            tv = torch.where(grad != 0.0, tv, torch.zeros_like(tv))
        return grad + tv
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
