"""3-D stencil ops on voxel grids: gaussian smoothing, SDF gradients and
the smooth-gradient TV kernel.

Port of ``fgs_nerf_tpu/ops/stencils.py:17-187``.  Grids are
channel-last ``[X, Y, Z, C]``; replicate padding is ``mode='replicate'``.
Every stencil is a sum of shifted slices (separable where the JAX
package is separable), so no convolution runs and TF32 never applies.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _edge_pad(grid: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """Replicate-pad ``r`` planes on both sides of ``axis``."""
    n = grid.shape[axis]
    lo = grid.narrow(axis, 0, 1).expand(
        *[r if a == axis else s for a, s in enumerate(grid.shape)])
    hi = grid.narrow(axis, n - 1, 1).expand(
        *[r if a == axis else s for a, s in enumerate(grid.shape)])
    return torch.cat([lo, grid, hi], dim=axis)


def _conv1d_axis_edge(grid: torch.Tensor, k1d, axis: int) -> torch.Tensor:
    """Separable 1-D stencil along one axis with edge padding, as a
    shift-and-add (`ops/stencils.py:44-58`)."""
    r = len(k1d) // 2
    x = _edge_pad(grid, axis, r)
    n = grid.shape[axis]
    out = None
    for i, w in enumerate(k1d):
        term = float(w) * x.narrow(axis, i, n)
        out = term if out is None else out + term
    return out


def smooth_grid(grid: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Gaussian smoothing with replicate padding as three normalized 1-D
    passes (`ops/stencils.py:61-85`)."""
    if ksize <= 0:
        return grid
    r = np.arange(-(ksize // 2), ksize // 2 + 1, 1, dtype=np.float64)
    g1 = np.exp(-(r**2) / (2.0 * sigma**2))
    g1 = (g1 / g1.sum()).astype(np.float32)
    out = grid
    squeeze = grid.ndim == 4 and grid.shape[-1] == 1
    if squeeze:
        out = out[..., 0]
    for axis in range(3):
        out = _conv1d_axis_edge(out, g1, axis)
    return out[..., None] if squeeze else out


_BASE_KERNEL = np.asarray(
    [
        [[1, 2, 1], [2, 4, 2], [1, 2, 1]],
        [[2, 4, 2], [4, 8, 4], [2, 4, 2]],
        [[1, 2, 1], [2, 4, 2], [1, 2, 1]],
    ],
    np.float64,
)


def tv_smooth(grid: torch.Tensor) -> torch.Tensor:
    """The normalized 3x3x3 smooth-grad TV kernel as three [1,2,1]/4
    passes (`ops/stencils.py:105-114`)."""
    k1 = np.asarray([0.25, 0.5, 0.25], np.float32)
    out = grid
    for axis in range(3):
        out = _conv1d_axis_edge(out, k1, axis)
    return out


def sobel_gradient_kernels(voxel_size: float) -> np.ndarray:
    """The three 3x3x3 derivative kernels of ``init_gradient_conv``
    (`ops/stencils.py:117-131`) as [3, 3, 3, 3]."""
    kernel1 = _BASE_KERNEL / (_BASE_KERNEL[0].sum() * 2.0 * voxel_size)
    out = np.stack([kernel1.copy() for _ in range(3)])
    out[0][1, :, :] *= 0.0
    out[0][0, :, :] *= -1.0
    out[1][:, 1, :] *= 0.0
    out[1][:, 0, :] *= -1.0
    out[2][:, :, 1] *= 0.0
    out[2][:, :, 0] *= -1.0
    return out.astype(np.float32)


def _stencil3_edge(s: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """[X, Y, Z] correlation with a 3x3x3 kernel, replicate padding,
    as a sum of its nonzero shifted slices."""
    p = s
    for axis in range(3):
        p = _edge_pad(p, axis, 1)
    x, y, z = s.shape
    out = None
    for i, j, l in zip(*np.nonzero(k)):
        term = float(k[i, j, l]) * p[i:i + x, j:j + y, l:l + z]
        out = term if out is None else out + term
    return out


def _sdf_gradient_axes(s: torch.Tensor, voxel_size: float, mode: str):
    """(gx, gy, gz) volumes of a [X, Y, Z] SDF (`ops/stencils.py:134-161`)."""
    if mode == "interpolate":
        inv = 1.0 / (2.0 * voxel_size)
        return (
            F.pad((s[2:] - s[:-2]) * inv, (0, 0, 0, 0, 1, 1)),
            F.pad((s[:, 2:] - s[:, :-2]) * inv, (0, 0, 1, 1)),
            F.pad((s[:, :, 2:] - s[:, :, :-2]) * inv, (1, 1)),
        )
    if mode == "raw":
        inv = 1.0 / voxel_size
        return (
            F.pad((s[1:] - s[:-1]) * inv, (0, 0, 0, 0, 0, 1)),
            F.pad((s[:, 1:] - s[:, :-1]) * inv, (0, 0, 0, 1)),
            F.pad((s[:, :, 1:] - s[:, :, :-1]) * inv, (0, 1)),
        )
    if mode == "grad_conv":
        ks = sobel_gradient_kernels(voxel_size)
        return tuple(_stencil3_edge(s, ks[a]) for a in range(3))
    raise NotImplementedError(mode)


def sdf_gradient(sdf: torch.Tensor, voxel_size: float,
                 mode: str = "interpolate") -> torch.Tensor:
    """Whole-grid SDF gradient [X, Y, Z, 1] -> [X, Y, Z, 3]
    (`ops/stencils.py:164-178`)."""
    return torch.stack(_sdf_gradient_axes(sdf[..., 0], voxel_size, mode),
                       dim=-1)


def sdf_gradient_cm(sdf3: torch.Tensor, voxel_size: float,
                    mode: str = "interpolate") -> torch.Tensor:
    """Channel-major ``sdf_gradient``: [X, Y, Z] -> [3, X, Y, Z]
    (`ops/stencils.py:181-187`)."""
    return torch.stack(_sdf_gradient_axes(sdf3, voxel_size, mode), dim=0)
