"""Grid interpolation ops: trilinear gather, nearest lookup and
finite-difference tap sampling.

Port of ``fgs_nerf_tpu/ops/interp.py:40-344`` on the JAX package's CPU
semantics: the cell pack is the float32 slice-concat build of its CPU
branch (``:148-154``; the bf16 pack exists only on its TPU path).
Grids are channel-last ``[X, Y, Z, C]`` and sampling is in xyz index
space (``[0, size-1]`` spans the grid, align_corners=True), with
out-of-range corners reading zero.  The backward of every trilinear
gather is ``ops/scatter.py:corner_scatter_grid_grad`` (kernel B7 on the
card); the cotangent of the positions is None, because sample positions
are data (`ops/interp.py:96-102`).  ``resize_trilinear`` and
``max_pool3d_same`` (``:347-391``) serve the stage handoff.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.device import to_device
from fgs_nerf_tpu_torch.ops.scatter import CORNERS, corner_scatter_grid_grad


def _corner_gather(flat_grid: torch.Tensor, ci: torch.Tensor,
                   sizes: torch.Tensor) -> torch.Tensor:
    """Gather [..., C] values at integer coords ``ci`` [..., 3], zero
    outside (`ops/interp.py:60-66`)."""
    inb = torch.all((ci >= 0) & (ci < sizes), dim=-1)
    cc = torch.minimum(torch.clamp(ci, min=0), sizes - 1)
    lin = (cc[..., 0] * sizes[1] + cc[..., 1]) * sizes[2] + cc[..., 2]
    return flat_grid[lin] * inb[..., None].to(flat_grid.dtype)


def _trilinear_sample_index_impl(grid: torch.Tensor,
                                 idx: torch.Tensor) -> torch.Tensor:
    """8-corner trilinear interpolation at index-space coords
    (`ops/interp.py:69-85`): the corner weight is the product of the
    per-axis weights in x, y, z order, the corners are summed dz fastest."""
    sizes = to_device(grid.shape[:3], grid.device, torch.int64)
    offs = to_device(CORNERS, grid.device, torch.int64)
    flat = grid.reshape(-1, grid.shape[-1])
    i0 = torch.floor(idx)
    f = idx - i0
    i0 = i0.long()
    wa = [(1.0 - f[..., a], f[..., a]) for a in range(3)]
    out = None
    for k, (ox, oy, oz) in enumerate(CORNERS):
        w = wa[0][ox] * wa[1][oy] * wa[2][oz]
        term = w[..., None] * _corner_gather(flat, i0 + offs[k], sizes)
        out = term if out is None else out + term
    return out


def _grad_from_idx(ctx, g):
    (idx,) = ctx.saved_tensors
    c = ctx.grid_shape[-1]
    i0 = torch.floor(idx)
    fracs = (idx - i0).reshape(-1, 3)
    grad = corner_scatter_grid_grad(i0.reshape(-1, 3).long(), fracs,
                                    g.reshape(-1, c).float(), ctx.grid_shape)
    return grad, None


class _TrilinearSampleIndex(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, idx):
        ctx.grid_shape = tuple(grid.shape)
        ctx.save_for_backward(idx)
        return _trilinear_sample_index_impl(grid, idx)

    backward = staticmethod(_grad_from_idx)


def trilinear_sample_index(grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation at fractional index-space coords
    (`ops/interp.py:88-103`): grid [X, Y, Z, C], idx [..., 3] ->
    [..., C].  Backward: ``corner_scatter_grid_grad``; none for idx."""
    return _TrilinearSampleIndex.apply(grid, idx.detach())


def _build_pack(grid: torch.Tensor) -> torch.Tensor:
    """The float32 cell pack (`ops/interp.py:148-154`): the row of padded
    base (bx, by, bz) holds the 8 corner values, corner
    k = dx*4 + dy*2 + dz at channels [k*C, (k+1)*C)."""
    x, y, z, c = grid.shape
    gp = F.pad(grid, (0, 0, 1, 1, 1, 1, 1, 1))
    parts = [gp[dx:dx + x + 1, dy:dy + y + 1, dz:dz + z + 1, :]
             for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    return torch.cat(parts, dim=-1).reshape(-1, 8 * c)


def _cellpack_gather_impl(grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Cell-packed trilinear gather, one pack row per sample
    (`ops/interp.py:127-182`): the padded pack covers base cells
    -1..size-1 per axis, so out-of-range corners read exact zeros."""
    x, y, z, c = grid.shape
    pack = _build_pack(grid)
    sizes = torch.tensor((x, y, z), dtype=torch.int64, device=grid.device)
    i0f = torch.floor(idx)
    f = (idx - i0f).reshape(-1, 3)
    i0 = i0f.long()
    base_ok = torch.all((i0 >= -1) & (i0 < sizes), dim=-1).reshape(-1)
    b = torch.minimum(torch.clamp(i0, min=-1), sizes - 1) + 1
    rows = ((b[..., 0] * (y + 1) + b[..., 1]) * (z + 1) + b[..., 2]).reshape(-1)
    v = pack[rows]  # [M, 8C]
    del pack
    wx = torch.stack([1.0 - f[:, 0], f[:, 0]], dim=-1)
    wy = torch.stack([1.0 - f[:, 1], f[:, 1]], dim=-1)
    wz = torch.stack([1.0 - f[:, 2], f[:, 2]], dim=-1)
    # corner order dx slowest, dz fastest, as the pack's parts
    w = (wx[:, :, None, None] * wy[:, None, :, None]
         * wz[:, None, None, :]).reshape(-1, 8)
    w = w * base_ok[:, None].to(w.dtype)
    out = None
    for k in range(8):
        term = v[:, k * c:(k + 1) * c] * w[:, k:k + 1]
        out = term if out is None else out + term
    return out.reshape(*idx.shape[:-1], c)


class _TrilinearSampleIndexPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, idx):
        ctx.grid_shape = tuple(grid.shape)
        ctx.save_for_backward(idx)
        return _cellpack_gather_impl(grid, idx)

    backward = staticmethod(_grad_from_idx)


def trilinear_sample_index_packed(grid: torch.Tensor,
                                  idx: torch.Tensor) -> torch.Tensor:
    """``trilinear_sample_index`` with the cell-packed forward
    (`ops/interp.py:185-202`) and the same backward."""
    return _TrilinearSampleIndexPacked.apply(grid, idx.detach())


PACK_BYTES_CAP = 2 << 30  # 2 GiB: the cell pack is 8x grid bytes


def pack_worthwhile(grid_shape, n_samples: int) -> bool:
    """The packed gather only when samples are of the order of voxels and
    the pack fits in 2 GiB (`ops/interp.py:205-218`)."""
    x, y, z, c = grid_shape
    pack_bytes = 8 * 4 * c * (x + 1) * (y + 1) * (z + 1)
    return pack_bytes <= PACK_BYTES_CAP and n_samples * 4 >= x * y * z


def trilinear_sample(grid: torch.Tensor, xyz: torch.Tensor, box: SceneBox,
                     packed: bool = False) -> torch.Tensor:
    """Trilinear sample at world coords (`ops/interp.py:221-229`)."""
    sizes = torch.tensor(grid.shape[:3], dtype=torch.float32, device=xyz.device)
    idx = box.normalize(xyz) * (sizes - 1.0)
    if packed and pack_worthwhile(tuple(grid.shape),
                                  int(np.prod(xyz.shape[:-1]))):
        return trilinear_sample_index_packed(grid, idx)
    return trilinear_sample_index(grid, idx)


def nearest_bool_lookup(mask: torch.Tensor, xyz: torch.Tensor,
                        box: SceneBox) -> torch.Tensor:
    """Nearest-voxel boolean occupancy, out of bounds False
    (`ops/interp.py:232-249`): ``ijk = floor(xyz * scale + shift + 0.5)``."""
    sizes = torch.tensor(mask.shape, dtype=torch.int64, device=xyz.device)
    scale = (sizes.to(torch.float32) - 1.0) / box.extent
    shift = -box.xyz_min * scale
    ijk = torch.floor(xyz * scale + shift + 0.5).long()
    inb = torch.all((ijk >= 0) & (ijk < sizes), dim=-1)
    cc = torch.minimum(torch.clamp(ijk, min=0), sizes - 1)
    lin = (cc[..., 0] * sizes[1] + cc[..., 1]) * sizes[2] + cc[..., 2]
    return mask.reshape(-1)[lin] & inb


_TAP_OFFS = ((0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0), (1, 0, 0))


def sample_sdf_taps(grid: torch.Tensor, xyz: torch.Tensor, box: SceneBox,
                    displace_list: Sequence[float], voxel_size: float,
                    use_grad_norm: bool, sample_fn=None,
                    grid_size=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Six-neighbour taps and finite-difference gradients
    (`ops/interp.py:252-320`), all 6 x D taps in one trilinear call.

    Returns feat [..., 6, D] ordered (z-, z+, y-, y+, x-, x+) and grad
    [..., 3, D] ordered (z, y, x), normalized per level over the axis dim
    when ``use_grad_norm``.  ``sample_fn(grid, idx)`` overrides the
    gather (the spatially sharded one, where ``grid`` is an x-slab of a
    ``grid_size`` grid)."""
    dev = xyz.device
    sizes = torch.tensor(tuple(grid_size or grid.shape[:3]),
                         dtype=torch.float32, device=dev)
    idx = box.normalize(xyz) * (sizes - 1.0)
    displace = torch.tensor(list(displace_list), dtype=torch.float32, device=dev)
    offs = torch.tensor(_TAP_OFFS, dtype=torch.float32, device=dev)
    tap_off = offs[:, None, :] * displace[None, :, None]  # [6, D, 3]
    tap_idx = idx[..., None, None, :] + tap_off
    tap_idx = torch.minimum(torch.clamp(tap_idx, min=0.0), sizes - 1.0)
    gather = sample_fn if sample_fn is not None else trilinear_sample_index
    feat = gather(grid, tap_idx)[..., 0]  # [..., 6, D]
    # post-clamp coordinate of each tap along its displaced axis
    tap_coord = torch.stack([
        tap_idx[..., 0, :, 2], tap_idx[..., 1, :, 2],
        tap_idx[..., 2, :, 1], tap_idx[..., 3, :, 1],
        tap_idx[..., 4, :, 0], tap_idx[..., 5, :, 0],
    ], dim=-2)  # [..., 6, D]
    dist = tap_coord[..., 1::2, :] - tap_coord[..., 0::2, :]  # [..., 3, D]
    # far outside the grid both taps clamp to one coordinate: guard the
    # division (those slots are masked out; a NaN would poison 0 * NaN)
    dist = torch.where(dist > 0, dist, torch.ones_like(dist))
    grad = (feat[..., 1::2, :] - feat[..., 0::2, :]) / dist / voxel_size
    if use_grad_norm:
        norm = torch.sqrt(torch.clamp(
            torch.sum(grad**2, dim=-2, keepdim=True), min=1e-24))
        grad = grad / (norm + 1e-5)
    return feat, grad


def center_gradient_taps(grid: torch.Tensor, xyz: torch.Tensor, box: SceneBox,
                         voxel_size: float, sample_fn=None, grid_size=None):
    """The displacement-1.0 tap pass of the fine forward, reordered to
    xyz (`ops/interp.py:323-344`): (grad_xyz [..., 3], feat [..., 6]
    ordered (x-, x+, y-, y+, z-, z+))."""
    feat, grad = sample_sdf_taps(grid, xyz, box, (1.0,), voxel_size,
                                 use_grad_norm=False, sample_fn=sample_fn,
                                 grid_size=grid_size)
    feat = feat[..., :, 0]
    grad = grad[..., :, 0]
    feat_xyz = torch.cat([feat[..., 4:6], feat[..., 2:4], feat[..., 0:2]],
                         dim=-1)
    grad_xyz = torch.stack([grad[..., 2], grad[..., 1], grad[..., 0]], dim=-1)
    return grad_xyz, feat_xyz


def _resize_axis_linear(grid: torch.Tensor, axis: int, new_len: int) -> torch.Tensor:
    """Align-corners linear resize of one axis (`ops/interp.py:347-363`)."""
    old_len = grid.shape[axis]
    if old_len == new_len:
        return grid
    if old_len == 1:
        reps = [1] * grid.ndim
        reps[axis] = new_len
        return grid.repeat(*reps)
    pos = torch.linspace(0.0, old_len - 1.0, new_len, dtype=torch.float32,
                         device=grid.device)
    i0 = torch.clamp(torch.floor(pos).long(), 0, old_len - 2)
    f = pos - i0.to(pos.dtype)
    lo = torch.index_select(grid, axis, i0)
    hi = torch.index_select(grid, axis, i0 + 1)
    shape = [1] * grid.ndim
    shape[axis] = new_len
    f = f.reshape(shape)
    return lo * (1.0 - f) + hi * f


def resize_trilinear(grid: torch.Tensor, new_size: Sequence[int]) -> torch.Tensor:
    """Align-corners trilinear resize of an [X, Y, Z, C] grid, one
    separable linear pass per axis (`ops/interp.py:366-376`)."""
    out = grid
    for axis, n in enumerate(new_size):
        out = _resize_axis_linear(out, axis, int(n))
    return out


def max_pool3d_same(grid: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """k x k x k max pool, stride 1, same padding (padding reads -inf)
    over an [X, Y, Z, C] grid (`ops/interp.py:379-391`)."""
    pooled = F.max_pool3d(grid.permute(3, 0, 1, 2), ksize, stride=1,
                          padding=ksize // 2)
    return pooled.permute(1, 2, 3, 0).contiguous()
