"""Spatial grid sharding with a halo exchange (the ``sp`` mesh axis).

Port of ``fgs_nerf_tpu/parallel/spatial.py``.  Voxel grids ``[X, Y, Z,
C]`` are cut along x into one slab per sp rank: with ``Xl = ceil(X /
sp)``, rank ``i`` holds planes ``[i * Xl, min((i + 1) * Xl, X))``.  The
three primitives a render step needs on a slab:

* :func:`halo_exchange` — extend a slab with its neighbours' edge
  planes.  A rank writes its two edges into its slot of a zeroed
  ``[sp, 2, halo, ...]`` buffer that one ``all_reduce`` over the sp group
  completes; the global edges read zeros or a replica of the rank's own
  plane.  Its backward routes the halo cotangents to their owners
  through the same scheme (the ``ppermute`` transpose).
* :func:`sharded_trilinear_sample` — the trilinear gather against the
  sharded grid: a rank serves the samples whose base cell it owns from
  its slab and a one-plane right halo, and a sum over sp completes every
  sample (backward: the identity, the ``psum`` transpose).  The local
  gather is ``ops/interp.py:trilinear_sample_index``, whose backward is
  kernel B7 on CUDA tensors.
* :func:`sharded_stencil` / :func:`sharded_sdf_gradient` — a dense
  stencil on a halo-extended slab, core sliced out (the dense op itself
  when the mesh does not shard grids).

Every rank of an sp group issues the same collectives in the same order,
forward and backward: nothing here branches on data.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from fgs_nerf_tpu_torch.ops.interp import trilinear_sample_index
from fgs_nerf_tpu_torch.ops.stencils import sdf_gradient
from fgs_nerf_tpu_torch.parallel.mesh import Mesh, all_reduce_sum


def slab_len(global_x: int, sp: int) -> int:
    return -(-global_x // sp)


def slab_bounds(global_x: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's x-plane range ``[x0, x1)`` of a grid of ``global_x``
    planes (the last slab may be shorter)."""
    xl = slab_len(global_x, mesh.sp)
    x0 = mesh.sp_index * xl
    return x0, min(x0 + xl, global_x)


def grid_slab(mesh: Mesh, grid: torch.Tensor) -> torch.Tensor:
    """This rank's x-slab of a full grid (`grid_sharding`'s placement)."""
    x0, x1 = slab_bounds(grid.shape[0], mesh)
    return grid[x0:x1].contiguous()


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slab, halo, mesh, edge):
        n, i = mesh.sp, mesh.sp_index
        buf = slab.new_zeros((n, 2, halo) + tuple(slab.shape[1:]))
        buf[i, 0] = slab[:halo]
        buf[i, 1] = slab[-halo:]
        all_reduce_sum(buf, mesh.sp_group)
        if i > 0:
            left = buf[i - 1, 1]
        elif edge == "replicate":
            left = slab[:1].expand(halo, *slab.shape[1:])
        else:
            left = torch.zeros_like(slab[:halo])
        if i < n - 1:
            right = buf[i + 1, 0]
        elif edge == "replicate":
            right = slab[-1:].expand(halo, *slab.shape[1:])
        else:
            right = torch.zeros_like(slab[:halo])
        ctx.meta = (halo, mesh, edge, slab.shape[0])
        return torch.cat([left, slab, right], dim=0)

    @staticmethod
    def backward(ctx, g):
        halo, mesh, edge, xl = ctx.meta
        n, i = mesh.sp, mesh.sp_index
        g_left, g_core, g_right = g[:halo], g[halo:halo + xl], g[halo + xl:]
        buf = g.new_zeros((n, 2, halo) + tuple(g.shape[1:]))
        if i > 0:
            buf[i - 1, 1] = g_left   # my left halo is my left neighbour's
        if i < n - 1:                # right edge, and the other way round
            buf[i + 1, 0] = g_right
        all_reduce_sum(buf, mesh.sp_group)
        gs = g_core.clone()
        gs[:halo] += buf[i, 0]
        gs[-halo:] += buf[i, 1]
        if edge == "replicate":
            if i == 0:
                gs[0] += g_left.sum(0)
            if i == n - 1:
                gs[-1] += g_right.sum(0)
        return gs, None, None, None


def halo_exchange(slab: torch.Tensor, halo: int, mesh: Mesh,
                  edge: str = "zero") -> torch.Tensor:
    """[Xl, ...] -> [Xl + 2 * halo, ...] with the neighbours' planes
    (`spatial.py:48-78`); past the global edges, zeros (``edge='zero'``)
    or copies of the rank's own boundary plane (``'replicate'``)."""
    if halo <= 0:
        return slab
    if slab.shape[0] < halo:
        raise ValueError(f"slab of {slab.shape[0]} planes is thinner than "
                         f"its halo ({halo})")
    return _HaloExchange.apply(slab, halo, mesh, edge)


class _SumOverSp(torch.autograd.Function):
    """All-reduce sum over sp; backward the identity (every sp rank holds
    the same output cotangent: it runs the same per-sample pipeline)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x.clone(), mesh.sp_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_sp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _SumOverSp.apply(x, mesh)


def sp_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when it shards grids (sp > 1), else None."""
    return mesh if mesh is not None and mesh.sp > 1 else None


def sharded_stencil(fn: Callable[[torch.Tensor], torch.Tensor],
                    slab: torch.Tensor, halo: int, mesh: Optional[Mesh],
                    edge: str = "replicate") -> torch.Tensor:
    """A same-shape dense stencil ``fn`` over an x-sharded grid
    (`:81-98`): exact when ``fn``'s x reach is <= ``halo`` and its own
    border handling matches ``edge``.  ``fn(slab)`` unless sp > 1."""
    if sp_mesh(mesh) is None:
        return fn(slab)
    ext = halo_exchange(slab, halo, mesh, edge=edge)
    return fn(ext)[halo:halo + slab.shape[0]]


def sharded_sdf_gradient(slab: torch.Tensor, voxel_size: float,
                         mesh: Optional[Mesh],
                         mode: str = "interpolate") -> torch.Tensor:
    """``ops/stencils.py:sdf_gradient`` over an x-sharded slab
    (`:101-138`): one-plane halo, then gx re-zeroed on the global border
    planes that the dense op zeroes.  The dense op unless sp > 1."""
    if sp_mesh(mesh) is None:
        return sdf_gradient(slab, voxel_size, mode)

    def fn(g):
        return sdf_gradient(g, voxel_size, mode)

    if mode == "grad_conv":
        return sharded_stencil(fn, slab, 1, mesh, edge="replicate")
    out = sharded_stencil(fn, slab, 1, mesh, edge="zero")
    xl = slab.shape[0]
    border = torch.zeros((xl,), dtype=torch.bool, device=slab.device)
    if mode == "interpolate" and mesh.sp_index == 0:
        border[0] = True
    if mesh.sp_index == mesh.sp - 1:
        border[xl - 1] = True
    gx = torch.where(border[:, None, None], torch.zeros_like(out[..., 0]),
                     out[..., 0])
    return torch.cat([gx[..., None], out[..., 1:]], dim=-1)


def sharded_trilinear_sample(slab: torch.Tensor, idx: torch.Tensor,
                             global_x: int, mesh: Mesh) -> torch.Tensor:
    """Trilinear gather (zero padding) against an x-sharded grid of equal
    slabs ``[Xl, Y, Z, C]``, ``global_x = Xl * sp`` (`:147-194`).

    The rank whose slab holds ``clip(floor(ix), 0, X - 1)`` serves the
    sample from its slab and one right halo plane (zeros past the last
    slab: the zero-padding semantics); other ranks give zero, and the
    sum over sp completes every sample.  Non-owned samples are clamped
    into the slab so their masked gathers stay in range."""
    xl = slab.shape[0]
    x0 = mesh.sp_index * xl
    # the left halo is never a corner of an owned base cell
    ext = halo_exchange(slab, 1, mesh, edge="zero")[1:]
    ix_base = torch.clamp(torch.floor(idx[..., 0]).long(), 0, global_x - 1)
    own = (ix_base >= x0) & (ix_base < x0 + xl)
    lx = idx[..., :1] - float(x0)
    lx = torch.where(own[..., None], lx,
                     torch.clamp(lx, 0.0, float(xl) - 1e-3))
    vals = trilinear_sample_index(ext, torch.cat([lx, idx[..., 1:]], dim=-1))
    vals = vals * own[..., None].to(vals.dtype)
    return sum_over_sp(vals, mesh)

