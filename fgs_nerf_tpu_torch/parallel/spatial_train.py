"""Spatial sharding wired into training: the ``sp`` mesh axis carries the
voxel grids through a train step.

Port of ``fgs_nerf_tpu/parallel/spatial_train.py``.  ``sdf`` and ``k0``
and their Adam moments live as x-slabs (:func:`place_spatial`); every
other leaf is replicated.  The model's trilinear field gathers go
through :func:`make_spatial_gather` (the model ``gather_fn``); the grid
stencils (smoothing, SDF gradients) and the TV terms get the same mesh
and run on a halo-extended slab.  Rays stay sharded over dp;
along sp the per-sample pipeline is replicated (sp buys grid memory per
card, not gather throughput).  A grid whose x extent does not divide sp
is zero-padded inside the gather only: the padded planes lie past the
grid, read as the zero padding the gather prescribes, and get no
cotangent.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from fgs_nerf_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from fgs_nerf_tpu_torch.parallel.spatial import (
    grid_slab, sharded_trilinear_sample, slab_bounds, slab_len,
)

GRID_PARAMS = ("sdf", "k0")


def mesh_sp_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.sp


def make_spatial_gather(mesh: Mesh):
    """The model ``gather_fn`` under sp (`:63-84`): ``gather(field slab
    [Xl', Y, Z, C], idx [..., 3] in global index space, global_x) ->
    [..., C]``, the last slab zero-padded to ``ceil(global_x / sp)``."""
    def gather(field: torch.Tensor, idx: torch.Tensor,
               global_x: int) -> torch.Tensor:
        xl = slab_len(global_x, mesh.sp)
        pad = xl - field.shape[0]
        if pad:
            field = F.pad(field, [0, 0] * (field.ndim - 1) + [0, pad])
        return sharded_trilinear_sample(field, idx, xl * mesh.sp, mesh)

    return gather


def _slab_tree(mesh: Mesh, tree: Any) -> Any:
    return {k: (grid_slab(mesh, v) if k in GRID_PARAMS else v)
            for k, v in tree.items()}


def place_spatial(mesh: Mesh, params: Any, opt_state=None):
    """Full params (and optionally an ``AdamState``) -> this rank's
    placement: grid leaves cut to its x-slab, the rest replicated
    (`:103-108`)."""
    params = _slab_tree(mesh, params)
    if opt_state is None:
        return params
    opt_state = type(opt_state)(opt_state.step,
                                _slab_tree(mesh, opt_state.exp_avg),
                                _slab_tree(mesh, opt_state.exp_avg_sq))
    return params, opt_state


def gather_grid(mesh: Mesh, slab: torch.Tensor, global_x: int) -> torch.Tensor:
    """The full grid on every rank of the sp group: zero-padded slabs
    summed by one ``all_reduce``."""
    x0, x1 = slab_bounds(global_x, mesh)
    full = slab.new_zeros((global_x,) + tuple(slab.shape[1:]))
    full[x0:x1] = slab
    return all_reduce_sum(full, mesh.sp_group)


def gather_spatial(mesh: Optional[Mesh], params: Any, global_x: int,
                   opt_state=None):
    """Inverse of :func:`place_spatial`: full grid leaves on every rank
    (checkpoints, rung upscaling, evaluation).  Identity unless sp > 1."""
    def full(tree):
        return {k: (gather_grid(mesh, v.detach(), global_x)
                    if k in GRID_PARAMS else v) for k, v in tree.items()}

    if mesh is None or mesh.sp == 1:
        return params if opt_state is None else (params, opt_state)
    params = full(params)
    if opt_state is None:
        return params
    return params, type(opt_state)(opt_state.step, full(opt_state.exp_avg),
                                   full(opt_state.exp_avg_sq))
