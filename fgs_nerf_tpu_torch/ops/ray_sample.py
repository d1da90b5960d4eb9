"""Fixed-shape ray sampling: the slab intersection and the per-ray
sample lattice.

Port of ``fgs_nerf_tpu/ops/ray_sample.py:23-111``.  Every ray gets a
static ``s_max`` slots and a validity mask; a masked slot contributes
nothing downstream.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fgs_nerf_tpu_torch.core.box import SceneBox


def ray_box_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      box: SceneBox, near: float, far: float):
    """Slab test clamped to [near, far]; zero direction components are
    replaced by 1e-6 (`render_utils_kernel.cu:12-35` in the reference)."""
    vec = torch.where(rays_d == 0.0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (box.xyz_max - rays_o) / vec
    rate_b = (box.xyz_min - rays_o) / vec
    t_min = torch.amax(torch.minimum(rate_a, rate_b), dim=-1)
    t_max = torch.amin(torch.maximum(rate_a, rate_b), dim=-1)
    t_min = torch.clamp(torch.clamp(t_min, max=far), min=near)
    t_max = torch.clamp(torch.clamp(t_max, max=far), min=near)
    return t_min, t_max


class RaySamples(NamedTuple):
    """A fixed-shape lattice of sample points (`ops/ray_sample.py:23-39`).

    pts [N, S, 3] world positions; valid [N, S]; t_min, t_max [N] entry
    and exit distances (units of |rays_d|); n_steps [N] live sample
    count; step_dist the world-space distance between samples."""

    pts: torch.Tensor
    valid: torch.Tensor
    t_min: torch.Tensor
    t_max: torch.Tensor
    n_steps: torch.Tensor
    step_dist: float


def ray_norm(rays_d: torch.Tensor) -> torch.Tensor:
    """|rays_d| per ray; one expression for the lattice and every point
    recomputed from it (``models/sdf_voxel.py:_pts_at_steps``)."""
    return torch.sqrt(torch.sum(rays_d * rays_d, dim=-1))


def sample_along_rays(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      box: SceneBox, near: float, step_dist: float,
                      s_max: int, far: float = 1e9) -> RaySamples:
    """Uniform sampling from box entry, one slot per step
    (`ops/ray_sample.py:65-111`): the ray marches from ``o + d * t_min``
    along the unit direction with a fixed world-space step, taking
    ``max(ceil((t_max - t_min) * |d| / step_dist), 1)`` steps; slots past
    that count or outside the box are masked out."""
    t_min, t_max = ray_box_intersect(rays_o, rays_d, box, near, far)
    d_norm = ray_norm(rays_d)
    n_steps = torch.clamp(
        torch.ceil((t_max - t_min) * d_norm / step_dist), min=1.0
    ).to(torch.int32)
    start = rays_o + rays_d * t_min[..., None]
    dir_unit = rays_d / d_norm[..., None]
    step_ids = torch.arange(s_max, dtype=torch.float32, device=rays_o.device)
    dist = step_ids * step_dist
    pts = start[:, None, :] + dir_unit[:, None, :] * dist[None, :, None]
    in_range = step_ids[None, :] < n_steps[:, None].to(torch.float32)
    in_bbox = torch.all((pts >= box.xyz_min) & (pts <= box.xyz_max), dim=-1)
    return RaySamples(pts=pts, valid=in_range & in_bbox, t_min=t_min,
                      t_max=t_max, n_steps=n_steps, step_dist=step_dist)
