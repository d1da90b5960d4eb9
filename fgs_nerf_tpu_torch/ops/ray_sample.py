"""Ray / box slab intersection.

Port of ``fgs_nerf_tpu/ops/ray_sample.py:42-62`` (the lattice sampler
``sample_along_rays`` belongs to the lattice engine and is not ported
yet; the sorted engine evaluates the same expressions per axis).
"""
from __future__ import annotations

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
