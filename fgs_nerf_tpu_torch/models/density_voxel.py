"""DVGO-style density voxel model, the optional ``--dvgo_init``
geometry-searching path.

Port of ``fgs_nerf_tpu/models/density_voxel.py`` (`model/dvgo.py:25-357`)
on the lattice engine: a density grid and a 3-channel color grid;
post-activation alpha ``1 - exp(-softplus(d + act_shift) * interval)``
with ``act_shift = log(1/(1-alpha_init) - 1)``; color = sigmoid(k0);
normals from the density's gradient field.  The composite blends the
background with ``alphainv_last`` rather than ``1 - cum_weights``
(`model/dvgo.py:337`), a quirk kept as is.  Each of the three trilinear
samples of a step (density, k0, gradient field) has kernel B7 as its
backward on the card.

Parameters are a flat dict with the JAX package's names and layouts:
  density [X, Y, Z, 1]
  k0      [X, Y, Z, 3]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from fgs_nerf_tpu_torch.core.box import SceneBox, grid_resolution, max_samples_per_ray
from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device
from fgs_nerf_tpu_torch.models.sdf_voxel import (
    _compact_valid, _pts_at_steps, _safe_norm, mask_cache_query,
)
from fgs_nerf_tpu_torch.ops.interp import resize_trilinear, trilinear_sample
from fgs_nerf_tpu_torch.ops.ray_sample import sample_along_rays
from fgs_nerf_tpu_torch.ops.stencils import sdf_gradient
from fgs_nerf_tpu_torch.ops.transmittance import alpha_to_weights


@dataclasses.dataclass(frozen=True)
class DensityModelConfig:
    """`models/density_voxel.py:35-64`."""

    num_voxels: int
    num_voxels_base: int
    world_size: Tuple[int, int, int]
    voxel_size: float
    voxel_size_base: float
    s_max: int
    stepsize: float
    alpha_init: float = 0.01
    fast_color_thres: float = 0.0
    mask_cache_thres: float = 1e-3
    sample_k: int = 0

    @property
    def voxel_size_ratio(self) -> float:
        return self.voxel_size / self.voxel_size_base

    @property
    def step_dist(self) -> float:
        return self.stepsize * self.voxel_size

    @property
    def act_shift(self) -> float:
        """`model/dvgo.py:47`."""
        return float(np.log(1.0 / (1.0 - self.alpha_init) - 1.0))


def make_density_config(xyz_min, xyz_max, num_voxels, num_voxels_base,
                        stepsize, **kw) -> DensityModelConfig:
    """`models/density_voxel.py:67-78`."""
    world_size, voxel_size = grid_resolution(xyz_min, xyz_max, num_voxels)
    _, voxel_size_base = grid_resolution(xyz_min, xyz_max, num_voxels_base)
    return DensityModelConfig(
        num_voxels=num_voxels, num_voxels_base=num_voxels_base,
        world_size=world_size, voxel_size=voxel_size,
        voxel_size_base=voxel_size_base,
        s_max=max_samples_per_ray(world_size, stepsize), stepsize=stepsize,
        **kw,
    )


def init_params(cfg: DensityModelConfig,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Ball-shaped density init ``r - 1`` (`model/dvgo.py:59-62`) and a
    zero color grid."""
    dev = resolve_device(device)
    axes = [np.linspace(-1.0, 1.0, n) for n in cfg.world_size]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(x**2 + y**2 + z**2) - 1.0
    return {
        "density": torch.as_tensor(r[..., None].astype(np.float32),
                                   device=dev),
        "k0": torch.zeros((*cfg.world_size, 3), dtype=torch.float32,
                          device=dev),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` for every x
    (``torch.nn.functional.softplus`` returns x itself past its
    threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def activate_density(density, interval, act_shift: float) -> torch.Tensor:
    """`model/dvgo.py:225-227`."""
    return 1.0 - torch.exp(-softplus(density + act_shift) * interval)


def forward(params: Dict[str, Any], buffers: Dict[str, Any],
            cfg: DensityModelConfig, box: SceneBox, rays_o: torch.Tensor,
            rays_d: torch.Tensor, viewdirs: torch.Tensor, near: float,
            bg: float) -> Dict[str, torch.Tensor]:
    """`model/dvgo.py:284-357` on the fixed lattice
    (`models/density_voxel.py:95-149`)."""
    del viewdirs  # view-independent color model
    rs = sample_along_rays(rays_o, rays_d, box, near, cfg.step_dist,
                           cfg.s_max)
    pts, valid = rs.pts, rs.valid
    if "mask_cache" in buffers:
        valid = valid & mask_cache_query(buffers["mask_cache"], pts,
                                         cfg.mask_cache_thres)
    if 0 < cfg.sample_k < cfg.s_max:
        valid, steps, _ = _compact_valid(valid, cfg.sample_k)
        pts = _pts_at_steps(rays_o, rays_d, rs.t_min, steps, cfg.step_dist)

    interval = torch.tensor(cfg.stepsize * cfg.voxel_size_ratio,
                            dtype=torch.float32, device=rays_o.device)
    density = trilinear_sample(params["density"], pts, box)[..., 0]
    alpha = activate_density(density, interval, cfg.act_shift)

    live = valid
    if cfg.fast_color_thres > 0:
        live = live & (alpha > cfg.fast_color_thres)
    weights, alphainv_last = alpha_to_weights(alpha, live)
    if cfg.fast_color_thres > 0:
        live = live & (weights > cfg.fast_color_thres)
    w_eff = weights * live

    k0 = trilinear_sample(params["k0"], pts, box)
    rgb = torch.sigmoid(k0)
    grad_field = sdf_gradient(params["density"], cfg.voxel_size, "interpolate")
    gradient = trilinear_sample(grad_field, pts, box)
    normals = gradient / (_safe_norm(gradient) + 1e-7)

    rgb_marched = (torch.sum(w_eff[..., None] * rgb, dim=1)
                   + alphainv_last[..., None] * bg)
    normal_marched = torch.sum(w_eff[..., None] * normals, dim=1)
    return {
        "rgb_marched": rgb_marched,
        "alphainv_cum": alphainv_last,
        "weights": w_eff,
        "sel_rgb": rgb,
        "sel_weights": w_eff,
        "normal_marched": normal_marched,
        "live": live,
        "valid": valid,
    }


def scale_volume_grid(params: Dict[str, Any],
                      new_cfg: DensityModelConfig) -> Dict[str, Any]:
    """Trilinear upsample of density + k0 at a pg_scale rung
    (`models/density_voxel.py:152-161`)."""
    params = dict(params)
    params["density"] = resize_trilinear(params["density"], new_cfg.world_size)
    params["k0"] = resize_trilinear(params["k0"], new_cfg.world_size)
    return params


def build_alpha_grid(params, cfg: DensityModelConfig) -> torch.Tensor:
    """Voxel-wise activated alpha of the density grid
    (`models/density_voxel.py:164-171`)."""
    return activate_density(params["density"],
                            cfg.stepsize * cfg.voxel_size_ratio,
                            cfg.act_shift)


def build_sdf_mask(params, cfg: DensityModelConfig,
                   thres: float = 1e-3) -> torch.Tensor:
    """The DVGO occupancy in the SDF checkpoint's ``sdf_mask`` schema:
    activated alpha >= ``thres`` -> 1e-3, else 0
    (`models/density_voxel.py:174-185`).  With it the coarse stage builds
    its mask cache and shrinks its bbox from a DVGO checkpoint exactly as
    from an SDF one (the reference's own ``--dvgo_init`` handoff writes no
    ``sdf_mask`` and fails there)."""
    alpha = build_alpha_grid(params, cfg)
    return torch.where(alpha >= thres, 1e-3, 0.0).to(torch.float32)
