"""Pixel -> ray generation on the host (numpy).

Copies of ``get_rays``, ``ndc_rays`` and ``get_rays_of_a_view`` from
``fgs_nerf_tpu/data/rays.py:21-89`` (that module imports JAX for its
mask-cache filter, so the port keeps its own copy): pixel-center
offsets, the inverse_y / flip_x / flip_y conventions, unit view
directions, and the NDC warp.
"""
from __future__ import annotations

import numpy as np


def get_rays(h: int, w: int, k: np.ndarray, c2w: np.ndarray,
             inverse_y: bool, flip_x: bool, flip_y: bool, mode: str = "center",
             rng: np.random.Generator | None = None):
    """Pixel grid -> world rays as numpy [H, W, 3] arrays
    (`data/rays.py:21-55`)."""
    c2w = np.asarray(c2w, np.float32)
    k = np.asarray(k, np.float32)
    i, j = np.meshgrid(
        np.linspace(0, w - 1, w, dtype=np.float32),
        np.linspace(0, h - 1, h, dtype=np.float32),
        indexing="xy",
    )
    if mode == "center":
        i, j = i + 0.5, j + 0.5
    elif mode == "random":
        if rng is None:
            raise ValueError("mode='random' needs a numpy Generator")
        i = i + rng.uniform(size=i.shape).astype(np.float32)
        j = j + rng.uniform(size=j.shape).astype(np.float32)
    elif mode != "lefttop":
        raise NotImplementedError(mode)
    if flip_x:
        i = i[:, ::-1]
    if flip_y:
        j = j[::-1, :]
    if inverse_y:
        dirs = np.stack(
            [(i - k[0][2]) / k[0][0], (j - k[1][2]) / k[1][1], np.ones_like(i)], -1
        )
    else:
        dirs = np.stack(
            [(i - k[0][2]) / k[0][0], -(j - k[1][2]) / k[1][1], -np.ones_like(i)], -1
        )
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    return rays_o, rays_d


def ndc_rays(h, w, focal, near, rays_o, rays_d):
    """Standard NeRF NDC reprojection (`data/rays.py:58-74`)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (w / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (h / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]
    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)


def get_rays_of_a_view(h, w, k, c2w, ndc, inverse_y, flip_x, flip_y,
                       mode="center"):
    """Rays and unit view directions of one view, float32
    (`data/rays.py:77-89`)."""
    rays_o, rays_d = get_rays(h, w, k, c2w, inverse_y, flip_x, flip_y, mode)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    if ndc:
        rays_o, rays_d = ndc_rays(h, w, k[0][0], 1.0, rays_o, rays_d)
    return (
        rays_o.astype(np.float32),
        rays_d.astype(np.float32),
        viewdirs.astype(np.float32),
    )
