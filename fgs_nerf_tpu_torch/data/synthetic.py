"""Procedural synthetic scene: a glossy sphere on a white background,
rendered analytically, so an evaluation needs no dataset.

Copy of ``fgs_nerf_tpu/data/synthetic.py:19-79`` with ``pose_spherical``
from ``fgs_nerf_tpu/data/blender.py:14-41``.  Camera conventions match
the blender loader: an outward ring of cameras, near/far = 2/6, white
background.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from fgs_nerf_tpu_torch.data.rays import get_rays_of_a_view


def _trans_t(t):
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], np.float32
    )


def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float32
    )


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float32
    )


def pose_spherical(theta, phi, radius):
    """Spherical render-path pose (`data/blender.py:32-41`)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
    )
    return flip @ c2w


def synthetic_focal(w: int) -> float:
    """The blender-like focal length of a ``w``-pixel-wide view."""
    return 0.5 * w / np.tan(0.5 * 0.6911112)


def intrinsics(h: int, w: int) -> np.ndarray:
    focal = synthetic_focal(w)
    return np.array([[focal, 0, 0.5 * w], [0, focal, 0.5 * h], [0, 0, 1]],
                    np.float32)


def shade_sphere(rays_o, rays_d, radius=0.5):
    """Analytic lambert + specular sphere at the origin
    (`data/synthetic.py:19-45`): (image [..., 3], alpha [...])."""
    o = rays_o.reshape(-1, 3)
    d = rays_d.reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = np.sum(o * d, -1)
    c = np.sum(o * o, -1) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = o + d * t[:, None]
    n = p / radius
    light = np.array([0.5, 0.7, 0.5])
    light = light / np.linalg.norm(light)
    lam = np.clip(n @ light, 0, 1)
    refl = d - 2 * np.sum(d * n, -1, keepdims=True) * n
    spec = np.clip(refl @ light, 0, 1) ** 32
    base = np.array([0.2, 0.4, 0.8])
    rgb = base[None] * (0.15 + 0.85 * lam[:, None]) + 0.8 * spec[:, None]
    img = np.ones_like(o)
    img[hit] = np.clip(rgb[hit], 0, 1)
    alpha = hit.astype(np.float32)
    return img.reshape(rays_o.shape), alpha.reshape(rays_o.shape[:-1])


def make_synthetic_dataset(n_views=12, h=64, w=64, n_test=2) -> Dict:
    """data_dict with the reference loader contract
    (`data/synthetic.py:48-79`)."""
    focal = synthetic_focal(w)
    k = intrinsics(h, w)
    n_total = n_views + n_test
    poses = np.stack(
        [
            pose_spherical(th, -30.0, 4.0)
            for th in np.linspace(-180, 180, n_total, endpoint=False)
        ]
    )
    images = np.empty((n_total, h, w, 3), np.float32)
    masks = np.empty((n_total, h, w), np.float32)
    for i, c2w in enumerate(poses):
        rays_o, rays_d, _ = get_rays_of_a_view(
            h, w, k, c2w, ndc=False, inverse_y=False, flip_x=False, flip_y=False
        )
        img, alpha = shade_sphere(rays_o, rays_d)
        images[i] = img
        masks[i] = alpha
    ks = np.repeat(k[None], n_total, 0)
    hw = np.array([[h, w]] * n_total)
    return dict(
        hwf=[h, w, float(focal)],
        HW=hw,
        Ks=ks,
        near=2.0,
        far=6.0,
        i_train=np.arange(n_views),
        i_val=np.arange(n_views, n_total),
        i_test=np.arange(n_views, n_total),
        poses=poses,
        render_poses=poses[n_views:],
        images=images,
        masks=masks,
        irregular_shape=False,
        scale_mats_np=None,
    )
