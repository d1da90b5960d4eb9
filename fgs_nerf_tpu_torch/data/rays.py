"""Pixel -> ray generation on the host (numpy) and the training-ray
samplers.

Port of ``fgs_nerf_tpu/data/rays.py:21-198``: pixel-center offsets, the
inverse_y / flip_x / flip_y conventions, unit view directions, the NDC
warp, the per-view and flattened training rays, the 'in_maskcache'
pixel filter (its fixed-N samples run on the mask cache's device) and
the epoch-style batch index generator, which draws from numpy's
``default_rng(seed)`` exactly as the JAX package does; and the pose
helpers of ``data/rays.py:205-255`` (quaternion ``slerp``,
``interp_pose``, ``get_random_poses``), numpy and scipy on the host.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.ops.ray_sample import ray_box_intersect


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


def get_training_rays(images, poses, hw, ks, ndc, inverse_y, flip_x, flip_y):
    """Per-view ray grids [V, H, W, 3] for the 'random' / 'patch'
    samplers (`data/rays.py:92-103`)."""
    h, w = int(hw[0][0]), int(hw[0][1])
    v = len(poses)
    rays_o = np.empty((v, h, w, 3), np.float32)
    rays_d = np.empty((v, h, w, 3), np.float32)
    viewdirs = np.empty((v, h, w, 3), np.float32)
    for idx, c2w in enumerate(poses):
        o, d, vd = get_rays_of_a_view(h, w, ks[idx], c2w, ndc, inverse_y,
                                      flip_x, flip_y)
        rays_o[idx], rays_d[idx], viewdirs[idx] = o, d, vd
    return images, rays_o, rays_d, viewdirs


def get_training_rays_flatten(images, poses, hw, ks, ndc, inverse_y, flip_x,
                              flip_y):
    """All pixels flattened to [N, 3] (`data/rays.py:106-118`)."""
    rgb_l, o_l, d_l, v_l = [], [], [], []
    for img, c2w, (h, w), k in zip(images, poses, hw, ks):
        o, d, vd = get_rays_of_a_view(int(h), int(w), k, c2w, ndc, inverse_y,
                                      flip_x, flip_y)
        rgb_l.append(np.asarray(img).reshape(-1, 3))
        o_l.append(o.reshape(-1, 3))
        d_l.append(d.reshape(-1, 3))
        v_l.append(vd.reshape(-1, 3))
    return (np.concatenate(rgb_l), np.concatenate(o_l),
            np.concatenate(d_l), np.concatenate(v_l))


def make_maskcache_pixel_filter(box: SceneBox, world_size, stepsize: float,
                                voxel_size: float, mask_cache_query_fn):
    """Per-chunk pixel filter of the 'in_maskcache' sampler
    (`data/rays.py:121-148`): a pixel survives if any of its fixed-N
    samples lies in the bbox and in the mask cache.  ``keep_fn(rays_o,
    rays_d, near, far)`` takes numpy [n, 3] rays, runs on the device of
    ``box`` and returns a numpy bool [n]."""
    dev = box.xyz_min.device
    n_samples = int(np.linalg.norm(np.asarray(world_size) + 1) / stepsize) + 1
    step = (stepsize * voxel_size
            * torch.arange(n_samples, dtype=torch.float32, device=dev))

    @torch.no_grad()
    def keep_fn(rays_o, rays_d, near, far):
        rays_o = torch.as_tensor(rays_o, device=dev)
        rays_d = torch.as_tensor(rays_d, device=dev)
        t_min, t_max = ray_box_intersect(rays_o, rays_d, box, near, far)
        mask_ray = t_max > t_min
        interpx = t_min[:, None] + step[None, :] / torch.linalg.norm(
            rays_d, dim=-1, keepdim=True)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
        inb = torch.all((pts >= box.xyz_min) & (pts <= box.xyz_max), dim=-1)
        inb = inb & mask_ray[:, None]
        occ = mask_cache_query_fn(pts)
        return torch.any(inb & occ, dim=-1).cpu().numpy()

    return keep_fn


def get_training_rays_in_maskcache(images, poses, hw, ks, ndc, inverse_y,
                                   flip_x, flip_y, keep_fn, near, far,
                                   chunk=65536):
    """Filtered flat training rays and the kept ratio
    (`data/rays.py:151-186`).  The JAX package pads each view's last chunk
    to one static shape for its jitted filter; every pixel's test is its
    own, so the port filters the real pixels only."""
    rgb_l, o_l, d_l, v_l = [], [], [], []
    total, kept = 0, 0
    for img, c2w, (h, w), k in zip(images, poses, hw, ks):
        o, d, vd = get_rays_of_a_view(int(h), int(w), k, c2w, ndc, inverse_y,
                                      flip_x, flip_y)
        o_f, d_f, vd_f = o.reshape(-1, 3), d.reshape(-1, 3), vd.reshape(-1, 3)
        img_f = np.asarray(img).reshape(-1, 3)
        keep = np.concatenate([
            keep_fn(o_f[s:s + chunk], d_f[s:s + chunk], float(near), float(far))
            for s in range(0, len(o_f), chunk)])
        total += len(keep)
        kept += int(keep.sum())
        rgb_l.append(img_f[keep])
        o_l.append(o_f[keep])
        d_l.append(d_f[keep])
        v_l.append(vd_f[keep])
    ratio = kept / max(total, 1)
    return (np.concatenate(rgb_l), np.concatenate(o_l),
            np.concatenate(d_l), np.concatenate(v_l), ratio)


def batch_index_generator(n: int, bs: int, seed: int = 777) -> Iterator[np.ndarray]:
    """Epoch-style random permutation batches (`data/rays.py:189-197`)."""
    rng = np.random.default_rng(seed)
    idx, top = rng.permutation(n), 0
    while True:
        if top + bs > n:
            idx, top = rng.permutation(n), 0
        yield idx[top:top + bs]
        top += bs


# ---------------------------------------------------------------------------
# Pose interpolation / random-pose synthesis (`model/nerf_ray.py:103-175`)
# ---------------------------------------------------------------------------


def slerp(p0: np.ndarray, p1: np.ndarray, t: float) -> np.ndarray:
    """Quaternion spherical interpolation (`model/nerf_ray.py:103-107`)."""
    omega = np.arccos(
        np.clip(np.dot(p0 / np.linalg.norm(p0), p1 / np.linalg.norm(p1)), -1, 1)
    )
    so = np.sin(omega)
    if so < 1e-8:
        return (1.0 - t) * p0 + t * p1
    return np.sin((1.0 - t) * omega) / so * p0 + np.sin(t * omega) / so * p1


def interp_pose(pose1: np.ndarray, pose2: np.ndarray, s: float) -> np.ndarray:
    """Pose interpolation as c2w matrices (`model/nerf_ray.py:109-129`)."""
    from scipy.spatial.transform import Rotation

    pose1, pose2 = np.asarray(pose1)[:3], np.asarray(pose2)[:3]
    c = (1 - s) * pose1[:, -1] + s * pose2[:, -1]
    q = slerp(
        Rotation.from_matrix(pose1[:, :3]).as_quat(),
        Rotation.from_matrix(pose2[:, :3]).as_quat(), s,
    )
    r = Rotation.from_quat(q).as_matrix()
    return np.concatenate(
        [np.concatenate([r, c[:, None]], axis=-1), [[0, 0, 0, 1]]], axis=0
    ).astype(np.float32)


def get_random_poses(
    train_poses: np.ndarray, generate_poses: str = "loaded", n_poses: int = 20,
    seed: int = 0,
) -> np.ndarray:
    """Random pose synthesis (`model/nerf_ray.py:134-152`)."""
    rng_l = np.random.default_rng(seed)
    if generate_poses == "loaded":
        n_poses = min(n_poses, len(train_poses))
        return train_poses[
            rng_l.choice(len(train_poses), size=n_poses, replace=False)
        ]
    if generate_poses == "interpolate_train_all":
        assert len(train_poses) >= 3
        poses = np.zeros((n_poses, 4, 4), np.float32)
        for i in range(n_poses):
            p1, p2, p3 = train_poses[
                rng_l.choice(len(train_poses), size=3, replace=False)
            ]
            s12, s3 = rng_l.uniform(0, 1, size=2)
            poses[i] = interp_pose(
                interp_pose(p1[:3, :4], p2[:3, :4], s12), p3[:3, :4], s3
            )
        return poses
    raise NotImplementedError(generate_poses)
