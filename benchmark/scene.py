"""Procedural scenes made on the device from a seed: the views a stage
trains on, the geometry stage's ``sdf_mask`` and box, and the state of a
stage at its final rung.

Frozen copies, each named where it sits:

* ``shade_sphere`` of ``fgs_nerf_tpu_torch/data/synthetic.py`` (the
  glossy sphere of radius 0.5 at the origin, lambert plus specular,
  white background) and its outward camera ring (``pose_spherical``,
  ``synthetic_focal``), rewritten in torch;
* the DTU arc of ``chip_smoke.py:_dtu_camera_centres`` / ``_look_at``
  (OpenCV cameras on an upper-hemisphere arc around the sphere) with the
  DTU intrinsics ``chip_smoke.py:DTU_K`` and the near / far heuristic of
  ``data/dataset.py:inward_nearfar_heuristic``;
* the pixel rays of ``data/rays.py:get_rays`` (pixel centres, both
  y conventions), ``core/box.py:grid_resolution``,
  ``train/bbox.py:compute_bbox_by_cam_frustrm``,
  ``models/sdf_voxel.py:compute_bbox_from_sdf_mask`` and the
  checkpoint's ``sdf < 0.5 -> 1e-3`` mask (``build_sdf_mask``), and
  ``train/stage_common.py``'s world-bound scale and rung deduction.

Nothing here imports the program: the benchmark hands what it makes to
the program and to the plain reference alike.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

SPHERE_RADIUS = 0.5
SDF_MASK_BAND = 0.5        # the checkpoint's mask holds nodes with sdf < 0.5
_LIGHT = (0.5, 0.7, 0.5)
_BASE_RGB = (0.2, 0.4, 0.8)


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------


def _trans_t(t):
    return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]],
                    np.float32)


def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                    np.float32)


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


def pose_spherical(theta, phi, radius) -> np.ndarray:
    """Blender ring pose (``data/synthetic.py:pose_spherical``)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    np.float32)
    return flip @ c2w


def _look_at(c: np.ndarray) -> np.ndarray:
    """OpenCV c2w rotation of a camera at ``c`` looking at the origin."""
    z = -c / np.linalg.norm(c)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], -1)


def dtu_camera_centres(n_views: int, radius: float) -> np.ndarray:
    """Rings of elevation 20-60 degrees over a 200-degree arc of azimuth
    (``chip_smoke.py:_dtu_camera_centres``)."""
    k = int(np.ceil(np.sqrt(n_views)))
    el, az = np.meshgrid(np.radians(np.linspace(20.0, 60.0, k)),
                         np.radians(np.linspace(-100.0, 100.0, k)),
                         indexing="ij")
    el, az = el.reshape(-1)[:n_views], az.reshape(-1)[:n_views]
    return radius * np.stack([np.cos(el) * np.sin(az),
                              -np.cos(el) * np.cos(az), np.sin(el)], -1)


def cameras(scene: Dict, split: str) -> Dict:
    """Poses [V, 3, 4], one K, (h, w), near, far and the ray convention
    of a scene's ``split`` ('train' or 'test') from the config's
    ``scene`` block."""
    h, w = scene["hw"]
    if scene["cameras"] == "ring":
        n = scene["n_train"] if split == "train" else scene["n_test"]
        offset = 0.0 if split == "train" else scene["test_offset_deg"]
        thetas = np.linspace(-180.0, 180.0, n, endpoint=False) + offset
        poses = np.stack([pose_spherical(t, scene["phi_deg"], scene["radius"])
                          for t in thetas])[:, :3, :4]
        focal = 0.5 * w / np.tan(0.5 * scene["camera_angle_x"])
        k = np.array([[focal, 0, 0.5 * w], [0, focal, 0.5 * h], [0, 0, 1]],
                     np.float32)
        near, far = scene["near"], scene["far"]
        inverse_y = False
    elif scene["cameras"] == "dtu_arc":
        centres = dtu_camera_centres(scene["n_views"], scene["radius"])
        test = set(scene["test_ids"])
        ids = [i for i in range(len(centres))
               if (i in test) == (split == "test")
               or (split == "train" and scene["train_all"])]
        poses = np.stack([np.concatenate([_look_at(centres[i]),
                                          centres[i][:, None]], -1)
                          for i in ids]).astype(np.float32)
        k = np.array(scene["K_full"], np.float64)
        k[:2] /= scene["reso_level"]
        k = k.astype(np.float32)
        dist = np.linalg.norm(centres[:, None] - centres, axis=-1)
        far = float(dist.max())
        near = far * scene["near_ratio"]
        inverse_y = True
    else:
        raise ValueError(f"unknown camera layout {scene['cameras']!r}")
    return dict(poses=poses.astype(np.float32), K=k, hw=(h, w), near=near,
                far=far, inverse_y=inverse_y)


def view_rays(h: int, w: int, k: np.ndarray, c2w, inverse_y: bool,
              device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pixel-centre rays of one view on ``device`` as [H*W, 3] (origin,
    direction, unit view direction); ``data/rays.py:get_rays`` with
    ``mode='center'`` and no flips."""
    k = torch.as_tensor(np.asarray(k, np.float32), device=device)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    j, i = torch.meshgrid(
        torch.linspace(0, h - 1, h, device=device),
        torch.linspace(0, w - 1, w, device=device), indexing="ij")
    i, j = i + 0.5, j + 0.5
    x = (i - k[0, 2]) / k[0, 0]
    if inverse_y:
        dirs = torch.stack([x, (j - k[1, 2]) / k[1, 1], torch.ones_like(i)], -1)
    else:
        dirs = torch.stack([x, -(j - k[1, 2]) / k[1, 1], -torch.ones_like(i)],
                           -1)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1).reshape(-1, 3)
    rays_o = c2w[:3, 3].expand(rays_d.shape).contiguous()
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_o, rays_d, viewdirs


def view_rays_host(h: int, w: int, k: np.ndarray, c2w, inverse_y: bool):
    """The same rays on the host, numpy float32, with the expressions of
    ``data/rays.py:get_rays_of_a_view`` (so the bits are the program's
    where it makes a view's rays itself): (origin, direction, unit view
    direction), each [H*W, 3]."""
    c2w = np.asarray(c2w, np.float32)
    k = np.asarray(k, np.float32)
    i, j = np.meshgrid(np.linspace(0, w - 1, w, dtype=np.float32),
                       np.linspace(0, h - 1, h, dtype=np.float32), indexing="xy")
    i, j = i + 0.5, j + 0.5
    if inverse_y:
        dirs = np.stack([(i - k[0][2]) / k[0][0], (j - k[1][2]) / k[1][1],
                         np.ones_like(i)], -1)
    else:
        dirs = np.stack([(i - k[0][2]) / k[0][0], -(j - k[1][2]) / k[1][1],
                         -np.ones_like(i)], -1)
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return tuple(np.ascontiguousarray(a, np.float32).reshape(-1, 3)
                 for a in (rays_o, rays_d, viewdirs))


def shade_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 radius: float = SPHERE_RADIUS) -> torch.Tensor:
    """The analytic glossy sphere (``data/synthetic.py:shade_sphere``):
    rgb [N, 3] on a white background."""
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    b = torch.sum(rays_o * d, -1)
    c = torch.sum(rays_o * rays_o, -1) - radius ** 2
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc > 0) & (t > 0)
    p = rays_o + d * t[:, None]
    n = p / radius
    light = torch.tensor(_LIGHT, device=d.device)
    light = light / torch.linalg.norm(light)
    lam = torch.clamp(n @ light, 0, 1)
    refl = d - 2 * torch.sum(d * n, -1, keepdim=True) * n
    spec = torch.clamp(refl @ light, 0, 1) ** 32
    base = torch.tensor(_BASE_RGB, device=d.device)
    rgb = base[None] * (0.15 + 0.85 * lam[:, None]) + 0.8 * spec[:, None]
    return torch.where(hit[:, None], torch.clamp(rgb, 0, 1),
                       torch.ones_like(rgb))


# ---------------------------------------------------------------------------
# Boxes and grids
# ---------------------------------------------------------------------------


def grid_resolution(xyz_min, xyz_max, num_voxels: int):
    """``core/box.py:grid_resolution``, float32 on purpose."""
    ext = (np.asarray(xyz_max, np.float32) - np.asarray(xyz_min, np.float32))
    voxel_size = np.power(ext.prod() / np.float32(num_voxels),
                          np.float32(1.0 / 3.0), dtype=np.float32)
    world_size = tuple(int(v) for v in (ext / voxel_size).astype(np.int64))
    return world_size, float(voxel_size)


def frustum_bbox(cams: Dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """Union of every training view's near / far points
    (``train/bbox.py:compute_bbox_by_cam_frustrm``)."""
    lo = torch.full((3,), math.inf, device=device)
    hi = -lo
    h, w = cams["hw"]
    for c2w in cams["poses"]:
        o, _, v = view_rays(h, w, cams["K"], c2w, cams["inverse_y"], device)
        for t in (cams["near"], cams["far"]):
            p = o + v * t
            lo = torch.minimum(lo, p.amin(0))
            hi = torch.maximum(hi, p.amax(0))
    return (lo.cpu().numpy().astype(np.float32),
            hi.cpu().numpy().astype(np.float32))


def grid_nodes(world_size, xyz_min, xyz_max, device) -> torch.Tensor:
    """World positions of the grid nodes [X, Y, Z, 3]."""
    axes = [torch.linspace(float(xyz_min[i]), float(xyz_max[i]),
                           world_size[i], dtype=torch.float32, device=device)
            for i in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def sphere_sdf(nodes: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(nodes, dim=-1, keepdim=True) - SPHERE_RADIUS


def geometry_sdf_mask(cfg: Dict, cams: Dict, device):
    """The geometry stage's checkpoint summary for the scene: its box
    (the camera frustum), and ``sdf < 0.5 -> 1e-3`` of the sphere's SDF
    on its grid [X, Y, Z, 1]."""
    geo_min, geo_max = frustum_bbox(cams, device)
    ws, _ = grid_resolution(geo_min, geo_max,
                            cfg["geometry_searching_model"]["num_voxels"])
    sdf = sphere_sdf(grid_nodes(ws, geo_min, geo_max, device))
    mask = torch.where(sdf < SDF_MASK_BAND, 1e-3, 0.0).to(torch.float32)
    return mask, geo_min, geo_max


def bbox_from_sdf_mask(sdf_mask: torch.Tensor, xyz_min, xyz_max):
    """``models/sdf_voxel.py:compute_bbox_from_sdf_mask`` (host)."""
    m = sdf_mask.cpu().numpy()[..., 0] > 0
    axes = [np.linspace(0.0, 1.0, n) for n in m.shape]
    interp = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    dense = xyz_min * (1 - interp) + xyz_max * interp
    active = dense[m]
    return active.min(0).astype(np.float32), active.max(0).astype(np.float32)


def stage_box(cfg: Dict, stage: str, geo_box) -> Tuple[np.ndarray, np.ndarray]:
    """The stage's box: the sdf_mask shrink, then the stage's symmetric
    world-bound scale (``train/stage_common.py:apply_world_bound_scale``)."""
    xyz_min, xyz_max = geo_box
    wbs = cfg[f"{stage}_model"].get("world_bound_scale", 1.0)
    if abs(wbs - 1.0) > 1e-9:
        shift = (xyz_max - xyz_min) * (wbs - 1.0) / 2.0
        xyz_min, xyz_max = xyz_min - shift, xyz_max + shift
    return xyz_min, xyz_max


def final_rung_voxels(cfg: Dict, stage: str) -> int:
    """The voxel budget after the stage's last progressive-scaling rung
    (``train/stage_common.py:pg_deduction`` and the rung loop)."""
    tr = cfg[f"{stage}_train"]
    n = int(cfg[f"{stage}_model"]["num_voxels"]
            / tr["scale_ratio"] ** len(tr["pg_scale"]))
    for _ in tr["pg_scale"]:
        n = int(n * tr["scale_ratio"])
    return n


# ---------------------------------------------------------------------------
# Training rays and state
# ---------------------------------------------------------------------------


def mask_cache_reach(geo_voxel: float) -> float:
    """How far from the sphere's centre the mask cache reads non-zero:
    the mask's band, one geometry voxel more for the 3^3 max-pool of
    ``build_mask_cache``, and one more for the trilinear lookup's
    footprint."""
    return SPHERE_RADIUS + SDF_MASK_BAND + 2.0 * geo_voxel


def training_rays(cams: Dict, keep_radius: float,
                  device) -> Tuple[List[torch.Tensor], int]:
    """Every training view's rays made on the device, kept where the ray
    passes within ``keep_radius`` of the sphere's centre (the region the
    mask cache holds).  Returns ([o, d, v,
    rgb] each [N, 3] float32, the count of pixels before the filter)."""
    h, w = cams["hw"]
    parts: List[List[torch.Tensor]] = [[], [], [], []]
    total = 0
    for c2w in cams["poses"]:
        o, d, v = view_rays(h, w, cams["K"], c2w, cams["inverse_y"], device)
        t_close = torch.clamp(-torch.sum(o * v, -1), min=cams["near"])
        closest = o + v * t_close[:, None]
        keep = torch.linalg.norm(closest, dim=-1) < keep_radius
        total += len(o)
        rgb = shade_sphere(o[keep], d[keep])
        for lst, a in zip(parts, (o[keep], d[keep], v[keep], rgb)):
            lst.append(a)
    return [torch.cat(p).contiguous() for p in parts], total


def _uniform(gen, shape, bound, device):
    return torch.rand(shape, generator=gen, device=device) * (2 * bound) - bound


def mlp_weights(gen, dims, device) -> Dict[str, torch.Tensor]:
    """``{'w0': [in, out], 'b0': [out], ...}`` drawn as a torch Linear
    draws them: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / math.sqrt(a)
        out[f"w{i}"] = _uniform(gen, (a, b), bound, device)
        out[f"b{i}"] = _uniform(gen, (b,), bound, device)
    return out


def stage_state(state_cfg: Dict, world_size, xyz_min, xyz_max, dims: Dict,
                seed: int, device) -> Dict[str, torch.Tensor]:
    """A stage's parameters at its final rung, from ``seed``: the sphere's
    SDF on the grid plus seeded noise, a seeded k0 and seeded MLPs, in a
    few large calls on the device."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    nodes = grid_nodes(world_size, xyz_min, xyz_max, device)
    sdf = sphere_sdf(nodes) * state_cfg["sdf_scale"]
    del nodes
    sdf = sdf + state_cfg["sdf_noise"] * torch.randn(
        sdf.shape, generator=gen, device=device)
    k0 = state_cfg["k0_std"] * torch.randn(
        (*world_size, state_cfg["k0_dim"]), generator=gen, device=device)
    params = {"sdf": sdf, "k0": k0}
    for name, d in dims.items():
        params[name] = mlp_weights(gen, d, device)
    params["s_val"] = torch.full((1,), state_cfg["s_start"],
                                 dtype=torch.float32, device=device)
    return params
