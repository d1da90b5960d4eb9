"""Capture preprocessing: normalize cameras to the IDR/NeuS convention
and write ``cameras_sphere.npz`` (the contract consumed by the DTU
loader).  Port of ``fgs_nerf_tpu/data/preprocess.py`` (numpy host code).

The reference pipeline (`lib/preprocess/preprocess_cameras.py:135-196`,
`convert_cameras.py:14-191`) estimates the object's centroid + scale
from mask-constrained triangulations (visual hull).  The normalization
here is the linear-init variant: the scene center is the least-squares
nearest point to all camera optical axes and the scale places cameras
at ~unit-sphere distance — functionally equivalent for inward captures
and mask-free.  ``scale_mat = diag(s, s, s, 1) + center`` maps the unit
sphere into world coordinates, matching ``P = world_mat @ scale_mat``
decomposition on load (`lib/load_dtu.py:58-66`).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from fgs_nerf_tpu_torch.data.colmap import qvec2rotmat, read_model


def nearest_point_to_rays(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Least-squares point minimizing distance to all rays."""
    d = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = np.eye(3)[None] - d[:, :, None] * d[:, None, :]
    b = (a @ origins[:, :, None])[..., 0]
    return np.linalg.lstsq(a.sum(0), b.sum(0), rcond=None)[0]


def normalize_cameras(
    intrinsics: Sequence[np.ndarray],  # [V] of [3,3]
    w2c: Sequence[np.ndarray],  # [V] of [3,4] world->camera
    radius_scale: float = 3.0,
) -> Dict[str, np.ndarray]:
    """Returns per-view ``world_mat_i`` (P = K @ w2c) and a shared
    ``scale_mat`` normalizing the captured object into the unit sphere."""
    origins, axes = [], []
    world_mats = {}
    for i, (k, rt) in enumerate(zip(intrinsics, w2c)):
        r, t = np.asarray(rt)[:, :3], np.asarray(rt)[:, 3]
        c = -r.T @ t  # camera center
        origins.append(c)
        axes.append(r.T @ np.array([0.0, 0.0, 1.0]))  # optical axis
        p = np.eye(4, dtype=np.float32)
        p[:3, :4] = np.asarray(k) @ np.asarray(rt)
        world_mats[f"world_mat_{i}"] = p
    origins = np.asarray(origins)
    axes = np.asarray(axes)
    center = nearest_point_to_rays(origins, axes)
    dist = np.linalg.norm(origins - center, axis=-1).mean()
    scale = dist / radius_scale
    scale_mat = np.eye(4, dtype=np.float32)
    scale_mat[0, 0] = scale_mat[1, 1] = scale_mat[2, 2] = scale
    scale_mat[:3, 3] = center
    out = dict(world_mats)
    for i in range(len(intrinsics)):
        out[f"scale_mat_{i}"] = scale_mat
    return out


def write_cameras_sphere(
    out_dir: str,
    intrinsics: Sequence[np.ndarray],
    w2c: Sequence[np.ndarray],
    radius_scale: float = 3.0,
) -> str:
    cams = normalize_cameras(intrinsics, w2c, radius_scale)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cameras_sphere.npz")
    np.savez(path, **cams)
    return path


def colmap_to_idr(sparse_dir: str, out_dir: str, radius_scale: float = 3.0) -> str:
    """COLMAP sparse model -> cameras_sphere.npz (the
    ``convert_cameras`` step of `run_colmap.py`)."""
    cams, imgs, _, _ = read_model(sparse_dir)
    ks, rts = [], []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        cam = cams[img.camera_id]
        if cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params[:4]
        else:
            fx = fy = cam.params[0]
            cx, cy = cam.params[1:3]
        ks.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32))
        r = qvec2rotmat(img.qvec)
        rts.append(np.concatenate([r, img.tvec.reshape(3, 1)], 1).astype(np.float32))
    return write_cameras_sphere(out_dir, ks, rts, radius_scale)


def mask_with_rembg(image_dir: str, mask_dir: str) -> Optional[int]:
    """Foreground masking via rembg when available (`run_colmap.py`
    rembg step); returns the mask count or None if rembg is absent.
    Images are read and masks written as PNG (``eval/image_io.py``): a
    JPEG capture raises ``NotImplementedError`` naming the file."""
    try:
        from rembg import remove  # type: ignore
    except Exception:
        return None
    from fgs_nerf_tpu_torch.data.llff import image_files
    from fgs_nerf_tpu_torch.eval.image_io import read_png, write_png

    os.makedirs(mask_dir, exist_ok=True)
    count = 0
    for path in image_files(image_dir):
        cut = remove(read_png(path))
        mask = (cut[..., 3:] > 0).astype(np.uint8) * 255
        write_png(os.path.join(mask_dir, os.path.basename(path)),
                  mask.repeat(3, axis=-1))
        count += 1
    return count
