"""DTU / IDR-style dataset loader, the port's copy of
``fgs_nerf_tpu/data/dtu.py`` (`lib/load_dtu.py:13-107`).

Cameras come as projection matrices ``world_mat @ scale_mat`` in
``cameras_sphere.npz``; each is decomposed into K / R / t.  Masked
composite onto a white or black background, optional integer
down-sampling (reso_level), fixed test ids [8, 13, 16, 21, 26, 31, 34]
(+56 for big scans), and the first scale_mat returned for world-space
mesh export.

Two differences from the JAX module, since the machine with the card has
neither OpenCV nor an image package: the projection matrix is decomposed
with ``scipy.linalg.rq`` under OpenCV's sign convention (the same K, R
and camera centre as ``cv2.decomposeProjectionMatrix``), and images and
masks are read with ``eval/image_io.py:read_png``.  A scan stored as
JPEG raises ``NotImplementedError``: there is no JPEG decoder here.
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, List

import numpy as np


def _rq_opencv(m: np.ndarray):
    """(K, R) with M = K R, K upper triangular with K[0, 0], K[1, 1] > 0
    and R a proper rotation: the unique factors that OpenCV's
    ``RQDecomp3x3`` returns for a non-singular M (its Givens rotations
    give a proper R, and it flips pairs of signs until the first two
    diagonal entries are positive)."""
    from scipy.linalg import rq

    k, r = rq(m)
    s = np.sign(np.diag(k))
    s[s == 0] = 1.0
    s[2] = s[0] * s[1] * np.sign(np.linalg.det(r))
    d = np.diag(s)
    return k @ d, d @ r


def load_K_Rt_from_P(p: np.ndarray):
    """Decompose a 3x4 projection matrix into intrinsics + c2w pose (IDR
    convention, `lib/load_dtu.py:13-34`): K normalised by K[2, 2], R^T
    as the rotation, and the camera centre (the homogeneous null vector
    of P over its 4th entry) as the translation."""
    p = np.asarray(p, np.float64)
    k, r = _rq_opencv(p[:3, :3])
    _, _, vt = np.linalg.svd(p)
    c = vt[-1]
    k = k / k[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = k
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = r.transpose()
    pose[:3, 3] = c[:3] / c[3]
    return intrinsics, pose


def _resize_batch(imgs: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-equivalent of the reference's un-aligned
    ``F.interpolate(size=(H, W))`` (default mode='nearest')."""
    n, h0, w0, c = imgs.shape
    yi = (np.arange(h) * (h0 / h)).astype(np.int64)
    xi = (np.arange(w) * (w0 / w)).astype(np.int64)
    return imgs[:, yi][:, :, xi]


def read_image(path: str) -> np.ndarray:
    """An 8-bit PNG as float32 in [0, 1] (``imread(path) / 255.0``);
    any other file raises."""
    from fgs_nerf_tpu_torch.eval.image_io import read_png

    if not path.lower().endswith(".png"):
        raise NotImplementedError(
            f"{path}: the port reads PNG images only (no JPEG decoder is "
            "available); convert the scan's images to PNG")
    return (read_png(path) / 255.0).astype(np.float32)


def sorted_glob(*parts: str) -> List[str]:
    return sorted(glob(os.path.join(*parts)))


def load_dtu_data(
    basedir: str, normalize=True, reso_level=2, mask=True, white_bg=True
) -> Dict:
    rgb_paths = sorted_glob(basedir, "image", "*png")
    if not rgb_paths:
        rgb_paths = sorted_glob(basedir, "image", "*jpg")
    if not rgb_paths:
        rgb_paths = sorted_glob(basedir, "rgb", "*png")
    mask_paths = sorted_glob(basedir, "mask", "*png")
    if not mask_paths:
        mask_paths = sorted_glob(basedir, "mask", "*jpg")

    name = "cameras_sphere.npz" if normalize else "cameras_large.npz"
    cams = np.load(os.path.join(basedir, name))
    world_mats = [cams[f"world_mat_{i}"].astype(np.float32) for i in range(len(rgb_paths))]
    scale_mats = (
        [cams[f"scale_mat_{i}"].astype(np.float32) for i in range(len(rgb_paths))]
        if normalize else None
    )

    imgs, poses, masks_l, intr = [], [], [], []
    for i, (wm, im_name) in enumerate(zip(world_mats, rgb_paths)):
        p = (wm @ scale_mats[i]) if normalize else wm
        k, pose = load_K_Rt_from_P(p[:3, :4])
        intr.append(k)
        poses.append(pose)
        imgs.append(read_image(im_name))
        if mask_paths:
            m = read_image(mask_paths[i])
            masks_l.append(m[..., :3] if m.ndim == 3 else m[..., None])
    imgs = np.stack(imgs)
    poses = np.stack(poses)
    masks = np.stack(masks_l) if masks_l else None
    h, w = imgs[0].shape[:2]
    k = intr[0]
    focal = float(k[0, 0])

    if mask:
        assert masks is not None, "DTU masked composite requires mask/ images"
        bg = 1.0 if white_bg else 0.0
        imgs = imgs * masks + bg * (1 - masks)

    if reso_level > 1:
        h, w = int(h / reso_level), int(w / reso_level)
        imgs = _resize_batch(imgs, h, w)
        if masks is not None:
            masks = _resize_batch(masks, h, w)
        k = k.copy()
        k[:2] /= reso_level
        focal /= reso_level

    i_test = [8, 13, 16, 21, 26, 31, 34]
    if len(imgs) * 0.1 >= 8:
        i_test.append(56)
    i_test = [i for i in i_test if i < len(imgs)]
    i_train = sorted(set(range(len(imgs))) - set(i_test))
    i_split = [np.array(i_train), np.array(i_test), np.array(i_test)]

    return dict(
        images=imgs,
        poses=poses,
        render_poses=poses[i_split[-1]],
        hwf=[h, w, focal],
        K=k[:3, :3],
        i_split=i_split,
        scale_mats_np=scale_mats[0] if scale_mats else None,
        masks=masks,
    )
