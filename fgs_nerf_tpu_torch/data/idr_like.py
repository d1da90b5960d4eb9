"""IDR-convention secondary loaders, the port's copy of
``fgs_nerf_tpu/data/idr_like.py``: VolSDF-BlendedMVS, MobileBrick,
ScanNet (MonoSDF preprocessing).

All three read an IDR-style ``cameras.npz`` of projection matrices and
decompose each into K / c2w with DTU's helper (``data/dtu.py:
load_K_Rt_from_P``).  Images are read as PNG (``data/dtu.py:read_image``):
VolSDF-BlendedMVS and MobileBrick captures ship JPEGs, which raise
``NotImplementedError`` until they are converted.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from fgs_nerf_tpu_torch.data.dtu import (
    _resize_batch, load_K_Rt_from_P, read_image, sorted_glob,
)


def load_vbmvs_data(
    basedir: str, normalize: bool = False, reso_level: int = 1, mask: bool = False
) -> Dict:
    """VolSDF-format BlendedMVS (`lib/load_volsdf_bmvs.py:36-82`).

    ``cameras.npz`` holds raw ``world_mat_i`` (P = world_mat unless
    ``normalize``, in which case P = world_mat @ scale_mat); images are
    jpg, masks optional png; test split is every 6th view.
    """
    rgb_paths = sorted_glob(basedir, "image", "*jpg")
    if not rgb_paths:
        rgb_paths = sorted_glob(basedir, "image", "*png")
    mask_paths = sorted_glob(basedir, "mask", "*png")
    cams = np.load(os.path.join(basedir, "cameras.npz"))
    imgs, poses, masks, intr = [], [], [], []
    for i, im_name in enumerate(rgb_paths):
        world_mat = cams[f"world_mat_{i}"].astype(np.float32)
        p = (world_mat @ cams[f"scale_mat_{i}"].astype(np.float32)
             if normalize else world_mat)[:3, :4]
        k, pose = load_K_Rt_from_P(p)
        intr.append(k)
        poses.append(pose)
        imgs.append(read_image(im_name))
        if mask_paths:
            masks.append(read_image(mask_paths[i]))
    imgs = np.stack(imgs, 0)
    poses = np.stack(poses, 0)
    masks_np = np.stack(masks, 0) if masks else None
    if mask:
        imgs = imgs * (masks_np if masks_np.ndim == 4 else masks_np[..., None])
    h, w = imgs[0].shape[:2]
    if reso_level > 1:
        h, w = h // reso_level, w // reso_level
        imgs = _resize_batch(imgs, h, w)
    focal = intr[0][0, 0] / reso_level
    i_all = np.arange(len(imgs))
    i_split = [i_all, i_all[::6], i_all[::6]]
    return dict(
        images=imgs, poses=poses, render_poses=poses[i_split[-1]],
        hwf=[int(h), int(w), float(focal)], K=intr[0][:3, :3],
        i_split=i_split, masks=masks_np,
    )


def load_mobilebrick_data(
    basedir: str, normalize: bool = True, reso_level: int = 2,
    mask: bool = False, white_bg: bool = False,
) -> Dict:
    """MobileBrick capture (`lib/load_mobilebrick.py:37-96`): IDR
    cameras, masked composite onto white/black, integer downsample with
    K rescale, test ids ``(i-3) % 8 == 0``, first scale_mat returned for
    world-space meshes.
    """
    rgb_paths = sorted_glob(basedir, "image", "*jpg")
    if not rgb_paths:
        rgb_paths = sorted_glob(basedir, "image", "*png")
    mask_paths = sorted_glob(basedir, "mask", "*png")
    cams = np.load(os.path.join(basedir, "cameras.npz"))
    scale_mats = (
        [cams[f"scale_mat_{i}"].astype(np.float32) for i in range(len(rgb_paths))]
        if normalize else None
    )
    imgs, poses, masks, intr = [], [], [], []
    for i, im_name in enumerate(rgb_paths):
        world_mat = cams[f"world_mat_{i}"].astype(np.float32)
        p = (world_mat @ scale_mats[i] if normalize else world_mat)[:3, :4]
        k, pose = load_K_Rt_from_P(p)
        intr.append(k)
        poses.append(pose)
        imgs.append(read_image(im_name))
        if mask_paths:
            m = read_image(mask_paths[i])
            masks.append(m[..., :3] if m.ndim == 3 else m[..., None])
    imgs = np.stack(imgs, 0)
    poses = np.stack(poses, 0)
    masks_np = np.stack(masks, 0) if masks else np.ones_like(imgs[..., :1])
    if mask:
        bg = 1.0 if white_bg else 0.0
        imgs = imgs * masks_np + bg * (1.0 - masks_np)
    h, w = imgs[0].shape[:2]
    k = intr[0].copy()
    focal = intr[0][0, 0]
    if reso_level > 1:
        h, w = int(h / reso_level), int(w / reso_level)
        imgs = _resize_batch(imgs, h, w)
        masks_np = _resize_batch(masks_np, h, w)
        k[:2] /= reso_level
        focal /= reso_level
    i_test = np.array([i for i in range(len(imgs)) if (i - 3) % 8 == 0])
    i_train = np.array(sorted(set(range(len(imgs))) - set(i_test.tolist())))
    i_split = [i_train, i_test, i_test]
    return dict(
        images=imgs, poses=poses, render_poses=poses[i_split[-1]],
        hwf=[int(h), int(w), float(focal)], K=k[:3, :3], i_split=i_split,
        scale_mats_np=scale_mats[0] if scale_mats else None, masks=masks_np,
    )


_CENTER_CROPS = {
    # (scale, cx offset) applied to intrinsics after MonoSDF's 384x384
    # resize+crop (`lib/load_scannet.py:106-127`)
    "center_crop_for_replica": (384 / 680, (1200 - 680) * 0.5),
    "center_crop_for_tnt": (384 / 540, (960 - 540) * 0.5),
    "center_crop_for_dtu": (384 / 1200, (1600 - 1200) * 0.5),
    "padded_for_dtu": (384 / 1200, 0.0),
    "no_crop": None,
}


def load_scannet_data(
    data_dir: str, center_crop_type: str = "no_crop", use_mask: bool = False
) -> Dict:
    """MonoSDF-preprocessed ScanNet scenes (`lib/load_scannet.py:58-180`):
    ``*_rgb.png`` images, monocular ``*_depth.npy`` / ``*_normal.npy``
    priors (normals stored in [0,1], remapped to [-1,1] and HWC), IDR
    cameras with P = world_mat @ scale_mat, every-10th-view test split.
    """
    image_paths = sorted_glob(data_dir, "*_rgb.png")
    depth_paths = sorted_glob(data_dir, "*_depth.npy")
    normal_paths = sorted_glob(data_dir, "*_normal.npy")
    mask_paths = sorted_glob(data_dir, "*_mask.npy") if use_mask else []
    n = len(image_paths)
    cams = np.load(os.path.join(data_dir, "cameras.npz"))
    scale_mats = [cams[f"scale_mat_{i}"].astype(np.float32) for i in range(n)]
    world_mats = [cams[f"world_mat_{i}"].astype(np.float32) for i in range(n)]

    crop = _CENTER_CROPS[center_crop_type]
    poses, intr = [], []
    for scale_mat, world_mat in zip(scale_mats, world_mats):
        k, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
        if crop is not None:
            scale, offset = crop
            k[0, 2] -= offset
            k[:2, :] *= scale
        intr.append(k)
        poses.append(pose)
    imgs = np.stack([read_image(p) for p in image_paths], 0)
    poses = np.stack(poses, 0)
    depths = (
        np.stack([np.load(p) for p in depth_paths], 0) if depth_paths else None
    )
    normals = None
    if normal_paths:
        normals = np.stack(
            [np.transpose(np.load(p) * 2.0 - 1.0, (1, 2, 0)) for p in normal_paths], 0
        )
    if mask_paths:
        masks = np.stack([np.load(p) for p in mask_paths], 0)
    else:
        masks = np.ones_like(imgs[..., :1])
    h, w = imgs[0].shape[:2]
    i_all = np.arange(n)
    i_split = [i_all, i_all[::10], i_all[::10]]
    return dict(
        images=imgs, poses=poses, render_poses=poses[i_split[-1]],
        hwf=[int(h), int(w), float(intr[0][0, 0])], K=intr[0][:3, :3],
        i_split=i_split, scale_mats_np=scale_mats[0], masks=masks,
        depths=depths, normals=normals,
    )
