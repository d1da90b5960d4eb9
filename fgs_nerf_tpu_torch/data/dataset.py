"""Dataset dispatcher with the reference's ``data_dict`` contract
(`data/dataset.py:21-272`): keys HW, Ks, near, far, i_train/val/test,
poses, render_poses, images, masks, scale_mats_np, irregular_shape.

The port reads the procedural ``synthetic`` scene, ``blender`` captures,
DTU scans and the IDR-style ``volsdf_bmvs``, ``mobile_brick`` and
``scannet`` captures (PNG images only: ``data/dtu.py:read_image``);
every other ``dataset_type`` of the JAX package raises
``NotImplementedError`` until its loader is ported (ROADMAP item A10).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_NOT_PORTED = ("llff", "nsvf", "tankstemple", "blendedmvs", "deepvoxels",
               "co3d", "nerfpp", "ILSH")
_PORTED = ("blender", "dtu", "volsdf_bmvs", "mobile_brick", "scannet",
           "synthetic")


def inward_nearfar_heuristic(cam_o: np.ndarray, ratio: float = 0.05):
    """`lib/load_data.py:252-256`."""
    dist = np.linalg.norm(cam_o[:, None] - cam_o, axis=-1)
    far = float(dist.max())
    return far * ratio, far


def load_dataset(cfg) -> Dict:
    d = cfg.data
    dtype = d.dataset_type
    scale_mats_np = None
    masks = None
    k = None
    extras = {}

    if dtype == "synthetic":
        from fgs_nerf_tpu_torch.data.synthetic import make_synthetic_dataset

        return make_synthetic_dataset(
            n_views=int(d.get("synthetic_views", 12)),
            h=int(d.get("synthetic_hw", 64)),
            w=int(d.get("synthetic_hw", 64)),
            n_test=int(d.get("synthetic_test", 2)),
        )
    if dtype in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset_type {dtype!r} is not ported yet (ROADMAP item A10); "
            f"the port reads: {', '.join(_PORTED)}")
    if dtype == "blender":
        from fgs_nerf_tpu_torch.data.blender import load_blender_data

        out = load_blender_data(d.datadir, d.get("half_res", False),
                                d.get("testskip", 1))
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        near, far = 2.0, 6.0
        if images.shape[-1] == 4:
            if d.white_bkgd:
                images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
            else:
                images = images[..., :3] * images[..., -1:]
    elif dtype == "dtu":
        from fgs_nerf_tpu_torch.data.dtu import load_dtu_data

        out = load_dtu_data(
            d.datadir, reso_level=cfg.get("reso_level", 2),
            mask=True, white_bg=d.white_bkgd,
        )
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        # train_all=True for DTU (`lib/load_data.py:78-79`)
        i_train = np.arange(len(images))
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
        scale_mats_np = out["scale_mats_np"]
        masks = out["masks"]
        k = out["K"]
    elif dtype == "volsdf_bmvs":
        from fgs_nerf_tpu_torch.data.idr_like import load_vbmvs_data

        out = load_vbmvs_data(d.datadir)
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        k = out["K"]
        masks = out["masks"]
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
    elif dtype == "mobile_brick":
        from fgs_nerf_tpu_torch.data.idr_like import load_mobilebrick_data

        out = load_mobilebrick_data(
            d.datadir, reso_level=cfg.get("reso_level", 2),
            mask=d.get("load_mask", True), white_bg=d.white_bkgd,
        )
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        k = out["K"]
        masks = out["masks"]
        scale_mats_np = out["scale_mats_np"]
        if d.get("train_all", True):
            i_train = np.arange(len(images))
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
    elif dtype == "scannet":
        from fgs_nerf_tpu_torch.data.idr_like import load_scannet_data

        out = load_scannet_data(
            d.datadir, d.get("center_crop_type", "no_crop"),
            d.get("use_mask", False),
        )
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        k = out["K"]
        masks = out["masks"]
        scale_mats_np = out["scale_mats_np"]
        if d.get("train_all", True):
            i_train = np.arange(len(images))
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
        extras = {"depths": out["depths"], "normals": out["normals"]}
    else:
        raise NotImplementedError(
            f"dataset_type {dtype!r}; supported: {', '.join(_PORTED)}")

    h, w, focal = hwf
    h, w = int(h), int(w)
    hw = np.array([im.shape[:2] for im in images])
    if k is None:
        k = np.array([[focal, 0, 0.5 * w], [0, focal, 0.5 * h], [0, 0, 1]])
    ks = k[None].repeat(len(poses), axis=0) if k.ndim == 2 else k
    if masks is None:
        masks = images.mean(-1) > 0  # brightness mask (`data/dataset.py:247-248`)
    elif masks.ndim == 4:
        masks = masks.mean(-1)
    return dict(
        hwf=[h, w, focal],
        HW=hw,
        Ks=ks,
        near=near,
        far=far,
        i_train=np.asarray(i_train),
        i_val=np.asarray(i_val),
        i_test=np.asarray(i_test),
        poses=np.asarray(poses),
        render_poses=np.asarray(render_poses)[..., :4],
        images=np.asarray(images, np.float32),
        masks=np.asarray(masks, np.float32),
        irregular_shape=False,
        scale_mats_np=scale_mats_np,
        **extras,
    )
