"""Dataset dispatcher with the reference's ``data_dict`` contract
(`data/dataset.py:21-272`): keys HW, Ks, near, far, i_train/val/test,
poses, render_poses, images, masks, scale_mats_np, irregular_shape.

Every ``dataset_type`` of the JAX package is read: the procedural
``synthetic`` scene, ``blender``, ``dtu``, ``llff``, ``nsvf``,
``tankstemple``, ``blendedmvs``, ``deepvoxels``, the IDR-style
``volsdf_bmvs``, ``mobile_brick`` and ``scannet``, ``co3d``, ``nerfpp``
and ``ILSH``.  Images must be PNG (the machine with the card has no JPEG
decoder): a JPEG capture raises ``NotImplementedError`` naming the file.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

_SUPPORTED = ("blender", "dtu", "llff", "nsvf", "tankstemple", "blendedmvs",
              "deepvoxels", "volsdf_bmvs", "mobile_brick", "scannet", "co3d",
              "nerfpp", "ILSH", "synthetic")


def inward_nearfar_heuristic(cam_o: np.ndarray, ratio: float = 0.05):
    """`lib/load_data.py:252-256`."""
    dist = np.linalg.norm(cam_o[:, None] - cam_o, axis=-1)
    far = float(dist.max())
    return far * ratio, far


def _llff_split(n: int, llffhold: int, i_hold: int):
    """Every ``llffhold``-th view held out for test and val, else the view
    nearest the mean pose (`data/dataset.py:66-73`)."""
    i_test = (np.arange(n)[::llffhold] if llffhold > 0
              else np.array([i_hold]))
    i_train = np.array([i for i in range(n) if i not in i_test])
    return i_train, i_test, i_test


def _composite_alpha(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    """RGBA onto a white or black background (`data/dataset.py:37-41`)."""
    if images.shape[-1] != 4:
        return images
    if white_bkgd:
        return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
    return images[..., :3] * images[..., -1:]


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
    if dtype == "blender":
        from fgs_nerf_tpu_torch.data.blender import load_blender_data

        out = load_blender_data(d.datadir, d.get("half_res", False),
                                d.get("testskip", 1))
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        near, far = 2.0, 6.0
        images = _composite_alpha(images, d.white_bkgd)
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
    elif dtype == "llff":
        from fgs_nerf_tpu_torch.data.llff import load_llff_data

        images, poses, bds, render_poses, i_hold = load_llff_data(
            d.datadir, d.get("factor", 1), recenter=True,
            bd_factor=1, spherify=d.get("spherify", False),
        )
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        i_train, i_val, i_test = _llff_split(len(images),
                                             d.get("llffhold", 8), i_hold)
        if d.get("ndc", False):
            near, far = 0.0, 1.0
        else:
            near, far = float(bds.min()) * 0.9, float(bds.max())
        hwf = [int(hwf[0]), int(hwf[1]), float(hwf[2])]
    elif dtype == "nsvf":
        from fgs_nerf_tpu_torch.data.nsvf import load_nsvf_data

        out = load_nsvf_data(d.datadir)
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
        images = _composite_alpha(images, d.white_bkgd)
    elif dtype in ("tankstemple", "blendedmvs"):
        from fgs_nerf_tpu_torch.data import nsvf_like

        _ld = (nsvf_like.load_tankstemple_data if dtype == "tankstemple"
               else nsvf_like.load_blendedmvs_data)
        out = _ld(d.datadir)
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        k = out["K"]
        ratio = 0.0 if dtype == "tankstemple" else 0.05
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=ratio)
        images = _composite_alpha(images, d.white_bkgd)
    elif dtype == "deepvoxels":
        from fgs_nerf_tpu_torch.data.deepvoxels import load_dv_data

        scene = os.path.basename(d.datadir.rstrip(os.sep))
        out = load_dv_data(
            scene, os.path.dirname(d.datadir.rstrip(os.sep)),
            d.get("testskip", 1),
        )
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
        near, far = hemi_r - 1.0, hemi_r + 1.0
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
    elif dtype == "co3d":
        from fgs_nerf_tpu_torch.data.co3d import load_co3d_data

        out = load_co3d_data(
            d.datadir, d.annot_path, d.split_path, d.sequence_name
        )
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        k = out["K"]
        masks = out["masks"]
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0)
        # per-image composite (shapes can differ, `lib/load_data.py:155-159`)
        for i in range(len(images)):
            m = masks[i][..., None]
            if d.white_bkgd:
                images[i] = images[i] * m + (1.0 - m)
            else:
                images[i] = images[i] * m
    elif dtype == "nerfpp":
        from fgs_nerf_tpu_torch.data.nerfpp import load_nerfpp_data

        out = load_nerfpp_data(d.datadir)
        images, poses = out["images"], out["poses"]
        render_poses, hwf = out["render_poses"], out["hwf"]
        i_train, i_val, i_test = out["i_split"]
        k = out["K"]
        # unbounded capture: near pinned to 0 (`lib/load_data.py:161-166`)
        _, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0.02)
        near = 0.0
    elif dtype == "ILSH":
        from fgs_nerf_tpu_torch.data.ilsh import load_ilsh_data

        out = load_ilsh_data(
            d.datadir, d.get("factor", 1), recenter=True, bd_factor=1,
            spherify=d.get("spherify", False),
            load_depths=d.get("load_depths", False),
        )
        images, poses = out["images"], out["poses"]
        bds, masks = out["bds"], out["masks"]
        render_poses = out["render_poses"]
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        i_train, i_val, i_test = _llff_split(len(images),
                                             d.get("llffhold", 8),
                                             out["i_test"])
        if d.get("ndc", False):
            near, far = 0.0, 1.0
        else:
            near, far = float(bds.min()) * 0.9, float(bds.max())
        hwf = [int(hwf[0]), int(hwf[1]), float(hwf[2])]
    else:
        raise NotImplementedError(
            f"dataset_type {dtype!r}; supported: {', '.join(_SUPPORTED)}")

    h, w, focal = hwf
    h, w = int(h), int(w)
    hw = np.array([im.shape[:2] for im in images])
    irregular = getattr(images, "dtype", None) == object
    if k is None:
        k = np.array([[focal, 0, 0.5 * w], [0, focal, 0.5 * h], [0, 0, 1]])
    ks = k[None].repeat(len(poses), axis=0) if k.ndim == 2 else k
    if masks is None:
        masks = images.mean(-1) > 0  # brightness mask (`data/dataset.py:247-248`)
    elif not irregular and masks.ndim == 4:
        masks = masks.mean(-1)
    if not irregular:
        images = np.asarray(images, np.float32)
        masks = np.asarray(masks, np.float32)
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
        images=images,
        masks=masks,
        irregular_shape=irregular,
        scale_mats_np=scale_mats_np,
        **extras,
    )
