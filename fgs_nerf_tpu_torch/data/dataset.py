"""Dataset dispatcher with the reference's ``data_dict`` contract
(`data/dataset.py:21-272`): keys HW, Ks, near, far, i_train/val/test,
poses, render_poses, images, masks, scale_mats_np, irregular_shape.

The port reads the procedural ``synthetic`` scene and ``blender``
captures; every other ``dataset_type`` of the JAX package raises
``NotImplementedError`` until its loader is ported (ROADMAP item A10).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_NOT_PORTED = ("dtu", "llff", "nsvf", "tankstemple", "blendedmvs",
               "deepvoxels", "volsdf_bmvs", "mobile_brick", "scannet", "co3d",
               "nerfpp", "ILSH")


def load_dataset(cfg) -> Dict:
    d = cfg.data
    dtype = d.dataset_type
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
            "the port reads: blender, synthetic")
    if dtype != "blender":
        raise NotImplementedError(
            f"dataset_type {dtype!r}; supported: blender, synthetic")

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

    h, w, focal = hwf
    h, w = int(h), int(w)
    hw = np.array([im.shape[:2] for im in images])
    k = np.array([[focal, 0, 0.5 * w], [0, focal, 0.5 * h], [0, 0, 1]])
    ks = k[None].repeat(len(poses), axis=0)
    masks = images.mean(-1) > 0  # brightness mask (`data/dataset.py:247-248`)
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
        scale_mats_np=None,
    )
