"""Scene bbox estimation on the host (`train/bbox.py`): the camera
frustum union for the geometry stage and the shrink to the geometry
checkpoint's sdf_mask for the later stages."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from fgs_nerf_tpu_torch.data.rays import get_rays_of_a_view
from fgs_nerf_tpu_torch.models.sdf_voxel import compute_bbox_from_sdf_mask
from fgs_nerf_tpu_torch.train.checkpoint import load_checkpoint


def compute_bbox_by_cam_frustrm(cfg, data_dict: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Union of the near/far frustum points over all train views
    (`train/bbox.py:12-33`)."""
    xyz_min = np.full(3, np.inf, np.float32)
    xyz_max = -xyz_min
    hw = np.asarray(data_dict["HW"])
    ks = np.asarray(data_dict["Ks"])
    poses = np.asarray(data_dict["poses"])
    near, far = float(data_dict["near"]), float(data_dict["far"])
    for i in np.asarray(data_dict["i_train"]):
        h, w = hw[i]
        rays_o, _, viewdirs = get_rays_of_a_view(
            int(h), int(w), ks[i], poses[i],
            ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
            flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y,
        )
        pts_nf = np.stack([rays_o + viewdirs * near, rays_o + viewdirs * far])
        xyz_min = np.minimum(xyz_min, pts_nf.min(axis=(0, 1, 2)))
        xyz_max = np.maximum(xyz_max, pts_nf.max(axis=(0, 1, 2)))
    return xyz_min.astype(np.float32), xyz_max.astype(np.float32)


def compute_bbox_by_coarse_geo(ckpt_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Bbox shrink from the saved sdf_mask (`train/bbox.py:36-43`)."""
    ckpt = load_checkpoint(ckpt_path)
    xyz_min, xyz_max = ckpt.box
    return compute_bbox_from_sdf_mask(ckpt.sdf_mask, xyz_min, xyz_max)
