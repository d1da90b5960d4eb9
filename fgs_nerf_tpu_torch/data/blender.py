"""Blender-synthetic dataset loader (`data/blender.py:43-94`), reading
its PNG frames with ``eval/image_io.py``; ``half_res`` is the 2 x 2
area mean (OpenCV's INTER_AREA at an exact factor of 2)."""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from fgs_nerf_tpu_torch.data.synthetic import pose_spherical
from fgs_nerf_tpu_torch.eval.image_io import read_png


def load_blender_data(basedir: str, half_res=False, testskip=1) -> Dict:
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(read_png(fname))
            poses.append(np.array(frame["transform_matrix"], np.float32))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(np.array(poses))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    h, w = imgs[0].shape[:2]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)

    render_poses = np.stack(
        [pose_spherical(a, -30.0, 4.0) for a in np.linspace(-180, 180, 41)[:-1]], 0
    )

    if half_res:
        h, w, focal = h // 2, w // 2, focal / 2.0
        imgs = imgs[:, :2 * h, :2 * w].reshape(
            len(imgs), h, 2, w, 2, -1).mean(axis=(2, 4)).astype(np.float32)

    return dict(
        images=imgs,
        poses=poses,
        render_poses=render_poses,
        hwf=[int(h), int(w), float(focal)],
        i_split=i_split,
    )
