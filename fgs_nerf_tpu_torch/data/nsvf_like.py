"""NSVF-convention secondary loaders, the port's copy of
``fgs_nerf_tpu/data/nsvf_like.py``: Tanks&Temples and BlendedMVS
(`lib/load_tankstemple.py:11-46`, `lib/load_blendedmvs.py:11-40`).

Both share the pose/*.txt + rgb/*.png layout with the split encoded in
the filename's first digit and a full K in intrinsics.txt; T&T keeps
the 50 nearest views to view 0 for training and reads an optional
test_traj.txt render path.  Images are read with
``eval/image_io.py:read_png``.
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np

from fgs_nerf_tpu_torch.eval.image_io import read_png


def _load_posed_images(basedir, n_splits=2):
    pose_paths = sorted(glob(os.path.join(basedir, "pose", "*txt")))
    rgb_paths = sorted(glob(os.path.join(basedir, "rgb", "*png")))
    poses, imgs = [], []
    i_split = [[] for _ in range(n_splits)]
    for i, (pp, rp) in enumerate(zip(pose_paths, rgb_paths)):
        i_set = int(os.path.split(rp)[-1][0])
        imgs.append((read_png(rp) / 255.0).astype(np.float32))
        poses.append(np.loadtxt(pp).astype(np.float32))
        i_split[i_set].append(i)
    return np.stack(imgs), np.stack(poses), i_split


def load_tankstemple_data(basedir: str):
    imgs, poses, i_split = _load_posed_images(basedir)
    i_split.append(list(i_split[-1]))
    k = np.loadtxt(os.path.join(basedir, "intrinsics.txt"))
    h, w = imgs[0].shape[:2]
    # keep the 50 nearest views to view 0 (`load_tankstemple.py:35-38`)
    ref_pos = poses[0][:, -1]
    dist = ((poses[:, :, -1] - ref_pos[None]) ** 2).sum(-1)
    i_split[0] = np.argsort(dist)[:50].tolist()
    traj = os.path.join(basedir, "test_traj.txt")
    if os.path.isfile(traj):
        render_poses = np.loadtxt(traj).reshape(-1, 4, 4).astype(np.float32)
    else:
        render_poses = poses[i_split[-1]]
    return dict(
        images=imgs, poses=poses, render_poses=render_poses,
        hwf=[int(h), int(w), float(k[0, 0])], K=k[:3, :3],
        i_split=[np.array(s) for s in i_split],
    )


def load_blendedmvs_data(basedir: str):
    imgs, poses, i_split = _load_posed_images(basedir)
    i_split.append(list(i_split[-1]))
    k = np.loadtxt(os.path.join(basedir, "intrinsics.txt"))
    h, w = imgs[0].shape[:2]
    render_poses = (
        np.loadtxt(os.path.join(basedir, "test_traj.txt"))
        .reshape(-1, 4, 4).astype(np.float32)
    )
    return dict(
        images=imgs, poses=poses, render_poses=render_poses,
        hwf=[int(h), int(w), float(k[0, 0])], K=k[:3, :3],
        i_split=[np.array(s) for s in i_split],
    )
