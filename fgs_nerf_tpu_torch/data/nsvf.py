"""NSVF-format loader, the port's copy of ``fgs_nerf_tpu/data/nsvf.py``
(`lib/load_nsvf.py:38-61`): per-view pose txt files + rgb pngs whose
filename's first digit selects the split, and a shared intrinsics.txt
focal.  Images are read with ``eval/image_io.py:read_png``."""
from __future__ import annotations

import os
from glob import glob

import numpy as np

from fgs_nerf_tpu_torch.data.synthetic import pose_spherical
from fgs_nerf_tpu_torch.eval.image_io import read_png


def load_nsvf_data(basedir: str):
    pose_paths = sorted(glob(os.path.join(basedir, "pose", "*txt")))
    rgb_paths = sorted(glob(os.path.join(basedir, "rgb", "*png")))
    all_poses, all_imgs = [], []
    i_split = [[], [], []]
    for i, (pose_path, rgb_path) in enumerate(zip(pose_paths, rgb_paths)):
        i_set = int(os.path.split(rgb_path)[-1][0])
        all_imgs.append((read_png(rgb_path) / 255.0).astype(np.float32))
        all_poses.append(np.loadtxt(pose_path).astype(np.float32))
        i_split[i_set].append(i)
    imgs = np.stack(all_imgs, 0)
    poses = np.stack(all_poses, 0)
    h, w = imgs[0].shape[:2]
    with open(os.path.join(basedir, "intrinsics.txt")) as f:
        focal = float(f.readline().split()[0])
    render_poses = np.stack(
        [pose_spherical(a, -30.0, 4.0) for a in np.linspace(-180, 180, 41)[:-1]], 0
    )
    return dict(
        images=imgs, poses=poses, render_poses=render_poses,
        hwf=[int(h), int(w), focal],
        i_split=[np.array(s) for s in i_split],
    )
