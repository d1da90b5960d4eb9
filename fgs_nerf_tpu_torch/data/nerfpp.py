"""NeRF++ unbounded-capture loader, the port's copy of
``fgs_nerf_tpu/data/nerfpp.py`` (`lib/load_nerfpp.py:28-164`).

Layout: ``{train,test}/{intrinsics,pose,rgb}/*.txt|png`` (opencv/colmap
camera convention, one shared 4x4 intrinsic), plus a
``camera_path`` movie trajectory whose render poses are focal-rescaled
to the training intrinsics.  ``rerotate`` aligns the capture's minor
PCA axis (cameras-up) with -y.  Images are read as PNG
(``data/dtu.py:read_image``): a capture with JPEG images raises
``NotImplementedError`` until they are converted.
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict

import numpy as np

from fgs_nerf_tpu_torch.data.dtu import read_image


def _find(dirpath: str, exts) -> list:
    files = []
    for ext in exts:
        files.extend(glob(os.path.join(dirpath, ext)))
    return sorted(files)


def _load_split(split_dir: str, skip: int = 1):
    intr = _find(os.path.join(split_dir, "intrinsics"), ["*.txt"])[::skip]
    pose = _find(os.path.join(split_dir, "pose"), ["*.txt"])[::skip]
    imgs = _find(os.path.join(split_dir, "rgb"), ["*.png", "*.jpg"])[::skip]
    assert len(imgs) == len(pose), f"{len(imgs)} imgs != {len(pose)} poses"
    return intr, pose, imgs


def rerotate_poses(poses: np.ndarray, render_poses: np.ndarray):
    """`lib/load_nerfpp.py:74-102`."""
    from scipy.spatial.transform import Rotation

    poses = np.copy(poses)
    centroid = poses[:, :3, 3].mean(0)
    poses[:, :3, 3] -= centroid
    x = poses[:, :3, 3]
    cov = np.cov((x - x.mean(0)).T)
    ev, eig = np.linalg.eig(cov)
    cams_up = eig[:, np.argmin(ev)].real
    if cams_up[1] < 0:
        cams_up = -cams_up
    r = Rotation.align_vectors([[0, -1, 0]], cams_up[None])[0].as_matrix()
    poses[:, :3, :3] = r @ poses[:, :3, :3]
    poses[:, :3, [3]] = r @ poses[:, :3, [3]]
    poses[:, :3, 3] += centroid
    render_poses = np.copy(render_poses)
    render_poses[:, :3, 3] -= centroid
    render_poses[:, :3, :3] = r @ render_poses[:, :3, :3]
    render_poses[:, :3, [3]] = r @ render_poses[:, :3, [3]]
    render_poses[:, :3, 3] += centroid
    return poses, render_poses


def load_nerfpp_data(basedir: str, rerotate: bool = True) -> Dict:
    tr_k, tr_c2w, tr_im = _load_split(os.path.join(basedir, "train"))
    te_k, te_c2w, te_im = _load_split(os.path.join(basedir, "test"))
    i_split = [list(range(len(tr_c2w))),
               list(range(len(tr_c2w), len(tr_c2w) + len(te_c2w)))]

    k_flat = np.loadtxt(tr_k[0])
    for path in tr_k + te_k:
        assert np.allclose(np.loadtxt(path), k_flat)
    k = k_flat.reshape(4, 4)[:3, :3]

    poses = np.stack(
        [np.loadtxt(p).reshape(4, 4) for p in tr_c2w + te_c2w], 0
    ).astype(np.float32)
    imgs = np.stack([read_image(p) for p in tr_im + te_im], 0)
    i_split.append(list(i_split[1]))
    h, w = imgs.shape[1:3]
    focal = float(k[[0, 1], [0, 1]].mean())

    traj = sorted(glob(os.path.join(basedir, "camera_path", "pose", "*txt")))
    if traj:
        render_poses = np.array(
            [np.loadtxt(p).reshape(4, 4) for p in traj], np.float32
        )
        render_k = np.loadtxt(
            glob(os.path.join(basedir, "camera_path", "intrinsics", "*txt"))[0]
        ).reshape(4, 4)[:3, :3]
        render_poses[:, :, 0] *= k[0, 0] / render_k[0, 0]
        render_poses[:, :, 1] *= k[1, 1] / render_k[1, 1]
    else:
        render_poses = poses[np.asarray(i_split[-1], int)]
    if rerotate:
        poses, render_poses = rerotate_poses(poses, render_poses)
    return dict(
        images=imgs, poses=poses, render_poses=render_poses,
        hwf=[int(h), int(w), focal], K=k,
        i_split=[np.asarray(s, int) for s in i_split],
    )
