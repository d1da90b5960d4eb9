"""DeepVoxels dataset loader, the port's copy of
``fgs_nerf_tpu/data/deepvoxels.py`` (`lib/load_deepvoxels.py:6-95`):
train/validation/test splits in separate directories, 512^2 images,
intrinsics.txt with focal/center/near/scale, poses flipped from the
world2cam y-down convention.  Images are read with
``eval/image_io.py:read_png``.
"""
from __future__ import annotations

import os

import numpy as np

from fgs_nerf_tpu_torch.eval.image_io import read_png


def _parse_intrinsics(path, trgt_sidelength):
    with open(path) as f:
        vals = list(map(float, f.readline().split()))
        focal, cx, cy = vals[:3]
        f.readline()  # grid barycenter
        f.readline()  # near plane
        f.readline()  # scale
        height, width = map(float, f.readline().split())
    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    focal = trgt_sidelength / height * focal
    return focal, cx, cy


def _dir2poses(posedir):
    poses = np.stack(
        [
            np.loadtxt(os.path.join(posedir, f)).reshape(4, 4)
            for f in sorted(os.listdir(posedir)) if f.endswith("txt")
        ],
        0,
    )
    transf = np.diag([1.0, -1.0, -1.0, 1.0])
    return (poses @ transf)[:, :3, :4].astype(np.float32)


def _load_rgb_dir(d):
    files = [f for f in sorted(os.listdir(d)) if f.endswith("png")]
    return np.stack(
        [read_png(os.path.join(d, f)) / 255.0 for f in files], 0
    ).astype(np.float32)


def load_dv_data(scene: str, basedir: str, testskip: int = 1):
    h = w = 512
    base = os.path.join(basedir, "train", scene)
    focal, _, _ = _parse_intrinsics(os.path.join(base, "intrinsics.txt"), h)

    poses = _dir2poses(os.path.join(base, "pose"))
    testposes = _dir2poses(os.path.join(basedir, "test", scene, "pose"))[::testskip]
    valposes = _dir2poses(os.path.join(basedir, "validation", scene, "pose"))[::testskip]

    imgs = _load_rgb_dir(os.path.join(base, "rgb"))
    testimgs = _load_rgb_dir(os.path.join(basedir, "test", scene, "rgb"))[::testskip]
    valimgs = _load_rgb_dir(os.path.join(basedir, "validation", scene, "rgb"))[::testskip]

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    images = np.concatenate(all_imgs, 0)
    all_poses = np.concatenate([poses, valposes, testposes], 0).astype(np.float32)
    render_poses = testposes
    return dict(
        images=images, poses=all_poses, render_poses=render_poses,
        hwf=[h, w, float(focal)], i_split=i_split,
    )
