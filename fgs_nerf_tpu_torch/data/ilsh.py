"""ILSH (light-stage head) loader, the port's copy of
``fgs_nerf_tpu/data/ilsh.py`` (`lib/load_ILSH.py:278-355`).

An LLFF-derived format: ``poses_bounds.npy`` + ``images/`` +
``mask/`` (+ optional COLMAP ``stereo/depth_maps/*.geometric.bin``).
Reuses the LLFF pose machinery and image reading (``data/llff.py``: PNG
only, ``area_resize`` for ``factor``); default ``bd_factor=1`` per the
reference dispatcher (`lib/load_data.py:182-186`).
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict

import numpy as np

from fgs_nerf_tpu_torch.data.llff import image_files, llff_poses, read_resized


def read_colmap_depth(path: str) -> np.ndarray:
    """COLMAP ``*.geometric.bin`` depth map (`lib/load_ILSH.py:16-31`):
    an ASCII ``w&h&c&`` header followed by little-endian f32 in
    column-major order."""
    with open(path, "rb") as fid:
        width, height, channels = np.genfromtxt(
            fid, delimiter="&", max_rows=1, usecols=(0, 1, 2), dtype=int
        )
        fid.seek(0)
        num_delim = 0
        while num_delim < 3:
            if fid.read(1) == b"&":
                num_delim += 1
        array = np.fromfile(fid, np.float32)
    array = array.reshape((width, height, channels), order="F")
    return np.transpose(array, (1, 0, 2)).squeeze()


def load_ilsh_data(
    basedir: str, factor: int = 1, recenter: bool = True, bd_factor: float = 1.0,
    spherify: bool = False, load_depths: bool = False,
) -> Dict:
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    imgs = read_resized(image_files(os.path.join(basedir, "images")), factor)
    imgs = np.stack([im[..., :3] for im in imgs])
    mask_dir = os.path.join(basedir, "mask")
    if os.path.isdir(mask_dir):
        masks = np.stack(read_resized(image_files(mask_dir), factor))
    else:
        masks = np.ones_like(imgs[..., 0])
    depths = None
    if load_depths:
        dfiles = sorted(
            glob(os.path.join(basedir, "stereo", "depth_maps", "*.geometric.bin"))
        )
        depths = np.stack([read_colmap_depth(f) for f in dfiles], 0)

    poses, bds, render_poses, i_test, sc = llff_poses(
        poses_arr, imgs[0].shape[:2], factor, recenter, bd_factor, spherify)
    if depths is not None:
        depths = depths * sc
    return dict(
        images=imgs.astype(np.float32), depths=depths,
        poses=poses.astype(np.float32), bds=bds,
        render_poses=render_poses, i_test=i_test, masks=masks,
    )
