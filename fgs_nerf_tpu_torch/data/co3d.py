"""CO3D sequence loader, the port's copy of ``fgs_nerf_tpu/data/co3d.py``
(`lib/load_co3d.py:12-84`).

Annotations come as a gzip'd JSON list over all sequences of a
category; the split JSON maps split names containing ``known`` to
training image paths.  Views with empty masks are dropped; camera
intrinsics convert PyTorch3D NDC principal point / focal length to
pixels; poses are ``inv([R|T])``.  Per-view image shapes may differ, so
images/masks are returned as object arrays (the reference's
``irregular_shape`` path).  Images and masks are read as PNG
(``data/dtu.py:read_image``; a grayscale mask reads as [H, W]): a
sequence with JPEG frames raises ``NotImplementedError`` until they are
converted.
"""
from __future__ import annotations

import gzip
import json
import os
from typing import Dict

import numpy as np

from fgs_nerf_tpu_torch.data.dtu import read_image


def load_co3d_data(
    datadir: str, annot_path: str, split_path: str, sequence_name: str
) -> Dict:
    with gzip.open(annot_path, "rt", encoding="utf8") as zf:
        annot = [v for v in json.load(zf) if v["sequence_name"] == sequence_name]
    with open(split_path) as f:
        split = json.load(f)
    train_im_path, test_im_path = set(), set()
    for k, lst in split.items():
        for v in lst:
            if v[0] == sequence_name:
                (train_im_path if "known" in k else test_im_path).add(v[-1])
    assert len(annot) == len(train_im_path) + len(test_im_path), (
        f"Mismatch: {len(annot)} != {len(train_im_path) + len(test_im_path)}"
    )

    imgs, masks, poses, ks = [], [], [], []
    i_split = [[], []]
    removed = [0, 0]
    for meta in annot:
        im_fname = meta["image"]["path"]
        sid = 0 if im_fname in train_im_path else 1
        if meta["mask"]["mass"] == 0:
            removed[sid] += 1
            continue
        mask = read_image(os.path.join(datadir, meta["mask"]["path"]))
        if mask.max() < 0.5:
            removed[sid] += 1
            continue
        rt = np.concatenate(
            [np.asarray(meta["viewpoint"]["R"]),
             np.asarray(meta["viewpoint"]["T"])[:, None]], 1
        )
        poses.append(np.linalg.inv(np.concatenate([rt, [[0, 0, 0, 1]]])))
        imgs.append(read_image(os.path.join(datadir, im_fname)))
        masks.append(mask)
        assert imgs[-1].shape[:2] == tuple(meta["image"]["size"])
        # PyTorch3D NDC -> pixel intrinsics (`lib/load_co3d.py:57-66`)
        half_wh = np.float32(meta["image"]["size"][::-1]) * 0.5
        pp = np.float32(meta["viewpoint"]["principal_point"])
        fl = np.float32(meta["viewpoint"]["focal_length"])
        pp_px = -1.0 * (pp - 1.0) * half_wh
        fl_px = fl * half_wh
        ks.append(np.array([
            [fl_px[0], 0, pp_px[0]], [0, fl_px[1], pp_px[1]], [0, 0, 1],
        ]))
        i_split[sid].append(len(imgs) - 1)

    def _maybe_object(arrs):
        if len({a.shape for a in arrs}) == 1:
            return np.stack([a.astype(np.float32) for a in arrs], 0)
        out = np.empty(len(arrs), dtype=object)
        for i, a in enumerate(arrs):
            out[i] = a.astype(np.float32)
        return out

    imgs = _maybe_object(imgs)
    masks = _maybe_object(masks)
    poses = np.stack(poses, 0).astype(np.float32)
    ks = np.stack(ks, 0).astype(np.float32)
    i_split.append(list(i_split[-1]))
    render_poses = poses[np.asarray(i_split[-1], int)]
    h, w = np.array([im.shape[:2] for im in imgs]).mean(0).astype(int)
    focal = float(ks[:, [0, 1], [0, 1]].mean())
    return dict(
        images=imgs, masks=masks, poses=poses, render_poses=render_poses,
        hwf=[int(h), int(w), focal], K=ks,
        i_split=[np.asarray(s, int) for s in i_split], removed=removed,
    )
