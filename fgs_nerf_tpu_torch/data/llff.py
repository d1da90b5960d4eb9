"""LLFF / COLMAP-forward-facing loader, the port's copy of
``fgs_nerf_tpu/data/llff.py`` (`lib/load_llff.py:271-348`).

poses_bounds.npy rows are 3x5 camera matrices ([down right back]
convention + hwf column) plus near/far bounds; loading converts to the
[right up back] convention, rescales by 1/(bds.min()*bd_factor),
optionally recenters around the average pose and spherifies inward
captures, and synthesizes a spiral (or circular) render path.

The machine with the card has neither an image package nor OpenCV, so
images are read with ``eval/image_io.py:read_png`` (a scan whose images
are JPEG raises ``NotImplementedError``: convert them to PNG), and the
``factor`` down-sampling is ``area_resize``, a numpy copy of OpenCV's
``INTER_AREA`` on uint8 images that gives the same bytes.
"""
from __future__ import annotations

import math
import os
from glob import glob
from typing import List, Tuple

import numpy as np

from fgs_nerf_tpu_torch.eval.image_io import read_png

_DBL_EPSILON = 2.220446049250313e-16


def _area_tab(ssize: int, dsize: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: for each output index the
    source indices it covers and their float32 weights, in order.
    Returns (dst [K], src [K], alpha [K] f32)."""
    dst, src, alpha = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            dst.append(dx)
            src.append(sx1 - 1)
            alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            dst.append(dx)
            src.append(sx)
            alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            dst.append(dx)
            src.append(sx2)
            alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return np.array(dst), np.array(src), np.array(alpha, np.float32)


def _slots(dst: np.ndarray, dsize: int):
    """The tab regrouped by position within each output index: per slot t,
    (the tab entries that are the t-th of their output index [K] bool,
    the output indices that have a t-th entry [dsize] bool), so that the
    sums run slot by slot in the tab's order."""
    counts = np.bincount(dst, minlength=dsize)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(dst)) - first[dst]
    out = []
    for t in range(int(counts.max())):
        sel = pos == t
        present = np.zeros(dsize, bool)
        present[dst[sel]] = True
        out.append((sel, present))
    return out


def area_resize(img: np.ndarray, w_new: int, h_new: int) -> np.ndarray:
    """``cv2.resize(img, (w_new, h_new), interpolation=cv2.INTER_AREA)``
    for a uint8 [H, W] or [H, W, C] image that shrinks on both axes,
    byte for byte.

    OpenCV takes one of two paths.  When both scales are integers it sums
    each block in integers and rounds: ``(sum + 2) >> 2`` for 2 x 2
    blocks of 1, 3 or 4 channels (its vector path), otherwise
    ``rint(float32(sum) * float32(1 / area))`` (round half to even).  Any
    other scale takes its general path: per-axis weight tables, each
    source row summed into a float32 row buffer in the table's order,
    rows combined with their float32 weights, and the result rounded half
    to even."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"area_resize: expects uint8, got {img.dtype}")
    h, w = img.shape[:2]
    if not (0 < w_new <= w and 0 < h_new <= h):
        raise ValueError(f"area_resize: {w}x{h} -> {w_new}x{h_new} does not "
                         "shrink")
    sx = 1.0 / (w_new / w)
    sy = 1.0 / (h_new / h)
    ix, iy = int(round(sx)), int(round(sy))
    cn = 1 if img.ndim == 2 else img.shape[2]
    # OpenCV returns [H, W] for one channel, as given [H, W] or [H, W, 1]
    shape = (h_new, w_new) if cn == 1 else (h_new, w_new, cn)
    if abs(sx - ix) < _DBL_EPSILON and abs(sy - iy) < _DBL_EPSILON:
        blk = img.reshape(h_new, iy, w_new, ix, cn).astype(np.int32)
        blk = blk.sum(axis=(1, 3))
        if ix == 2 and iy == 2 and cn in (1, 3, 4):
            out = (blk + 2) >> 2
        else:
            out = np.rint(blk.astype(np.float32)
                          * np.float32(1.0 / (ix * iy)))
        return np.clip(out, 0, 255).astype(np.uint8).reshape(shape)

    x = img.reshape(h, w, cn).astype(np.float32)
    xd, xs, xa = _area_tab(w, w_new, sx)
    # columns: buf[:, dx] = sum over the tab's entries of dx, in order
    buf = np.zeros((h, w_new, cn), np.float32)
    for sel, present in _slots(xd, w_new):
        term = np.zeros((h, w_new, cn), np.float32)
        term[:, present] = x[:, xs[sel]] * xa[sel][:, None]
        buf = np.where(present[None, :, None], buf + term, buf)
    yd, ys, ya = _area_tab(h, h_new, sy)
    out = np.zeros((h_new, w_new, cn), np.float32)
    for t, (sel, present) in enumerate(_slots(yd, h_new)):
        term = np.zeros((h_new, w_new, cn), np.float32)
        term[present] = ya[sel][:, None, None] * buf[ys[sel]]
        out = np.where(present[:, None, None],
                       term if t == 0 else out + term, out)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(shape)


def image_files(dirpath: str) -> List[str]:
    """The sorted jpg / jpeg / png files of ``dirpath``; raises
    ``NotImplementedError`` naming the first JPEG among them."""
    files = sorted(f for f in glob(os.path.join(dirpath, "*"))
                   if f.lower().endswith(("jpg", "jpeg", "png")))
    jpegs = [f for f in files if not f.lower().endswith("png")]
    if jpegs:
        raise NotImplementedError(
            f"{jpegs[0]}: the port reads PNG images only (no JPEG decoder "
            "is available); convert the scan's images to PNG")
    return files


def read_resized(files: List[str], factor: int) -> List[np.ndarray]:
    """Each PNG as float32 in [0, 1], area-shrunk by ``factor`` first
    (``w // factor`` x ``h // factor``) when ``factor > 1``."""
    out = []
    for f in files:
        im = read_png(f)
        if factor and factor > 1:
            h, w = im.shape[:2]
            im = area_resize(im, w // factor, h // factor)
        out.append((im / 255.0).astype(np.float32))
    return out


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec1_avg = up
    vec0 = _normalize(np.cross(vec1_avg, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def _recenter_poses(poses):
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = _poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    p = np.concatenate([poses[:, :3, :4], bottom], -2)
    p = np.linalg.inv(c2w) @ p
    poses_[:, :3, :4] = p[:, :3, :4]
    return poses_


def _render_path_spiral(c2w, up, rads, focal, zrate, rots, n):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads,
        )
        z = _normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    return render_poses


def _spherify_poses(poses, bds):
    """`lib/load_llff.py:211-268`."""
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]),
                        [p.shape[0], 1, 1])], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -a_i @ rays_o
        return np.squeeze(
            -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0))
            @ (b_i).mean(0)
        )

    center = min_line_dist(rays_o, rays_d)
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    pos = center
    c2w = np.stack([vec1, vec2, vec0, pos], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        p = np.stack([vec0, vec1, vec2, camorigin], 1)
        new_poses.append(p)
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
        -1,
    )
    poses_reset = np.concatenate(
        [
            poses_reset[:, :3, :4],
            np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
        ],
        -1,
    )
    return poses_reset, new_poses, bds


def llff_poses(poses_arr: np.ndarray, img_hw, factor: int, recenter: bool,
               bd_factor, spherify: bool):
    """The pose half of the LLFF loader (`lib/load_llff.py:276-340`):
    poses_bounds rows -> (poses [N, 3, 5], bds [N, 2], render_poses,
    i_test), for images of size ``img_hw`` after the ``factor`` shrink."""
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])
    poses[:2, 4, :] = np.array(img_hw).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / (factor or 1)

    # [down right back] -> [right up back] (`lib/load_llff.py:281`)
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = _recenter_poses(poses)
    if spherify:
        poses, render_poses, bds = _spherify_poses(poses, bds)
    else:
        c2w = _poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        render_poses = _render_path_spiral(
            c2w, up, rads, focal, zrate=0.5, rots=2, n=120
        )
    render_poses = np.array(render_poses, np.float32)

    c2w = _poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    return poses, bds, render_poses, int(np.argmin(dists)), sc


def load_llff_data(
    basedir: str, factor: int = 1, recenter=True, bd_factor=0.75,
    spherify=False,
) -> Tuple:
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    imgs = np.stack([im[..., :3] for im in read_resized(
        image_files(os.path.join(basedir, "images")), factor)])
    poses, bds, render_poses, i_test, _ = llff_poses(
        poses_arr, imgs[0].shape[:2], factor, recenter, bd_factor, spherify)
    return imgs.astype(np.float32), poses, bds, render_poses, i_test
