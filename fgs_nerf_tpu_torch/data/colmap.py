"""COLMAP capture preprocessing: the sparse-model reader, the LLFF
``poses_bounds`` rows and the ``colmap`` pipeline.

Port of ``fgs_nerf_tpu/data/colmap.py``, host code on numpy and
``struct`` alone (no tensors):

* :func:`read_model` parses a COLMAP binary sparse reconstruction
  (cameras, images, points3D) in the documented file format.
* :func:`colmap_to_poses_bounds` converts it to the LLFF
  ``poses_bounds.npy`` convention ([down right back] 3x5 matrices +
  per-view near/far from visible point depths).
* :func:`run_colmap` shells out to a ``colmap`` binary when one is on
  ``PATH`` (feature extraction -> matching -> mapper), else raises.  The
  machine with the card has no ``colmap`` (and no ``cv2`` for
  :func:`extract_video_frames`): run these steps where they are
  installed, or bring the capture with a reconstructed ``sparse/0``.
"""
from __future__ import annotations

import os
import shutil
import struct
import subprocess
from typing import Dict, NamedTuple, Tuple

import numpy as np


class Camera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class Image(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
    ])


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cam_id] = Camera(cam_id, name, int(width), int(height), params)
    return out


def read_images_bin(path) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, "<Q")
            data = np.array(_read(f, f"<{n_pts * 3}d")).reshape(-1, 3)
            out[img_id] = Image(
                img_id, qvec, tvec, cam_id, name.decode(),
                data[:, :2], data[:, 2].astype(np.int64),
            )
    return out


def read_points3d_bin(path) -> Tuple[np.ndarray, Dict[int, int]]:
    """Returns (xyz [P, 3], id -> row index)."""
    xyzs = []
    id2idx = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for i in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            f.read(3)  # rgb
            f.read(8)  # error
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
            id2idx[pid] = i
            xyzs.append(xyz)
    return np.array(xyzs), id2idx


def read_model(sparse_dir: str):
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    pts, id2idx = read_points3d_bin(os.path.join(sparse_dir, "points3D.bin"))
    return cams, imgs, pts, id2idx


def colmap_to_poses_bounds(sparse_dir: str) -> np.ndarray:
    """COLMAP sparse model -> LLFF poses_bounds rows
    (`lib/colmap_poses/pose_utils.py` semantics): c2w = [R^T | -R^T t]
    in the [down right back] column convention + hwf, bounds from the
    0.1/99.9 depth percentiles of each view's visible points."""
    cams, imgs, pts, id2idx = read_model(sparse_dir)
    rows = []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        cam = cams[img.camera_id]
        # params[0] for every model: fx where the model has fx and fy
        focal = cam.params[0]
        r = qvec2rotmat(img.qvec)
        t = img.tvec.reshape(3, 1)
        w2c = np.concatenate([r, t], 1)
        c2w = np.concatenate(
            [r.T, (-r.T @ t)], 1
        )
        # world->llff convention: columns [down, right, back]
        m = np.concatenate(
            [c2w[:, 1:2], c2w[:, 0:1], -c2w[:, 2:3], c2w[:, 3:4]], 1
        )
        hwf = np.array([cam.height, cam.width, focal]).reshape(3, 1)
        pose35 = np.concatenate([m, hwf], 1)  # [3, 5]

        vis = img.point3d_ids[img.point3d_ids >= 0]
        if len(vis):
            p = pts[[id2idx[v] for v in vis if v in id2idx]]
            z = (w2c[:3, :3] @ p.T + w2c[:3, 3:4])[2]
            close, inf = np.percentile(z, 0.1), np.percentile(z, 99.9)
        else:
            close, inf = 0.1, 10.0
        rows.append(np.concatenate([pose35.ravel(), [close, inf]]))
    return np.array(rows, np.float64)


def run_colmap(basedir: str, match_type: str = "exhaustive_matcher") -> str:
    """Pose-estimate a capture with the colmap CLI
    (`lib/colmap_poses/colmap_wrapper.py:24` pipeline); writes
    poses_bounds.npy and returns its path."""
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "colmap binary not found; provide a pre-reconstructed "
            "sparse/0 model or install COLMAP"
        )
    db = os.path.join(basedir, "database.db")
    sparse = os.path.join(basedir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    steps = [
        ["colmap", "feature_extractor", "--database_path", db,
         "--image_path", os.path.join(basedir, "images"),
         "--ImageReader.single_camera", "1"],
        ["colmap", match_type, "--database_path", db],
        ["colmap", "mapper", "--database_path", db,
         "--image_path", os.path.join(basedir, "images"),
         "--output_path", sparse],
    ]
    for cmd in steps:
        subprocess.run(cmd, check=True)
    rows = colmap_to_poses_bounds(os.path.join(sparse, "0"))
    out = os.path.join(basedir, "poses_bounds.npy")
    np.save(out, rows)
    return out


def extract_video_frames(video_path: str, out_dir: str, fps: float = 2.0) -> int:
    """Video -> frame pngs (`run_colmap.py` video path), decoded and
    written by cv2.  Where cv2 is not installed (the machine with the
    card) this raises ``ModuleNotFoundError`` naming ``cv2``."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    stride = max(int(round(native_fps / fps)), 1)
    i = saved = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            cv2.imwrite(os.path.join(out_dir, f"{saved:05d}.png"), frame)
            saved += 1
        i += 1
    cap.release()
    return saved
