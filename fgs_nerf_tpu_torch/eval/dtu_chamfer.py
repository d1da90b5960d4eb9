"""DTU Chamfer-distance evaluation, the port's copy of
``fgs_nerf_tpu/eval/dtu_chamfer.py`` (DTUeval-style, `model/dtu_eval.py:
37-187`): dense point sampling of the predicted mesh, kd-tree
density downsampling, ObsMask / bounding-box filtering, then symmetric
nearest-neighbor distances (d2s + s2d above the ground plane).

Differences from the reference: vectorized numpy triangle sampling
instead of a multiprocessing pool, scipy cKDTree instead of sklearn,
and trimesh-free PLY IO.  The math (0.2mm density threshold, 60mm
patch, 20mm outlier cutoff, 10mm ObsMask grid) is identical.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

from fgs_nerf_tpu_torch.eval.mesh import read_ply


def sample_mesh_points(
    verts: np.ndarray, tris: np.ndarray, thresh: float
) -> np.ndarray:
    """Densify the mesh into a point cloud with ~``thresh`` spacing
    (`model/dtu_eval.py:19-89`): barycentric lattice per triangle with
    counts floor(edge / thr), thr = thresh * sqrt(l1 l2 / 2A)."""
    tri_vert = verts[tris]
    v1 = tri_vert[:, 1] - tri_vert[:, 0]
    v2 = tri_vert[:, 2] - tri_vert[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    keep = area2 > 0
    v1, v2, l1, l2, area2 = v1[keep], v2[keep], l1[keep], l2[keep], area2[keep]
    base = tri_vert[keep][:, 0]
    thr = thresh * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(np.int64)
    n2 = np.floor(l2 / thr).astype(np.int64)

    # group triangles by (n1, n2) so each group samples on one lattice
    out = [verts]
    pairs = np.stack([n1, n2], -1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    for u_idx, (a, b) in enumerate(uniq):
        sel = inv == u_idx
        c0, c1 = np.mgrid[: a + 1, : b + 1].astype(np.float64) + 0.5
        c0 /= max(a, 1e-7)
        c1 /= max(b, 1e-7)
        k = np.stack([c0, c1], -1).reshape(-1, 2)
        k = k[k.sum(-1) < 1]  # inside the triangle
        if len(k) == 0:
            continue
        # [T_sel, K, 3]
        pts = (
            v1[sel][:, None, :] * k[None, :, :1]
            + v2[sel][:, None, :] * k[None, :, 1:]
            + base[sel][:, None, :]
        )
        out.append(pts.reshape(-1, 3))
    return np.concatenate(out, axis=0)


def density_downsample(pts: np.ndarray, radius: float, seed: int = 0) -> np.ndarray:
    """Greedy radius-based downsample (`model/dtu_eval.py:92-106`)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pts))
    pts = pts[order]
    tree = cKDTree(pts)
    neighbor_lists = tree.query_ball_point(pts, r=radius, workers=-1)
    mask = np.ones(len(pts), bool)
    for cur, idxs in enumerate(neighbor_lists):
        if mask[cur]:
            mask[idxs] = False
            mask[cur] = True
    return pts[mask]


def dtu_chamfer(
    mesh_path: str,
    scene: int,
    dataset_dir: str,
    eval_dir: str,
    suffix: str = "",
    max_dist: float = 20.0,
    runtime: bool = False,
) -> Tuple[float, float, float]:
    """(mean_d2s, mean_s2d, overall); writes result{suffix}.txt
    (`model/dtu_eval.py:37-187`)."""
    from scipy.io import loadmat

    patch = 60
    thresh = 0.5 if runtime else 0.2

    verts, tris = read_ply(mesh_path)
    data_pcd = sample_mesh_points(verts.astype(np.float64), tris, thresh)
    data_down = density_downsample(data_pcd, thresh)

    obs = loadmat(os.path.join(dataset_dir, "ObsMask", f"ObsMask{scene}_10.mat"))
    obs_mask, bb, res = obs["ObsMask"], obs["BB"].astype(np.float32), obs["Res"]

    inbound = (
        (data_down >= bb[:1] - patch) & (data_down < bb[1:] + patch * 2)
    ).sum(-1) == 3
    data_in = data_down[inbound]
    data_grid = np.around((data_in - bb[:1]) / res).astype(np.int32)
    grid_inbound = (
        (data_grid >= 0) & (data_grid < np.expand_dims(obs_mask.shape, 0))
    ).sum(-1) == 3
    data_grid_in = data_grid[grid_inbound]
    in_obs = obs_mask[
        data_grid_in[:, 0], data_grid_in[:, 1], data_grid_in[:, 2]
    ].astype(bool)
    data_in_obs = data_in[grid_inbound][in_obs]

    stl, _ = read_ply(
        os.path.join(dataset_dir, "Points", "stl", f"stl{scene:03}_total.ply")
    )
    stl = stl.astype(np.float64)
    if runtime:
        skip = max(stl.shape[0] // max(data_in_obs.shape[0] * 2, 1), 1)
        stl = stl[::skip]

    dist_d2s, _ = cKDTree(stl).query(data_in_obs, k=1, workers=-1)
    mean_d2s = float(dist_d2s[dist_d2s < max_dist].mean())

    plane = loadmat(os.path.join(dataset_dir, "ObsMask", f"Plane{scene}.mat"))["P"]
    stl_hom = np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
    above = (plane.reshape(1, 4) * stl_hom).sum(-1) > 0
    stl_above = stl[above]
    dist_s2d, _ = cKDTree(data_in).query(stl_above, k=1, workers=-1)
    mean_s2d = float(dist_s2d[dist_s2d < max_dist].mean())

    over_all = (mean_d2s + mean_s2d) / 2
    os.makedirs(eval_dir, exist_ok=True)
    with open(os.path.join(eval_dir, f"result{suffix}.txt"), "w") as f:
        f.write(f"{mean_d2s} {mean_s2d} {over_all}")
    return mean_d2s, mean_s2d, over_all
