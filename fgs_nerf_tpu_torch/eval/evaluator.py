"""Evaluation entry: render the test set and extract the mesh from a
trained checkpoint (`eval/evaluator.py`).  Parameters go to the port's
device; the mesh field queries run there, the triangulation on the host.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device
from fgs_nerf_tpu_torch.eval.mesh import extract_geometry, write_ply
from fgs_nerf_tpu_torch.eval.render import make_render_fn, render_viewpoints
from fgs_nerf_tpu_torch.models import sdf_voxel as M
from fgs_nerf_tpu_torch.ops.interp import trilinear_sample
from fgs_nerf_tpu_torch.ops.stencils import smooth_grid
from fgs_nerf_tpu_torch.optim.masked_adam import tree_map
from fgs_nerf_tpu_torch.train.checkpoint import load_checkpoint


def rebuild_model(ckpt_path: str, geo_ckpt_path: Optional[str] = None,
                  device: DeviceLike = None):
    """(params, buffers, cfg_model, box, ckpt) from a checkpoint: the saved
    model_kwargs rebuild the static config, the geometry checkpoint the
    mask cache (`eval/evaluator.py:23-45`)."""
    dev = resolve_device(device)
    ckpt = load_checkpoint(ckpt_path)
    kw = dict(ckpt.meta["model_kwargs"])
    for key in ("grad_feat", "sdf_feat", "k_grad_feat", "k_sdf_feat",
                "world_size"):
        if key in kw and isinstance(kw[key], list):
            kw[key] = tuple(kw[key])
    cfg_model = M.SDFModelConfig(**kw)
    xyz_min, xyz_max = ckpt.box
    box = SceneBox.create(xyz_min, xyz_max, dev)
    params = tree_map(lambda a: torch.as_tensor(np.asarray(a), device=dev),
                      ckpt.params)
    buffers = {}
    if (geo_ckpt_path and os.path.exists(geo_ckpt_path)
            and cfg_model.stage != "geometry_searching"):
        geo = load_checkpoint(geo_ckpt_path)
        pmin, pmax = geo.box
        buffers["mask_cache"] = M.build_mask_cache(
            torch.as_tensor(geo.sdf_mask, device=dev), pmin, pmax)
    return params, buffers, cfg_model, box, ckpt


def extract_mesh_from_params(params, cfg_model, box: SceneBox, resolution: int,
                             scale_mats_np=None):
    """The -SDF isosurface at 0, in world space through scale_mats
    (`eval/evaluator.py:48-70`)."""
    sdf_grid = params["sdf"]
    if cfg_model.smooth_sdf:
        sdf_grid = smooth_grid(sdf_grid, cfg_model.smooth_ksize,
                               cfg_model.smooth_sigma)
    dev = sdf_grid.device

    @torch.no_grad()
    def query_np(pts):
        pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
        return (-trilinear_sample(sdf_grid, pts, box)[..., 0]).cpu().numpy()

    verts, tris = extract_geometry(box.xyz_min.cpu().numpy(),
                                   box.xyz_max.cpu().numpy(), resolution, 0.0,
                                   query_np)
    if scale_mats_np is not None:
        sm = np.asarray(scale_mats_np)
        verts = verts * sm[0, 0] + sm[:3, 3][None]
    return verts, tris


def _conv(cfg):
    return dict(ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
                flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)


def render_pose_path(ckpt_path: str, cfg, data_dict, out_dir: str, *,
                     logger=None, fps: int = 30, device: DeviceLike = None):
    """``--render_only``: render the loader's ``render_poses`` path
    (`eval/evaluator.py:73-114`).  Frames are always written; the
    mp4 encode is an optional host-side step that logs a warning when no
    encoder is installed."""
    log = logger or logging.getLogger("fgs")
    geo_ckpt = os.path.join(os.path.dirname(ckpt_path),
                            "geometry_searching_last.npz")
    params, buffers, cfg_model, box, ckpt = rebuild_model(ckpt_path, geo_ckpt,
                                                          device)
    s_val = float(np.asarray(ckpt.params["s_val"]).reshape(-1)[0])
    render_poses = np.asarray(data_dict["render_poses"])
    i0 = int(np.asarray(data_dict["i_test"]).reshape(-1)[0])
    hw = np.repeat(np.asarray(data_dict["HW"])[i0][None], len(render_poses), 0)
    ks = np.repeat(np.asarray(data_dict["Ks"])[i0][None], len(render_poses), 0)
    rc = make_render_fn(cfg_model, box, near=float(data_dict["near"]),
                        bg=1.0 if cfg.data.white_bkgd else 0.0)
    savedir = os.path.join(out_dir, "render_path")
    stats = render_viewpoints(rc, params, buffers, render_poses[:, :3, :4], hw,
                              ks, _conv(cfg), s_val, savedir=savedir,
                              logger=log)
    frames = [np.asarray(np.clip(r, 0, 1) * 255, np.uint8)
              for r in stats["rgbs"]]
    try:
        import imageio.v2 as imageio
    except ImportError:
        log.warning(f"mp4 encode unavailable (no imageio); frames are in "
                    f"{savedir}")
        return savedir
    try:
        imageio.mimwrite(os.path.join(savedir, "video.mp4"), frames, fps=fps,
                         quality=8)
        log.info(f"path video saved at {savedir}/video.mp4")
    except (OSError, RuntimeError, ValueError) as e:  # no ffmpeg backend
        log.warning(f"mp4 encode unavailable ({e}); frames are in {savedir}")
    return savedir


def evaluate_checkpoint(ckpt_path: str, cfg, data_dict, out_dir: str, *,
                        eval_ssim=True, eval_lpips=False, mesh_resolution=1024,
                        only_mesh=False, scene=0, logger=None,
                        stage_label="eval", device: DeviceLike = None):
    """Render the test views with PSNR/SSIM and write the mesh
    (`eval/evaluator.py:117-184`).  Returns (stats or None, mesh path)."""
    log = logger or logging.getLogger("fgs")
    geo_ckpt = os.path.join(os.path.dirname(ckpt_path),
                            "geometry_searching_last.npz")
    params, buffers, cfg_model, box, ckpt = rebuild_model(ckpt_path, geo_ckpt,
                                                          device)
    s_val = float(np.asarray(ckpt.params["s_val"]).reshape(-1)[0])

    stats = None
    if not only_mesh:
        rc = make_render_fn(cfg_model, box, near=float(data_dict["near"]),
                            bg=1.0 if cfg.data.white_bkgd else 0.0)
        i_test = data_dict["i_test"]
        stats = render_viewpoints(
            rc, params, buffers, data_dict["poses"][i_test],
            data_dict["HW"][i_test], data_dict["Ks"][i_test], _conv(cfg),
            s_val, gt_imgs=data_dict["images"][i_test],
            masks=data_dict["masks"][i_test],
            savedir=os.path.join(out_dir, f"render_test_{stage_label}"),
            eval_ssim=eval_ssim, eval_lpips=eval_lpips, logger=log)

    verts, tris = extract_mesh_from_params(
        params, cfg_model, box, mesh_resolution,
        scale_mats_np=data_dict.get("scale_mats_np"))
    mesh_path = os.path.join(out_dir, "meshes", f"{stage_label}.ply")
    write_ply(mesh_path, verts, tris)
    log.info(f"mesh ({len(verts)} verts, {len(tris)} tris) saved at "
             f"{mesh_path}")

    # DTU Chamfer against the ground-truth point cloud wherever the DTU
    # ObsMask data is present, writing result<stage>.txt next to the mesh
    # (`eval/evaluator.py:156-183`)
    if cfg.data.dataset_type == "dtu" and scene:
        dtu_dir = os.path.dirname(
            os.path.abspath(str(cfg.data.datadir).rstrip("/")))
        obsmask = os.path.join(dtu_dir, "ObsMask", f"ObsMask{scene}_10.mat")
        if os.path.exists(obsmask):
            from fgs_nerf_tpu_torch.eval.dtu_chamfer import dtu_chamfer

            d2s, s2d, overall = dtu_chamfer(
                mesh_path, scene, dtu_dir,
                eval_dir=os.path.join(out_dir, "meshes"), suffix=stage_label)
            log.info(f"DTU chamfer scan{scene}: "
                     f"[ d2s: {d2s:.3f} | s2d: {s2d:.3f} | mean: {overall:.3f} ]")
            if stats is not None:
                stats["chamfer"] = overall
        else:
            log.warning(
                f"DTU chamfer skipped: no ObsMask data at {obsmask} "
                "(expected <dtu_root>/ObsMask + <dtu_root>/Points/stl)")
    return stats, mesh_path
