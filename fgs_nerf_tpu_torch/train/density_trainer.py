"""The ``--dvgo_init`` geometry-searching driver: the DVGO density model
trained in place of the SDF model's first stage.

Port of ``fgs_nerf_tpu/train/density_trainer.py``
(`model/coarse_geometry_searching.py:105-380`) on one device: its own
optimizer groups (``lrate_density`` / ``lrate_k0``), learning-rate
schedule, progressive scaling, per-voxel learning rate, the i_print
window and the checkpoint ``geometry_searching_last.npz``, which carries
the alpha-based ``sdf_mask`` (``models/density_voxel.py:build_sdf_mask``)
so the coarse stage's mask cache and bbox shrink read it as they read an
SDF stage's.  Training rays are uploaded once and batches gathered on
the device, with the JAX stage's numpy draws.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device, to_device
from fgs_nerf_tpu_torch.models import density_voxel as D
from fgs_nerf_tpu_torch.models import sdf_voxel as M
from fgs_nerf_tpu_torch.optim.masked_adam import (
    ParamOpts, adam_update, init_state, tree_map,
)
from fgs_nerf_tpu_torch.parallel import mesh as mesh_lib
from fgs_nerf_tpu_torch.train import checkpoint as ckpt_lib
from fgs_nerf_tpu_torch.train import schedules
from fgs_nerf_tpu_torch.train.stage_common import (
    PrintWindow, apply_pervoxel_lr, apply_world_bound_scale,
    config_passthrough, drop_pervoxel_lr, gather_view_rays, pg_deduction,
)
from fgs_nerf_tpu_torch.train.trainer import (
    StageResult, dp_reduce, param_grads, weight_metrics,
)


def make_density_loss_and_grads(cfg_model: D.DensityModelConfig,
                                box: SceneBox, *, near: float, bg: float,
                                n_rand: int, weight_main: float,
                                weight_entropy_last: float,
                                weight_rgbper: float):
    """``fn(params, buffers, rays_o, rays_d, viewdirs, target) -> (render,
    loss, mse, grads)``: mse + entropy_last + rgbper
    (`train/density_trainer.py:59-82`; orientation and TV are off for
    this stage); grads mirror the params dict."""

    def fn(params, buffers, rays_o, rays_d, viewdirs, target):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        render = D.forward(p, buffers, cfg_model, box, rays_o, rays_d,
                           viewdirs, near=near, bg=bg)
        main = torch.mean((render["rgb_marched"] - target) ** 2)
        loss = weight_main * main
        if weight_entropy_last > 0:
            pout = torch.clamp(render["alphainv_cum"], 1e-6, 1 - 1e-6)
            ent = -torch.mean(pout * torch.log(pout)
                              + (1 - pout) * torch.log(1 - pout))
            loss = loss + weight_entropy_last * ent
        if weight_rgbper > 0:
            diff = torch.sum((render["sel_rgb"] - target[:, None, :]) ** 2, -1)
            rgbper = torch.sum(diff * render["sel_weights"].detach()) / n_rand
            loss = loss + weight_rgbper * rgbper
        return render, loss.detach(), main.detach(), param_grads(loss, p)

    return fn


def make_density_train_step(cfg_model: D.DensityModelConfig, box: SceneBox,
                            opts: Dict[str, ParamOpts], *, near: float,
                            bg: float, n_rand: int, weight_main: float,
                            weight_entropy_last: float, weight_rgbper: float,
                            mesh=None):
    """The DVGO train step (`train/density_trainer.py:43-106`):
    ``step(params, opt_state, buffers, rays_o, rays_d, viewdirs, target,
    lrs) -> (new_params, new_opt_state, metrics)``, the masked Adam
    update with the stage's per-voxel learning rate; every metric is a
    0-d tensor on the parameters' device.  Under a dp ``mesh`` the rays
    are this rank's shard of ``n_rand`` and gradients and metrics are
    averaged over dp before the update."""
    loss_and_grads = make_density_loss_and_grads(
        cfg_model, box, near=near, bg=bg,
        n_rand=n_rand // (mesh.dp if mesh is not None else 1),
        weight_main=weight_main, weight_entropy_last=weight_entropy_last,
        weight_rgbper=weight_rgbper)

    def step_fn(params, opt_state, buffers, rays_o, rays_d, viewdirs, target,
                lrs):
        render, loss, main, grads = loss_and_grads(
            params, buffers, rays_o, rays_d, viewdirs, target)
        with torch.no_grad():
            metrics = {"loss": loss, "mse": main,
                       **weight_metrics(render["weights"])}
        grads, metrics = dp_reduce(mesh, grads, metrics)
        with torch.no_grad():
            new_params, new_opt = adam_update(params, grads, opt_state, lrs,
                                              opts,
                                              per_lr=buffers.get("per_lr"))
        return new_params, new_opt, metrics

    return step_fn


def train_density_stage(cfg, data_dict: Dict[str, Any], xyz_min: np.ndarray,
                        xyz_max: np.ndarray, out_dir: str, *, logger=None,
                        seed: int = 777, i_print: int = 500,
                        n_iters_override: Optional[int] = None,
                        device: DeviceLike = None, mesh=None) -> StageResult:
    """Run the DVGO geometry search on ``device`` (None: the CUDA card)
    and write ``geometry_searching_last.npz``
    (`train/density_trainer.py:109-259`); on a ``mesh``, dp only: the
    rays are sharded, the density grids replicated."""
    log = logger or logging.getLogger("fgs")
    dev = resolve_device(device)
    if mesh is not None and mesh.sp > 1:
        raise ValueError(
            "spatial grid sharding (sp > 1) is wired for the SDF stages "
            "only; the dvgo density init replicates its (small, "
            "160^3-class) grids — run --dvgo_init with a dp-only mesh")
    cfg_model_blk = dict(cfg.get("dvgo_model", {}))
    cfg_train = dict(cfg.get("dvgo", {}))
    if not cfg_model_blk or not cfg_train:
        raise ValueError(
            "--dvgo_init requires 'dvgo' and 'dvgo_model' config blocks "
            "(the reference ships none: see config/scenes.py defaults)")

    xyz_min, xyz_max, box = apply_world_bound_scale(
        cfg_model_blk, xyz_min, xyz_max, dev)
    scale_ratio, pg_scale, cur_voxels = pg_deduction(cfg_train, cfg_model_blk)
    passthrough = config_passthrough(cfg_model_blk, D.DensityModelConfig)

    def build_cfg(nv: int) -> D.DensityModelConfig:
        return D.make_density_config(xyz_min=xyz_min, xyz_max=xyz_max,
                                     num_voxels=nv, **passthrough)

    cfg_m = build_cfg(cur_voxels)
    params = D.init_params(cfg_m, dev)
    buffers: Dict[str, Any] = {}
    skip = set(cfg_train.get("skip_zero_grad_fields", []))
    opts = {name: ParamOpts(skip_zero_grad=name in skip) for name in params}
    lr_state = schedules.LrState(schedules.initial_lrs(cfg_train, set(params)))
    near = float(data_dict["near"])
    bg = 1.0 if cfg.data.white_bkgd else 0.0
    n_rand = int(cfg_train["N_rand"])

    # per-view training rays; the reference's DVGO driver always draws
    # random pixels (`coarse_geometry_searching.py:220-226`)
    rng = np.random.default_rng(seed)
    rgb_tr, o_tr, d_tr, v_tr, _ = gather_view_rays(cfg, data_dict)

    # per-voxel learning rate from visibility counts; near-invisible
    # voxels clamped to density -100, i.e. empty space
    # (`coarse_geometry_searching.py:186-196`)
    if cfg_train.get("pervoxel_lr", False):
        cnt = M.voxel_count_views(
            cfg_m, box, o_tr, d_tr, near, float(data_dict["far"]),
            cfg_m.stepsize,
            downrate=int(cfg_train.get("pervoxel_lr_downrate", 1)))
        params, opts, buffers = apply_pervoxel_lr(
            params, opts, buffers, cnt, clamp_param="density",
            clamp_value=-100.0)

    if mesh is not None and n_rand % mesh.dp:
        raise ValueError(f"N_rand={n_rand} must divide dp={mesh.dp}")
    mesh_lib.check_replicas(mesh, params)
    opt_state = init_state(params)
    ray_dev = [torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
               for a in (o_tr, d_tr, v_tr, rgb_tr)]
    shape_tr = rgb_tr.shape[:3]
    del o_tr, d_tr, v_tr, rgb_tr

    step_cache: Dict[Any, Any] = {}

    def build_step():
        key_ = (cfg_m, tuple(sorted(opts.items())))
        if key_ not in step_cache:
            step_cache[key_] = make_density_train_step(
                cfg_m, box, opts, near=near, bg=bg, n_rand=n_rand,
                weight_main=float(cfg_train.get("weight_main", 1.0)),
                weight_entropy_last=float(
                    cfg_train.get("weight_entropy_last", 0.0)),
                weight_rgbper=float(cfg_train.get("weight_rgbper", 0.0)),
                mesh=mesh)
        return step_cache[key_]

    n_iters = n_iters_override or int(cfg_train["N_iters"])
    window = PrintWindow(log, "dvgo", n_iters)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_path = os.path.join(out_dir, "geometry_searching_last.npz")

    for global_step in range(1, n_iters + 1):
        if global_step in pg_scale:
            cur_voxels = int(cur_voxels * scale_ratio)
            cfg_m = build_cfg(cur_voxels)
            params = D.scale_volume_grid(params, cfg_m)
            opt_state = init_state(params)
            lr_state = schedules.LrState(
                schedules.initial_lrs(cfg_train, set(params)))
            # reference quirk: per-voxel LR is not recomputed after a rescale
            opts, buffers = drop_pervoxel_lr(opts, buffers)
            log.info(f"[dvgo] pg_scale at {global_step}: voxels -> "
                     f"{cur_voxels} world_size -> {cfg_m.world_size}")

        b = rng.integers(0, shape_tr[0], n_rand)
        r = rng.integers(0, shape_tr[1], n_rand)
        c = rng.integers(0, shape_tr[2], n_rand)
        bi, ri, ci = to_device(np.stack([b, r, c]), dev)
        batch = mesh_lib.shard_batch(mesh, *(a[bi, ri, ci] for a in ray_dev))

        names = list(lr_state.lrs)
        scal = to_device([lr_state.lrs[k] for k in names], dev, torch.float32)
        lrs = dict(zip(names, scal))
        params, opt_state, metrics = build_step()(params, opt_state, buffers,
                                                  *batch, lrs)
        schedules.update_lrs(lr_state, global_step, cfg_train)
        window.push(metrics)
        if global_step % i_print == 0 or global_step == n_iters:
            window.flush(global_step)

    sdf_mask = D.build_sdf_mask(
        params, cfg_m, thres=float(cfg_model_blk.get("bbox_thres", 1e-3)))
    ckpt_lib.save_checkpoint(
        ckpt_path, global_step=n_iters, params=params, opt_state=opt_state,
        sdf_mask=sdf_mask, model_kwargs=dataclasses.asdict(cfg_m),
        xyz_min=box.xyz_min, xyz_max=box.xyz_max, lrs=lr_state.lrs,
        mesh=mesh)
    log.info(f"[dvgo] checkpoint saved at {ckpt_path}")
    return StageResult(params=params, cfg_model=cfg_m, box=box,
                       ckpt_path=ckpt_path,
                       psnr_history=window.psnr_history,
                       last_metrics=window.last_means)
