"""Per-stage training: the train step of every stage (geometry, coarse,
fine) on either engine, and the stage driver around it.

Port of ``fgs_nerf_tpu/train/trainer.py``.  ``make_train_step``
(``:117-212``): one step is forward + losses + backward (+ the
fine-stage TV injection when asked) + masked Adam, with the same
arguments and metrics as the JAX step; ``models.sdf_voxel.forward``
chooses the sorted or the lattice engine from the config.  PyTorch runs
eagerly, so the step is a plain function; it returns new parameter and
optimizer-state dicts and leaves its inputs untouched.

Under a ``mesh`` (``parallel/mesh.py``, one process per rank) each rank
runs the step on its dp shard of the rays (`:63-115`: rays never
interact), then the gradients and the step metrics are averaged over
the dp group by one flattened ``all_reduce`` before the TV injection and
Adam, so every replica applies the same update.  With sp > 1 ``sdf`` /
``k0`` and their moments are x-slabs, the field gathers go through the
sharded gather (the sorted engine falls back to the lattice pipeline)
and grid gradients stay slab-local: nothing is summed over sp.

``train_stage`` (``:215-667``) runs one stage on one device or mesh: the
progressive-scaling rungs with refnet resets, the prior stage's mask
cache and nonempty mask, the coarse -> fine SDF warm start, the ray
samplers, per-voxel learning rates, resume, the incremental voxel box,
``s_updates`` / ``smooth_updates`` and capacity escalation (each a new
frozen ``SDFModelConfig``, hence a new step: the counterpart of a JAX
retrace), validation renders and checkpoints.  Parameters, optimizer
state, training rays and step metrics stay on the device; metrics reach
the host once per ``i_print`` window.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from fgs_nerf_tpu_torch.config.base import stage_blocks
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.data import rays as ray_lib
from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device, to_device
from fgs_nerf_tpu_torch.models import sdf_voxel as M
from fgs_nerf_tpu_torch.optim.masked_adam import (
    AdamState, ParamOpts, adam_update, init_state, tree_leaves, tree_map,
)
from fgs_nerf_tpu_torch.ops.sdf2alpha import s_val_schedule
from fgs_nerf_tpu_torch.ops.tv import tv_grad
from fgs_nerf_tpu_torch.parallel import mesh as mesh_lib
from fgs_nerf_tpu_torch.parallel.spatial import grid_slab
from fgs_nerf_tpu_torch.parallel.spatial_train import (
    GRID_PARAMS, gather_spatial, mesh_sp_size, place_spatial,
)
from fgs_nerf_tpu_torch.train import checkpoint as ckpt_lib
from fgs_nerf_tpu_torch.train import schedules
from fgs_nerf_tpu_torch.train.losses import LossWeights, compute_losses
from fgs_nerf_tpu_torch.train.stage_common import (
    apply_pervoxel_lr, apply_world_bound_scale, config_passthrough,
    drop_pervoxel_lr, fetch_metrics, pg_deduction,
)
from fgs_nerf_tpu_torch.utils.profiling import span


def loss_weights_from_cfg(cfg_train) -> LossWeights:
    """`train/trainer.py:43-53`."""
    return LossWeights(
        weight_main=cfg_train.get("weight_main", 1.0),
        weight_rgbper=cfg_train.get("weight_rgbper", 0.0),
        weight_entropy_last=cfg_train.get("weight_entropy_last", 0.0),
        weight_orientation=cfg_train.get("weight_orientation", 0.0),
        sigmoid_rgb_loss=cfg_train.get("sigmoid_rgb_loss", 0.0),
        weight_tv_density=cfg_train.get("weight_tv_density", 0.0),
        weight_tv_k0=cfg_train.get("weight_tv_k0", 0.0),
        ori_tv=cfg_train.get("ori_tv", False),
    )


def make_param_opts(params: Dict[str, Any], cfg_train) -> Dict[str, ParamOpts]:
    """`train/trainer.py:56-60`."""
    skip = set(cfg_train.get("skip_zero_grad_fields", []))
    return {name: ParamOpts(skip_zero_grad=name in skip) for name in params}


def param_grads(loss: torch.Tensor, p: Dict[str, Any]) -> Dict[str, Any]:
    """d loss / d p for a params tree whose leaves require grad; leaves
    the loss does not reach get zeros (as ``jax.grad`` gives them)."""
    leaves = list(tree_leaves(p))
    grad_leaves = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(x)
              for g, x in zip(grad_leaves, leaves))
    return tree_map(lambda _: next(it), p)


def weight_metrics(w_full: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The step's render-weight metrics (`train/trainer.py:195-203`):
    the mean per-ray max and sum over the rays where they are positive,
    and the share of rays with any weight."""
    wm = torch.amax(w_full, dim=-1)
    ws = torch.sum(w_full, dim=-1)
    one = torch.ones((), dtype=torch.float32, device=wm.device)

    def frac_mean(v):
        return torch.sum(v * (v > 0)) / torch.maximum(
            torch.sum(v > 0).float(), one)

    return {"wmax_mean": frac_mean(wm), "wsum_mean": frac_mean(ws),
            "w_nonzero_frac": torch.mean((ws > 0).float())}


def make_loss_and_grads(cfg_model: M.SDFModelConfig, box: SceneBox,
                        loss_w: LossWeights, *, near: float, bg: float,
                        sdf_tv: float, smooth_grad_tv: float,
                        use_nonempty_mask: bool, mesh=None):
    """``fn(params, buffers, rays_o, rays_d, viewdirs, target, s_val,
    tv_on) -> (render, losses, grads)``: the differentiated half of the
    step (`train/trainer.py:153-166`); grads mirror the params dict.
    Under a mesh they are this rank's own (not yet averaged over dp)."""
    def fn(params, buffers, rays_o, rays_d, viewdirs, target, s_val, tv_on):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        sv = p["s_val"][0] if cfg_model.s_learn else s_val
        with span("forward"):
            render = M.forward(p, buffers, cfg_model, box, rays_o, rays_d,
                               viewdirs, sv, near=near, bg=bg, mesh=mesh)
        nonempty = buffers.get("nonempty_mask") if use_nonempty_mask else None
        with span("loss"):
            losses = compute_losses(render, target, viewdirs, p, cfg_model,
                                    loss_w, sdf_tv=sdf_tv,
                                    smooth_grad_tv=smooth_grad_tv,
                                    tv_on=tv_on, nonempty_mask=nonempty,
                                    mesh=mesh)
        with span("backward"):
            grads = param_grads(losses["loss"], p)
        return render, losses, grads

    return fn


def step_metrics(render, losses) -> Dict[str, torch.Tensor]:
    """The step's metrics (`train/trainer.py:195-210`), 0-d tensors."""
    one = torch.ones((), dtype=torch.float32, device=render["weights"].device)
    return {
        "loss": losses["loss"].detach(),
        "mse": losses["mse"].detach(),
        **weight_metrics(render["weights"]),
        "mask_frac": torch.sum(render["live"]) / torch.maximum(
            torch.sum(render["valid"]).float(), one),
        "overflow_frac": torch.mean(render["overflow"].float()),
        "overflow_sample_frac": torch.mean(
            render["overflow_sample"].float()),
        "overflow_shade_frac": torch.mean(
            render["overflow_shade"].float()),
    }


def dp_reduce(mesh, grads: Dict[str, Any], metrics: Dict[str, torch.Tensor]):
    """Gradients and metrics averaged over dp in one ``all_reduce``: the
    global batch's gradient (equal shards), and metrics every rank then
    reads alike (loss, mse, the overflow fractions that drive capacity
    escalation), so no rank takes a host decision of its own."""
    if mesh is None:
        return grads, metrics
    names = list(metrics)
    with span("dp_reduce"):
        leaves, mvec = mesh_lib.dp_mean(
            mesh, tree_leaves(grads),
            torch.stack([metrics[k].float() for k in names]))
    it = iter(leaves)
    return tree_map(lambda _: next(it), grads), dict(zip(names, mvec.unbind(0)))


def make_train_step(cfg_model: M.SDFModelConfig, box: SceneBox,
                    loss_w: LossWeights, opts: Dict[str, ParamOpts], *,
                    near: float, bg: float, n_rand: int, sdf_tv: float,
                    smooth_grad_tv: float, inject_tv: bool, tv_dense: bool,
                    weight_tv_density: float, weight_tv_k0: float,
                    use_nonempty_mask: bool, mesh=None):
    """Build the train step for one (stage, rung, tv-config).

    ``step(params, opt_state, buffers, rays_o, rays_d, viewdirs, target,
    s_val, lrs, tv_on) -> (new_params, new_opt_state, metrics)``; every
    metric is a 0-d tensor on the parameters' device.  Under a ``mesh``
    the rays are this rank's dp shard, ``params`` its placement (grid
    slabs when sp > 1) and the metrics are the dp means."""
    loss_and_grads = make_loss_and_grads(
        cfg_model, box, loss_w, near=near, bg=bg, sdf_tv=sdf_tv,
        smooth_grad_tv=smooth_grad_tv, use_nonempty_mask=use_nonempty_mask,
        mesh=mesh)

    def step_fn(params, opt_state, buffers, rays_o, rays_d, viewdirs, target,
                s_val, lrs, tv_on):
        with span("train_step"):
            render, losses, grads = loss_and_grads(
                params, buffers, rays_o, rays_d, viewdirs, target, s_val,
                tv_on)
            with torch.no_grad(), span("metrics"):
                metrics = step_metrics(render, losses)
            grads, metrics = dp_reduce(mesh, grads, metrics)

            if inject_tv:
                # fine-stage TV injected straight into the gradient
                # (`train/trainer.py:168-182`)
                with span("tv"):
                    scale = max(cfg_model.world_size) / 128.0
                    if weight_tv_density > 0 and sdf_tv > 0:
                        w = weight_tv_density * sdf_tv / n_rand * scale * tv_on
                        grads["sdf"] = tv_grad(params["sdf"], grads["sdf"], w,
                                               w, w, tv_dense, mesh=mesh)
                    if weight_tv_k0 > 0:
                        wk = weight_tv_k0 / n_rand * scale * tv_on
                        grads["k0"] = tv_grad(params["k0"], grads["k0"], wk,
                                              wk, wk, tv_dense, mesh=mesh)

            with torch.no_grad(), span("adam"):
                new_params, new_opt = adam_update(
                    params, grads, opt_state, lrs, opts,
                    per_lr=buffers.get("per_lr"))
                if not cfg_model.s_learn:
                    new_params["s_val"] = torch.as_tensor(
                        s_val, dtype=torch.float32,
                        device=params["s_val"].device).reshape(1).clone()
        return new_params, new_opt, metrics

    return step_fn


def _next_capacity(k: int, s_max: int) -> int:
    """The next capacity rung: 1.5x rounded up to a multiple of 8, capped
    at the lattice depth (`train/trainer.py:215-222`)."""
    if k <= 0 or k >= s_max:
        return k
    return min(s_max, ((k + k // 2 + 7) // 8) * 8)


@dataclasses.dataclass
class StageResult:
    params: Dict[str, Any]
    cfg_model: M.SDFModelConfig
    box: SceneBox
    ckpt_path: str
    psnr_history: list
    # mean step metrics over the final i_print window
    last_metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    # share of pixels the 'in_maskcache' filter kept (None: other sampler)
    kept_ratio: Optional[float] = None


def _place(mesh, params, opt_state, buffers):
    """Full parameters, moments and grid buffers -> this rank's placement:
    x-slabs of the grids when sp > 1 (`train/trainer.py:320-337`);
    unchanged otherwise (dp replicas)."""
    if mesh_sp_size(mesh) == 1:
        return params, opt_state, buffers
    params, opt_state = place_spatial(mesh, params, opt_state)
    buffers = dict(buffers)
    if "nonempty_mask" in buffers:
        buffers["nonempty_mask"] = grid_slab(mesh, buffers["nonempty_mask"])
    if "per_lr" in buffers:
        buffers["per_lr"] = {k: (grid_slab(mesh, v) if k in GRID_PARAMS
                                 else v)
                             for k, v in buffers["per_lr"].items()}
    return params, opt_state, buffers


def _cam_origins(data_dict, dev) -> torch.Tensor:
    return torch.as_tensor(
        np.asarray(data_dict["poses"])[data_dict["i_train"], :3, 3],
        dtype=torch.float32, device=dev)


def train_stage(cfg, stage: str, data_dict: Dict[str, Any],
                xyz_min: np.ndarray, xyz_max: np.ndarray, out_dir: str, *,
                coarse_ckpt_path: Optional[str] = None,
                mask_ckpt_path: Optional[str] = None, logger=None,
                seed: int = 777, i_print: int = 500,
                n_iters_override: Optional[int] = None, resume: bool = False,
                i_validate: int = 0, device: DeviceLike = None,
                mesh=None) -> StageResult:
    """Run one training stage end to end (`train/trainer.py:238-667`) on
    ``device`` (None: the CUDA card), or on this rank's share of a
    ``mesh``: every rank runs this function on the same data and seed;
    set-up, handoffs and rungs run on full grids, the steps on the
    rank's placement (:func:`_place`), and rank 0 alone writes the
    checkpoints and the validation renders.  The result holds full
    parameters on every rank."""
    log = logger or logging.getLogger("fgs")
    dev = resolve_device(device)
    cfg_model_blk, cfg_train = stage_blocks(cfg, stage)
    sp = mesh_sp_size(mesh)

    xyz_min, xyz_max, box = apply_world_bound_scale(
        cfg_model_blk, xyz_min, xyz_max, dev)
    scale_ratio, pg_scale, cur_voxels = pg_deduction(cfg_train, cfg_model_blk)
    reset_iter = set(cfg_train.get("reset_iter", []))
    passthrough = config_passthrough(cfg_model_blk, M.SDFModelConfig)

    def build_cfg(nv: int) -> M.SDFModelConfig:
        return M.make_model_config(stage=stage, xyz_min=xyz_min,
                                   xyz_max=xyz_max, num_voxels=nv,
                                   sp_multiple=sp, **passthrough)

    cfg_m = build_cfg(cur_voxels)
    if sp > 1 and cfg_m.grid_type != "dense":
        raise ValueError("spatial grid sharding (sp > 1) needs dense grids, "
                         f"not grid_type={cfg_m.grid_type!r}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(gen, cfg_m, dev)

    # buffers: the mask cache from the geometry-searching checkpoint
    buffers: Dict[str, Any] = {}
    if (stage != "geometry_searching" and mask_ckpt_path
            and os.path.exists(mask_ckpt_path)):
        mc_ckpt = ckpt_lib.load_checkpoint(mask_ckpt_path)
        prior_min, prior_max = mc_ckpt.box
        buffers["mask_cache"] = M.build_mask_cache(
            torch.as_tensor(mc_ckpt.sdf_mask, device=dev), prior_min,
            prior_max)
        params, buffers = M.set_nonempty_mask(params, buffers, cfg_m, box)

    # fine stage: warm-start the SDF from the coarse grid
    if stage == "fine" and coarse_ckpt_path and os.path.exists(coarse_ckpt_path):
        c_ckpt = ckpt_lib.load_checkpoint(coarse_ckpt_path)
        params = M.init_sdf_from_sdf(
            params, torch.as_tensor(c_ckpt.params["sdf"], device=dev), cfg_m,
            reduce=cfg_train.get("sdf_reduce", 1.0))

    if cfg_model_blk.get("maskout_near_cam_vox", False):
        params = M.maskout_near_cam_vox(params, _cam_origins(data_dict, dev),
                                        data_dict["near"], cfg_m, box)

    opt_state = init_state(params)
    opts = make_param_opts(params, cfg_train)
    loss_w = loss_weights_from_cfg(cfg_train)
    lr_state = schedules.LrState(schedules.initial_lrs(cfg_train, set(params)))

    near = float(data_dict["near"])
    far = float(data_dict["far"])
    bg = 1.0 if cfg.data.white_bkgd else 0.0
    n_rand = int(cfg_train["N_rand"])
    tv_terms = dict(cfg_train.get("tv_terms", {}))
    if mesh is not None and n_rand % mesh.size:
        raise ValueError(f"N_rand={n_rand} must divide the mesh size "
                         f"{mesh.size} (axes {mesh.shape})")

    # ---- training rays (uploaded once; batches are gathered on device) --
    rng = np.random.default_rng(seed)
    images = np.asarray(data_dict["images"])[data_dict["i_train"]]
    poses = np.asarray(data_dict["poses"])[data_dict["i_train"]]
    hw = np.asarray(data_dict["HW"])[data_dict["i_train"]]
    ks = np.asarray(data_dict["Ks"])[data_dict["i_train"]]
    conv = dict(ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
                flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
    sampler = cfg_train.get("ray_sampler", "random")
    kept_ratio = None
    if sampler == "in_maskcache" and "mask_cache" in buffers:
        mc = buffers["mask_cache"]
        keep_fn = ray_lib.make_maskcache_pixel_filter(
            box, cfg_m.world_size, cfg_m.stepsize, cfg_m.voxel_size,
            lambda pts: M.mask_cache_query(mc, pts, cfg_m.mask_cache_thres))
        rgb_tr, o_tr, d_tr, v_tr, kept_ratio = \
            ray_lib.get_training_rays_in_maskcache(
                images, poses, hw, ks, keep_fn=keep_fn, near=near, far=far,
                **conv)
        log.info(f"in_maskcache ray filter kept ratio {kept_ratio:.3f}")
        if len(rgb_tr) < n_rand:
            raise ValueError(
                f"maskcache ray filter kept only {len(rgb_tr)} rays "
                f"(< N_rand={n_rand}) — the prior stage's sdf_mask and "
                "the current bbox are inconsistent")
        flat = True
    elif sampler in ("flatten", "in_maskcache"):
        rgb_tr, o_tr, d_tr, v_tr = ray_lib.get_training_rays_flatten(
            images, poses, hw, ks, **conv)
        flat = True
    else:  # 'random' / 'patch'
        rgb_tr, o_tr, d_tr, v_tr = ray_lib.get_training_rays(
            images, poses, hw, ks, **conv)
        flat = False
    if flat:
        index_gen = ray_lib.batch_index_generator(len(rgb_tr), n_rand, seed)
    elif sampler == "patch":
        view_gen = ray_lib.batch_index_generator(len(rgb_tr), 1, seed)

    # per-voxel LR from visibility counts (`train/trainer.py:385-397`)
    if cfg_train.get("pervoxel_lr", False):
        if flat:
            raise ValueError("pervoxel_lr requires a per-view ray sampler")
        cnt = M.voxel_count_views(
            cfg_m, box, o_tr, d_tr, near, far, cfg_m.stepsize,
            downrate=int(cfg_train.get("pervoxel_lr_downrate", 1)))
        params, opts, buffers = apply_pervoxel_lr(
            params, opts, buffers, cnt, clamp_param="sdf", clamp_value=1.0)

    ray_dev = [torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
               for a in (o_tr, d_tr, v_tr, rgb_tr)]
    n_views_tr = rgb_tr.shape[0]
    del o_tr, d_tr, v_tr

    # ---- step function cache ----------------------------------------------
    step_cache: Dict[Any, Any] = {}

    def build_step(global_step):
        sdf_tv = float(tv_terms.get("sdf_tv", 0.0))
        smooth_grad_tv = float(tv_terms.get("smooth_grad_tv", 0.0))
        tv_dense = global_step < cfg_train.get("tv_dense_before", 0)
        inject_tv = not cfg_train.get("ori_tv", False)
        use_nonempty = "nonempty_mask" in buffers
        key_ = (cfg_m, sdf_tv, smooth_grad_tv, tv_dense, inject_tv,
                use_nonempty, tuple(sorted(opts.items())))
        if key_ not in step_cache:
            step_cache[key_] = make_train_step(
                cfg_m, box, loss_w, opts, near=near, bg=bg, n_rand=n_rand,
                sdf_tv=sdf_tv, smooth_grad_tv=smooth_grad_tv,
                inject_tv=inject_tv, tv_dense=tv_dense,
                weight_tv_density=loss_w.weight_tv_density,
                weight_tv_k0=loss_w.weight_tv_k0,
                use_nonempty_mask=use_nonempty, mesh=mesh)
        return step_cache[key_]

    n_iters = n_iters_override or int(cfg_train["N_iters"])
    psnr_hist = []
    pending = []
    t0 = time.time()
    last_metrics: Dict[str, float] = {}

    ckpt_path = os.path.join(out_dir, f"{stage}_last.npz")
    os.makedirs(out_dir, exist_ok=True)

    # mid-stage resume: params, moments, LR state and the pg rung
    start = 0
    if resume and os.path.exists(ckpt_path):
        rck = ckpt_lib.load_checkpoint(ckpt_path)
        start = min(rck.global_step, n_iters)
        for _ in [p for p in pg_scale if p <= start]:
            cur_voxels = int(cur_voxels * scale_ratio)
        pg_scale = [p for p in pg_scale if p > start]
        cfg_m = build_cfg(cur_voxels)

        def to_dev(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        params = tree_map(to_dev, rck.params)
        opt_state = init_state(params)
        if rck.opt is not None:
            opt_state = AdamState(to_dev(rck.opt["step"]),
                                  tree_map(to_dev, rck.opt["exp_avg"]),
                                  tree_map(to_dev, rck.opt["exp_avg_sq"]))
        if rck.meta.get("lrs"):
            lr_state = schedules.LrState(dict(rck.meta["lrs"]))
        log.info(f"[{stage}] resumed from {ckpt_path} at step {start}")

    # every replica starts from rank 0's bits (same seed, same draws)
    mesh_lib.check_replicas(mesh, params)
    params, opt_state, buffers = _place(mesh, params, opt_state, buffers)

    def full(with_opt=False):
        """Full parameters (and moments) on every rank: a collective."""
        return gather_spatial(mesh, params, cfg_m.world_size[0],
                              opt_state if with_opt else None)

    s_val = None
    for global_step in range(1 + start, n_iters + 1):
        with span("stage_step"):
            # progressive scaling (`train/trainer.py:460-495`)
            if global_step in pg_scale:
                # on full grids; the mask cache's nonempty mask is rebuilt
                # and the per-voxel rates dropped below
                with span("rung"):
                    params = full()
                    cur_voxels = int(cur_voxels * scale_ratio)
                    new_cfg = build_cfg(cur_voxels)
                    params = M.scale_volume_grid(params, new_cfg)
                    cfg_m = new_cfg
                    if global_step in reset_iter:
                        params = M.reset_refnet(params, gen, cfg_m)
                        if cfg_model_blk.get("maskout_near_cam_vox", False):
                            params = M.maskout_near_cam_vox(
                                params, _cam_origins(data_dict, dev), near,
                                cfg_m, box)
                    if "mask_cache" in buffers:
                        params, buffers = M.set_nonempty_mask(
                            params, buffers, cfg_m, box)
                    opt_state = init_state(params)
                    lr_state = schedules.LrState(
                        schedules.initial_lrs(cfg_train, set(params)))
                    # reference quirk: per-voxel LR is not recomputed after
                    # a rescale
                    opts, buffers = drop_pervoxel_lr(opts, buffers)
                    params, opt_state, buffers = _place(mesh, params,
                                                        opt_state, buffers)
                log.info(f"[{stage}] pg_scale at {global_step}: voxels -> "
                         f"{cur_voxels} world_size -> {cfg_m.world_size}")

            # incremental voxel box
            bounds = schedules.inc_bounds(global_step, cfg_train)
            if bounds is not None:
                buffers["inc_lower"] = to_device(bounds[0], dev,
                                                 torch.float32)
                buffers["inc_upper"] = to_device(bounds[1], dev,
                                                 torch.float32)
            else:
                buffers.pop("inc_lower", None)
                buffers.pop("inc_upper", None)

            # batch selection: the JAX package's numpy draws, gathered on
            # device
            with span("batch"):
                if flat:
                    sel = to_device(next(index_gen), dev)
                    batch = [a[sel] for a in ray_dev]
                elif sampler == "patch":
                    b = int(next(view_gen)[0])
                    patch = int(round(np.sqrt(n_rand)))
                    r0 = int(rng.integers(0, rgb_tr.shape[1] - patch))
                    c0 = int(rng.integers(0, rgb_tr.shape[2] - patch))
                    batch = [a[b, r0:r0 + patch, c0:c0 + patch].reshape(-1, 3)
                             for a in ray_dev]
                else:
                    b = rng.integers(0, n_views_tr, n_rand)
                    r = rng.integers(0, rgb_tr.shape[1], n_rand)
                    c = rng.integers(0, rgb_tr.shape[2], n_rand)
                    bi, ri, ci = to_device(np.stack([b, r, c]), dev)
                    batch = [a[bi, ri, ci] for a in ray_dev]
                # every rank drew the same global batch; it keeps its dp rows
                batch = mesh_lib.shard_batch(mesh, *batch)

            s_val = float(s_val_schedule(global_step, cfg_m.s_ratio,
                                         cfg_m.s_start, cfg_m.step_start))
            step_fn = build_step(global_step)
            tv_on = 1.0 if schedules.tv_active(global_step, cfg_train) else 0.0
            # the step's scalars in one non-blocking copy: s_val, tv_on, lrs
            names = list(lr_state.lrs)
            scal = to_device([s_val, tv_on]
                             + [lr_state.lrs[k] for k in names],
                             dev, torch.float32)
            lrs = dict(zip(names, scal[2:]))
            params, opt_state, metrics = step_fn(
                params, opt_state, buffers, *batch, scal[0], lrs, scal[1])

            # host-side schedule updates (end of step)
            schedules.update_lrs(lr_state, global_step, cfg_train)
            schedules.apply_tv_updates(tv_terms, global_step, cfg_train)

            # step-indexed model mutations: each is a new config, hence a
            # new step
            s_updates = cfg_model_blk.get("s_updates", {})
            if (global_step - 1) in s_updates:
                cfg_m = dataclasses.replace(cfg_m,
                                            **s_updates[global_step - 1])
                log.info(f"[{stage}] s_updates at {global_step - 1}: "
                         f"{s_updates[global_step - 1]}")
            smooth_updates = cfg_model_blk.get("smooth_updates", {})
            if (global_step - 1) in smooth_updates:
                upd = {("smooth_ksize" if k_ == "ksize" else
                        "smooth_sigma" if k_ == "sigma" else k_): v_
                       for k_, v_ in smooth_updates[global_step - 1].items()}
                cfg_m = dataclasses.replace(cfg_m, **upd)
                log.info(f"[{stage}] smooth_updates at {global_step - 1}: "
                         f"{upd}")

            # metrics stay on the device until the i_print flush
            pending.append(metrics)
            if global_step % i_print == 0 or global_step == n_iters:
                with span("flush"):
                    got = fetch_metrics(pending)
                pending = []
                means = last_metrics = {
                    k_: float(np.mean([m[k_] for m in got])) for k_ in got[0]}
                psnrs = [-10.0 * np.log10(max(float(m["mse"]), 1e-12))
                         for m in got]
                psnr_hist.extend(psnrs)
                log.info(
                    f"[{stage}] iter {global_step:6d}/{n_iters} "
                    f"loss {means['loss']:.6f} PSNR {np.mean(psnrs):7.4f} "
                    f"Wmax {means['wmax_mean']:.3f} "
                    f"Wsum {means['wsum_mean']:.3f} "
                    f"W>0 {means['w_nonzero_frac']:.3f} "
                    f"mask% {100 * means['mask_frac']:.2f} "
                    f"ovf% {100 * means['overflow_frac']:.3f} s {s_val:.4g} "
                    f"eps {time.time() - t0:.0f}s")
                if means.get("overflow_frac", 0.0) > 0.0:
                    if cfg_train.get("capacity_auto_escalate", True):
                        upd = {}
                        if means.get("overflow_sample_frac", 0.0) > 0.0:
                            upd["sample_k"] = _next_capacity(cfg_m.sample_k,
                                                             cfg_m.s_max)
                        if means.get("overflow_shade_frac", 0.0) > 0.0:
                            upd["shade_k"] = _next_capacity(cfg_m.shade_k,
                                                            cfg_m.s_max)
                        upd = {k_: v_ for k_, v_ in upd.items()
                               if v_ != getattr(cfg_m, k_)}
                        if upd:
                            cfg_m = dataclasses.replace(cfg_m, **upd)
                            log.warning(
                                f"[{stage}] capacity overflow on "
                                f"{100 * means['overflow_frac']:.2f}% of rays "
                                f"— auto-escalating {upd} "
                                f"(s_max={cfg_m.s_max})")
                    else:
                        log.warning(
                            f"[{stage}] capacity overflow on "
                            f"{100 * means['overflow_frac']:.2f}% of rays "
                            f"(sample_k={cfg_m.sample_k}, "
                            f"shade_k={cfg_m.shade_k}, "
                            f"s_max={cfg_m.s_max}): samples are being dropped "
                            f"and accuracy degrades — raise sample_k/shade_k "
                            f"(or set them to -1 for exact auto-capacity)")

            # periodic validation: one random test view, every view at the
            # end
            if i_validate and (global_step % i_validate == 0
                               or global_step == n_iters):
                from fgs_nerf_tpu_torch.eval.render import (
                    make_render_fn, render_viewpoints,
                )

                with span("validate"):
                    i_test = np.asarray(data_dict["i_test"])
                    pick = ([int(rng.integers(0, len(i_test)))]
                            if global_step != n_iters
                            else list(range(len(i_test))))
                    sel_views = i_test[pick]
                    params_full = full()
                    if mesh_lib.is_writer(mesh):
                        rc = make_render_fn(cfg_m, box, near=near, bg=bg)
                        views = {k_: np.asarray(data_dict[k_])[sel_views]
                                 for k_ in ("poses", "HW", "Ks", "images",
                                            "masks")}
                        render_viewpoints(
                            rc, params_full, buffers, views["poses"],
                            views["HW"], views["Ks"], conv, s_val,
                            gt_imgs=views["images"], masks=views["masks"],
                            savedir=os.path.join(out_dir,
                                                 f"render_test_{stage}"),
                            eval_ssim=True, logger=log, step=global_step)
                    del params_full
                    mesh_lib.barrier(mesh)

            save_iter = int(cfg_train.get("save_iter", 1 << 30))
            if global_step == n_iters or global_step % save_iter == 0:
                with span("checkpoint"):
                    params_full, opt_full = full(with_opt=True)
                    ckpt_lib.save_checkpoint(
                        ckpt_path, global_step=global_step,
                        params=params_full, opt_state=opt_full,
                        sdf_mask=M.build_sdf_mask(params_full, cfg_m),
                        model_kwargs=dataclasses.asdict(cfg_m),
                        xyz_min=box.xyz_min, xyz_max=box.xyz_max,
                        lrs=lr_state.lrs, mesh=mesh)
                log.info(f"[{stage}] checkpoint saved at {ckpt_path}")
                del params_full, opt_full

    params = full()
    return StageResult(params=params, cfg_model=cfg_m, box=box,
                       ckpt_path=ckpt_path, psnr_history=psnr_hist,
                       last_metrics=last_metrics, kept_ratio=kept_ratio)
