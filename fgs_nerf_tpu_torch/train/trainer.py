"""The train step of every stage (geometry, coarse, fine) on either
engine: ``models.sdf_voxel.forward`` chooses the sorted or the lattice
engine from the config.

Port of ``make_train_step`` (``fgs_nerf_tpu/train/trainer.py:117-212``)
without the dp ``shard_map`` and the spatial ``gather_fn``: one step is
forward + losses + backward (+ the fine-stage TV injection when asked)
+ masked Adam, with the same arguments and metrics as the JAX step.
Parameter groups are walked generically, so the fine stage's ``rgbnet``
needs no special case.
PyTorch runs eagerly, so the step is a plain function (no jit); it
returns new parameter and optimizer-state dicts and leaves its inputs
untouched.
"""
from __future__ import annotations

from typing import Dict

import torch

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import sdf_voxel as M
from fgs_nerf_tpu_torch.optim.masked_adam import (
    ParamOpts, adam_update, tree_leaves, tree_map,
)
from fgs_nerf_tpu_torch.ops.tv import tv_grad
from fgs_nerf_tpu_torch.train.losses import LossWeights, compute_losses


def make_loss_and_grads(cfg_model: M.SDFModelConfig, box: SceneBox,
                        loss_w: LossWeights, *, near: float, bg: float,
                        sdf_tv: float, smooth_grad_tv: float,
                        use_nonempty_mask: bool):
    """``fn(params, buffers, rays_o, rays_d, viewdirs, target, s_val,
    tv_on) -> (render, losses, grads)``: the differentiated half of the
    step (`train/trainer.py:153-166`); grads mirror the params dict."""

    def fn(params, buffers, rays_o, rays_d, viewdirs, target, s_val, tv_on):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        sv = p["s_val"][0] if cfg_model.s_learn else s_val
        render = M.forward(p, buffers, cfg_model, box, rays_o, rays_d,
                           viewdirs, sv, near=near, bg=bg)
        nonempty = buffers.get("nonempty_mask") if use_nonempty_mask else None
        losses = compute_losses(render, target, viewdirs, p, cfg_model,
                                loss_w, sdf_tv=sdf_tv,
                                smooth_grad_tv=smooth_grad_tv, tv_on=tv_on,
                                nonempty_mask=nonempty)
        leaves = list(tree_leaves(p))
        grad_leaves = torch.autograd.grad(losses["loss"], leaves,
                                          allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(x)
                  for g, x in zip(grad_leaves, leaves))
        return render, losses, tree_map(lambda _: next(it), p)

    return fn


def make_train_step(cfg_model: M.SDFModelConfig, box: SceneBox,
                    loss_w: LossWeights, opts: Dict[str, ParamOpts], *,
                    near: float, bg: float, n_rand: int, sdf_tv: float,
                    smooth_grad_tv: float, inject_tv: bool, tv_dense: bool,
                    weight_tv_density: float, weight_tv_k0: float,
                    use_nonempty_mask: bool):
    """Build the train step for one (stage, rung, tv-config).

    ``step(params, opt_state, buffers, rays_o, rays_d, viewdirs, target,
    s_val, lrs, tv_on) -> (new_params, new_opt_state, metrics)``; every
    metric is a 0-d tensor on the parameters' device."""
    loss_and_grads = make_loss_and_grads(
        cfg_model, box, loss_w, near=near, bg=bg, sdf_tv=sdf_tv,
        smooth_grad_tv=smooth_grad_tv, use_nonempty_mask=use_nonempty_mask)

    def step_fn(params, opt_state, buffers, rays_o, rays_d, viewdirs, target,
                s_val, lrs, tv_on):
        render, losses, grads = loss_and_grads(
            params, buffers, rays_o, rays_d, viewdirs, target, s_val, tv_on)

        if inject_tv:
            # fine-stage TV injected straight into the gradient
            # (`train/trainer.py:168-182`)
            scale = max(cfg_model.world_size) / 128.0
            if weight_tv_density > 0 and sdf_tv > 0:
                w = weight_tv_density * sdf_tv / n_rand * scale * tv_on
                grads["sdf"] = tv_grad(params["sdf"], grads["sdf"], w, w, w,
                                       tv_dense)
            if weight_tv_k0 > 0:
                wk = weight_tv_k0 / n_rand * scale * tv_on
                grads["k0"] = tv_grad(params["k0"], grads["k0"], wk, wk, wk,
                                      tv_dense)

        with torch.no_grad():
            new_params, new_opt = adam_update(params, grads, opt_state, lrs,
                                              opts,
                                              per_lr=buffers.get("per_lr"))
            if not cfg_model.s_learn:
                new_params["s_val"] = torch.full(
                    (1,), float(s_val), dtype=torch.float32,
                    device=params["s_val"].device)

            w_full = render["weights"]
            wm = torch.amax(w_full, dim=-1)
            ws = torch.sum(w_full, dim=-1)
            one = torch.ones((), dtype=torch.float32, device=wm.device)

            def frac_mean(v):
                return torch.sum(v * (v > 0)) / torch.maximum(
                    torch.sum(v > 0).float(), one)

            metrics = {
                "loss": losses["loss"].detach(),
                "mse": losses["mse"].detach(),
                "wmax_mean": frac_mean(wm),
                "wsum_mean": frac_mean(ws),
                "w_nonzero_frac": torch.mean((ws > 0).float()),
                "mask_frac": torch.sum(render["live"]) / torch.maximum(
                    torch.sum(render["valid"]).float(), one),
                "overflow_frac": torch.mean(render["overflow"].float()),
                "overflow_sample_frac": torch.mean(
                    render["overflow_sample"].float()),
                "overflow_shade_frac": torch.mean(
                    render["overflow_shade"].float()),
            }
        return new_params, new_opt, metrics

    return step_fn
