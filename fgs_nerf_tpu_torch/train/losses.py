"""Training losses.

Port of ``fgs_nerf_tpu/train/losses.py:19-137`` over the render dicts of
both engines: the sorted engine hands over the shaded rgb as three
[N, S] planes (``sel_rgb_ch``) and n.v per sample (``ndv``), the lattice
engine ``sel_rgb`` [N, K, 3] and ``normal`` [N, S, 3].

Under a ``mesh`` the rays are this rank's dp shard and the trainer
averages gradients over dp: the per-ray means need nothing more, and
the orientation term, a sum over the batch, is scaled by dp so that the
mean over the shards is the sum over the global batch.  With sp > 1 the
grid terms run on x-slabs (``ops/tv.py``, ``parallel/spatial.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from fgs_nerf_tpu_torch.ops.tv import density_tv_loss, k0_tv_loss
from fgs_nerf_tpu_torch.parallel.spatial import sharded_sdf_gradient


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Static loss configuration for one stage (`train/losses.py:19-31`)."""

    weight_main: float = 1.0
    weight_rgbper: float = 0.0
    weight_entropy_last: float = 0.0
    weight_orientation: float = 0.0
    sigmoid_rgb_loss: float = 0.0
    weight_tv_density: float = 0.0
    weight_tv_k0: float = 0.0
    ori_tv: bool = False


def mse(a, b):
    return torch.mean((a - b) ** 2)


def compute_losses(render: Dict[str, Any], target: torch.Tensor,
                   viewdirs: torch.Tensor, params: Dict[str, Any], cfg_model,
                   w: LossWeights, sdf_tv: float, smooth_grad_tv: float,
                   tv_on, nonempty_mask: Optional[torch.Tensor],
                   mesh=None) -> Dict[str, torch.Tensor]:
    """Returns a dict with 'loss' plus the individual terms
    (`train/losses.py:38-137`)."""
    n_rays = target.shape[0]
    losses = {}
    main = mse(render["rgb_marched"], target)
    losses["mse"] = main
    loss = w.weight_main * main

    if w.weight_rgbper > 0:
        if "sel_rgb_ch" in render:
            diff = sum(
                (ch - target[:, a:a + 1]) ** 2
                for a, ch in enumerate(render["sel_rgb_ch"])
            )
        else:
            diff = torch.sum((render["sel_rgb"] - target[:, None, :]) ** 2,
                             dim=-1)
        rgbper = torch.sum(diff * render["sel_weights"].detach()) / n_rays
        losses["rgbper"] = rgbper
        loss = loss + w.weight_rgbper * rgbper

    if w.weight_entropy_last > 0:
        pout = torch.clamp(render["alphainv_cum"], 1e-6, 1 - 1e-6)
        ent = -torch.mean(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout))
        losses["entropy_last"] = ent
        loss = loss + w.weight_entropy_last * ent

    if w.weight_orientation > 0:
        if "ndv" in render:
            ndv = render["ndv"]
        else:
            ndv = torch.sum(render["normal"] * (-viewdirs[:, None, :]), dim=-1)
        ori = torch.sum(render["weights"].detach()
                        * torch.clamp(ndv, max=0.0) ** 2)
        if mesh is not None:
            ori = ori * mesh.dp
        losses["orientation"] = ori
        loss = loss + w.weight_orientation * ori

    if w.sigmoid_rgb_loss > 0:
        sig = mse(render["sigmoid_rgb"], target)
        losses["sigmoid_rgb"] = sig
        loss = loss + w.sigmoid_rgb_loss * sig

    if w.weight_tv_density > 0:
        grad_field = sharded_sdf_gradient(params["sdf"], cfg_model.voxel_size,
                                          mesh, cfg_model.grad_mode)
        tv_gate = torch.as_tensor(tv_on, dtype=torch.float32,
                                  device=grad_field.device)
        tv_sg = density_tv_loss(params["sdf"], grad_field, cfg_model.voxel_size,
                                sdf_tv=0.0, smooth_grad_tv=smooth_grad_tv,
                                nonempty_mask=nonempty_mask, mesh=mesh)
        loss = loss + tv_gate * w.weight_tv_density * tv_sg
        losses["tv_smooth_grad"] = tv_sg
        if w.ori_tv:
            tv_sdf = density_tv_loss(params["sdf"], grad_field,
                                     cfg_model.voxel_size, sdf_tv=sdf_tv,
                                     smooth_grad_tv=0.0,
                                     nonempty_mask=nonempty_mask, mesh=mesh)
            loss = loss + tv_gate * w.weight_tv_density * tv_sdf
            losses["tv_sdf"] = tv_sdf
            if w.weight_tv_k0 > 0:
                from fgs_nerf_tpu_torch.models.sdf_voxel import k0_dense

                tv_k0 = k0_tv_loss(k0_dense(params, cfg_model), nonempty_mask,
                                   mesh=mesh)
                loss = loss + tv_gate * w.weight_tv_k0 * tv_k0
                losses["tv_k0"] = tv_k0

    losses["loss"] = loss
    return losses
