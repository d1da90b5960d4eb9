"""Stage-loop scaffolding of the stage driver (`train/stage_common.py`):
the world-bound inflation, the progressive-scaling deduction, the config
filter, the per-view rays, the per-voxel learning rate and the i_print
window.  Metrics stay on the device until a window is flushed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.data import rays as ray_lib
from fgs_nerf_tpu_torch.device import DeviceLike
from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts


def apply_world_bound_scale(cfg_model_blk, xyz_min, xyz_max,
                            device: DeviceLike = None):
    """Symmetric bbox inflation (`stage_common.py:25-32`)."""
    wbs = cfg_model_blk.get("world_bound_scale", 1.0)
    if abs(wbs - 1.0) > 1e-9:
        shift = (xyz_max - xyz_min) * (wbs - 1.0) / 2.0
        xyz_min = xyz_min - shift
        xyz_max = xyz_max + shift
    return xyz_min, xyz_max, SceneBox.create(xyz_min, xyz_max, device)


def pg_deduction(cfg_train, cfg_model_blk) -> Tuple[int, list, int]:
    """The starting voxel budget is the final one divided by
    scale_ratio^len(pg_scale) (`stage_common.py:35-42`)."""
    scale_ratio = cfg_train.get("scale_ratio", 2)
    pg_scale = list(cfg_train.get("pg_scale", []))
    num_voxels = int(cfg_model_blk["num_voxels"])
    cur_voxels = int(num_voxels / (scale_ratio ** len(pg_scale)))
    return scale_ratio, pg_scale, cur_voxels


def config_passthrough(cfg_model_blk, config_cls, extra_exclude=()):
    """A config block filtered to the dataclass's dynamic fields; derived
    grid geometry is recomputed per rung (`stage_common.py:45-59`)."""
    keys = {f.name for f in dataclasses.fields(config_cls)}
    exclude = {"stage", "num_voxels", "world_size", "voxel_size",
               "voxel_size_base", "s_max", *extra_exclude}
    out = {k: (tuple(v) if isinstance(v, list) else v)
           for k, v in dict(cfg_model_blk).items()
           if k in keys and k not in exclude}
    out["num_voxels_base"] = int(cfg_model_blk["num_voxels_base"])
    return out


def gather_view_rays(cfg, data_dict):
    """Per-training-view ray tensors + the camera-convention dict
    (`stage_common.py:62-75`)."""
    images = np.asarray(data_dict["images"])[data_dict["i_train"]]
    poses = np.asarray(data_dict["poses"])[data_dict["i_train"]]
    hw = np.asarray(data_dict["HW"])[data_dict["i_train"]]
    ks = np.asarray(data_dict["Ks"])[data_dict["i_train"]]
    conv = dict(ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
                flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
    rgb_tr, o_tr, d_tr, v_tr = ray_lib.get_training_rays(
        images, poses, hw, ks, **conv)
    return rgb_tr, o_tr, d_tr, v_tr, conv


def apply_pervoxel_lr(params: Dict[str, Any], opts: Dict[str, ParamOpts],
                      buffers: Dict[str, Any], cnt: torch.Tensor,
                      clamp_param: str, clamp_value: float):
    """Visibility-count per-voxel learning rates on every param shaped
    like the count grid, and the near-invisible clamp
    (`stage_common.py:78-104`)."""
    plr = cnt / torch.clamp(cnt.max(), min=1.0)
    buffers["per_lr"] = {
        name: plr for name, p in params.items()
        if isinstance(p, torch.Tensor) and p.shape == cnt.shape
    }
    for name in buffers["per_lr"]:
        opts[name] = dataclasses.replace(opts[name], has_per_lr=True)
    params = dict(params)
    params[clamp_param] = torch.where(cnt <= 2, clamp_value,
                                      params[clamp_param])
    return params, opts, buffers


def drop_pervoxel_lr(opts, buffers):
    """Reference quirk: per-voxel LR is not recomputed after a rescale
    (`stage_common.py:107-113`)."""
    if "per_lr" in buffers:
        for name in buffers.pop("per_lr"):
            opts[name] = dataclasses.replace(opts[name], has_per_lr=False)
    return opts, buffers


class PrintWindow:
    """i_print metric aggregation (`stage_common.py:116-154`): per-step
    metric tensors are kept on the device and copied to the host only at
    ``flush``."""

    def __init__(self, log, tag: str, n_iters: int):
        self.log = log
        self.tag = tag
        self.n_iters = n_iters
        self.pending = []
        self.t0 = time.time()
        self.psnr_history: list = []
        self.last_means: Dict[str, float] = {}

    def push(self, metrics):
        self.pending.append(metrics)

    def flush(self, global_step: int, extra: str = "") -> None:
        got = fetch_metrics(self.pending)
        self.pending = []
        if not got:
            return
        psnrs = [-10.0 * np.log10(max(float(m["mse"]), 1e-12)) for m in got]
        self.psnr_history.extend(psnrs)
        self.last_means = {k: float(np.mean([m[k] for m in got]))
                           for k in got[0]}
        msg = (f"[{self.tag}] iter {global_step:6d}/{self.n_iters} "
               f"loss {self.last_means['loss']:.6f} "
               f"PSNR {np.mean(psnrs):5.2f} "
               f"Wmax {self.last_means.get('wmax_mean', 0.0):.3f} "
               f"W>0 {self.last_means.get('w_nonzero_frac', 0.0):.3f} ")
        if extra:
            msg += extra + " "
        msg += f"eps {time.time() - self.t0:.0f}s"
        self.log.info(msg)


def fetch_metrics(pending):
    """A list of per-step metric dicts of 0-d device tensors -> host
    floats, with one device-to-host copy for the whole window."""
    if not pending:
        return []
    keys = list(pending[0])
    stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                           for m in pending]).cpu().numpy()
    return [dict(zip(keys, row.tolist())) for row in stacked]
