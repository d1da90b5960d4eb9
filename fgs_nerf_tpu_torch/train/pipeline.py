"""Three-stage training pipeline (`train/pipeline.py`).

Stages communicate only through checkpoint files, as in the reference:
geometry_searching_last -> mask cache + bbox shrink; coarse_last -> the
fine SDF warm start.  Under a ``mesh`` every rank runs the pipeline:
rank 0 writes each checkpoint, every rank waits for it and reads it.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device
from fgs_nerf_tpu_torch.train import bbox as bbox_lib
from fgs_nerf_tpu_torch.train import trainer
from fgs_nerf_tpu_torch.train.trainer import StageResult


def run_training(cfg, data_dict: Dict, out_dir: str, *,
                 stages=("geometry_searching", "coarse", "fine"),
                 logger: Optional[logging.Logger] = None,
                 n_iters_override: Optional[Dict[str, int]] = None,
                 i_print: int = 500, i_validate: int = 0, resume: bool = False,
                 dvgo_init: bool = False, device: DeviceLike = None,
                 mesh=None) -> Dict[str, StageResult]:
    """Train the requested stages on ``device`` (None: the CUDA card), or
    as this rank of ``mesh`` (`train/pipeline.py:19-83`).
    ``dvgo_init`` trains the geometry search with the DVGO density model
    (``train/density_trainer.py``); its checkpoint feeds the later stages
    as an SDF geometry checkpoint would."""
    log = logger or logging.getLogger("fgs")
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    n_iters_override = n_iters_override or {}
    results: Dict[str, StageResult] = {}

    geo_ckpt = os.path.join(out_dir, "geometry_searching_last.npz")
    coarse_ckpt = os.path.join(out_dir, "coarse_last.npz")
    common = dict(logger=log, i_print=i_print, i_validate=i_validate,
                  resume=resume, device=dev, mesh=mesh)

    if "geometry_searching" in stages:
        xyz_min, xyz_max = bbox_lib.compute_bbox_by_cam_frustrm(cfg, data_dict)
        log.info(f"frustum bbox: {xyz_min} .. {xyz_max}")
        if dvgo_init:
            # `run.py:30-36`, `coarse_geometry_searching.py:105-380`
            from fgs_nerf_tpu_torch.train.density_trainer import (
                train_density_stage,
            )

            results["geometry_searching"] = train_density_stage(
                cfg, data_dict, xyz_min, xyz_max, out_dir, logger=log,
                i_print=i_print, device=dev, mesh=mesh,
                n_iters_override=n_iters_override.get("geometry_searching"))
        else:
            results["geometry_searching"] = trainer.train_stage(
                cfg, "geometry_searching", data_dict, xyz_min, xyz_max,
                out_dir,
                n_iters_override=n_iters_override.get("geometry_searching"),
                **common)

    if "coarse" in stages or "fine" in stages:
        xyz_min_t, xyz_max_t = bbox_lib.compute_bbox_by_coarse_geo(geo_ckpt)
        log.info(f"coarse-geo bbox: {xyz_min_t} .. {xyz_max_t}")

    if "coarse" in stages:
        results["coarse"] = trainer.train_stage(
            cfg, "coarse", data_dict, xyz_min_t, xyz_max_t, out_dir,
            mask_ckpt_path=geo_ckpt,
            n_iters_override=n_iters_override.get("coarse"), **common)

    if "fine" in stages:
        results["fine"] = trainer.train_stage(
            cfg, "fine", data_dict, xyz_min_t, xyz_max_t, out_dir,
            coarse_ckpt_path=coarse_ckpt, mask_ckpt_path=geo_ckpt,
            n_iters_override=n_iters_override.get("fine"), **common)

    return results
