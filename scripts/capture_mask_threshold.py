"""Why does the capture of ``chip_smoke.py`` phase 22 train so poorly?
Trains the capture (``chip_smoke.write_capture``: 30 views of the glossy
sphere on an open arc, at 128 x 96, converted by the port's
``run_colmap``) as phase 22 does (``smart_car`` as LLFF, phase 22's
depth: geometry 16 steps over 7 rungs, coarse 14 over 6, fine 6) at
narrow grids on the CPU, and prints the geometry stage's, the coarse
stage's and the fine stage's PSNR history, the mask-cache filter's kept
ratios and, on the geometry checkpoint at the coarse grid's nodes, the
share of the 1e-3 plateau that the mask cache drops.

    python scripts/capture_mask_threshold.py [--package port|jax]
        [--slack] [--full]

``--package jax`` runs the JAX package (the reference; CPU only)
instead of the port.  ``--full`` trains phase 22 itself instead: its
capture at 504 x 378 and its config (``chip_smoke._CAPTURE_CONFIG``,
``smart_car`` at full width) on the card (the plateau share is still
counted on the host).  ``--slack`` sets the
coarse and fine ``mask_cache_thres`` to 1e-3 * (1 - 2^-7), the JAX
package's comparison on its bf16 pack,
instead of the reference's 1e-3 (ROADMAP §C: the geometry checkpoint's
``sdf_mask`` holds 1e-3 where ``sdf < 0.5``, so with an exact 1e-3 the
mask cache keeps or drops a point of that plateau by float32 rounding).
Widths: geometry and coarse 56^3 voxels, fine 80^3, 2,048 rays a step.
Prints one JSON line.
"""
import argparse
import json
import logging
import shutil
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

THRES = 1e-3
SLACK = 1e-3 * (1.0 - 2.0**-7)
HW = (96, 128)


def cut_config(root, thres):
    return dict(
        geometry_searching=dict(
            N_iters=16, N_rand=2048, pg_scale=[2, 4, 6, 8, 10, 12, 14],
            reset_iter=[2, 4, 6, 8, 10, 12, 14], decay_step_module={}),
        geometry_searching_model=dict(num_voxels=56**3,
                                      num_voxels_base=56**3),
        coarse_train=dict(N_iters=14, N_rand=2048,
                          pg_scale=[2, 4, 6, 8, 10, 12], tv_updates={},
                          decay_step_module={}),
        coarse_model=dict(num_voxels=56**3, num_voxels_base=56**3,
                          mask_cache_thres=thres),
        fine_train=dict(N_iters=6, N_rand=2048, pg_scale=[3],
                        decay_step_module={}),
        fine_model=dict(num_voxels=80**3, num_voxels_base=80**3,
                        mask_cache_thres=thres),
        data=dict(dataset_type="llff", datadir=str(root)))


def plateau_dropped(M, as_array, nodes, ckpt, thres):
    """The share of the coarse grid's nodes on the geometry checkpoint's
    1e-3 plateau that the mask cache drops at ``thres``."""
    mc = M.build_mask_cache(as_array(np.asarray(ckpt.sdf_mask)), *ckpt.box)

    def keep(t):
        return np.asarray(M.mask_cache_query(mc, nodes, t))

    plateau = keep(THRES * (1 - 1e-6)) & ~keep(THRES * (1 + 1e-6))
    return float(1.0 - (keep(thres) & plateau).sum() / plateau.sum())


def full_config(root, thres):
    """Phase 22's config with the coarse and fine threshold ``thres``."""
    import chip_smoke as CS
    from fgs_nerf_tpu_torch.config.base import deep_update

    scope = {}
    exec(CS._CAPTURE_CONFIG, scope)
    return deep_update(scope["config"], dict(
        coarse_model=dict(mask_cache_thres=thres),
        fine_model=dict(mask_cache_thres=thres),
        data=dict(dataset_type="llff", datadir=str(root))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--slack", action="store_true")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    if args.package == "jax" and args.full:
        ap.error("the JAX package runs on the CPU only, not at full width")
    device = "cuda" if args.full else "cpu"
    thres = SLACK if args.slack else THRES
    mode = "slack" if args.slack else "exact"
    out = REPO / "results" / "capture_mask_threshold" / (
        f"{args.package}_{mode}")
    shutil.rmtree(out, ignore_errors=True)
    import chip_smoke as CS
    from fgs_nerf_tpu_torch import run_colmap as RC

    root = out / "capture"
    hw = CS.LLFF_HW if args.full else HW
    CS.write_capture(str(root), hw=hw)
    config = (full_config if args.full else cut_config)(root, thres)
    assert RC.main(["--custom_dataset_path", str(root), "--skip_masks"]) == 0
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    t0 = time.perf_counter()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        from fgs_nerf_tpu.config.base import Cfg, deep_update, load_config
        from fgs_nerf_tpu.core.box import SceneBox
        from fgs_nerf_tpu.data.dataset import load_dataset
        from fgs_nerf_tpu.models import sdf_voxel as M
        from fgs_nerf_tpu.train import checkpoint as CK
        from fgs_nerf_tpu.train.pipeline import run_training

        cfg = Cfg(deep_update(dict(load_config("smart_car")), config))
        res = run_training(cfg, load_dataset(cfg), str(out / "run"),
                           i_print=1)
        as_array = jnp.asarray

        def nodes_of(r):
            return M._grid_nodes(r.cfg_model.world_size, SceneBox.create(
                np.asarray(r.box.xyz_min), np.asarray(r.box.xyz_max)))
    else:
        import torch

        from fgs_nerf_tpu_torch.config.base import deep_update, load_config
        from fgs_nerf_tpu_torch.data.dataset import load_dataset
        from fgs_nerf_tpu_torch.models import sdf_voxel as M
        from fgs_nerf_tpu_torch.train import checkpoint as CK
        from fgs_nerf_tpu_torch.train.pipeline import run_training

        cfg = load_config("smart_car")
        cfg.update(deep_update(dict(cfg), config))
        res = run_training(cfg, load_dataset(cfg), str(out / "run"),
                           i_print=1, device=device)
        as_array = torch.as_tensor

        def nodes_of(r):
            return M._grid_nodes(r.cfg_model.world_size, r.box).cpu()
    train_s = time.perf_counter() - t0
    ckpt = CK.load_checkpoint(str(out / "run" /
                                  "geometry_searching_last.npz"))
    line = {"package": args.package, "mask_cache_thres": thres,
            "hw": list(hw), "device": device, "train_s": train_s,
            "coarse_plateau_dropped": plateau_dropped(
                M, as_array, nodes_of(res["coarse"]), ckpt, thres)}
    for stage in ("geometry_searching", "coarse", "fine"):
        r = res[stage]
        line[stage] = {"world_size": list(r.cfg_model.world_size),
                       "kept_ratio": getattr(r, "kept_ratio", None),
                       "psnr": [float(x) for x in r.psnr_history]}
    print(json.dumps(line))


if __name__ == "__main__":
    main()
