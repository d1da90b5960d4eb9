"""Command line: train the three stages, or evaluate a trained run, with
the flags of the JAX package's ``run.py`` plus ``--device``.

    python -m fgs_nerf_tpu_torch.run --mode train --config quick_synthetic \\
        --expname demo --output_dir ./results --device cpu
    python -m fgs_nerf_tpu_torch.run --mode eval --config quick_synthetic \\
        --expname demo --output_dir ./results --mesh_resolution 256

``--device`` defaults to ``cuda``.  Training ends with a test-view render
and a 512^3 mesh of the last stage, as the JAX CLI does.  ``--mesh``
takes ``auto``, ``none`` or ``dp=1``: the port trains on one device, and
``dp=N`` with N > 1 raises until data parallelism is ported (ROADMAP
item A9).
"""
from __future__ import annotations

import argparse
import logging
import os
from datetime import datetime


def _flag(s: str) -> bool:
    return s not in ("0", "False", "false")


def config_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fgs_nerf_tpu_torch.run",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--config", type=str, default="shiny_blender",
                   help="built-in name (shiny_blender|dtu|smart_car|"
                        "quick_synthetic|full_synthetic) or a python file")
    p.add_argument("--expname", type=str, default="scene")
    p.add_argument("--dataset_path", type=str, default="")
    p.add_argument("--output_dir", type=str, default="./results")
    p.add_argument("--mode", type=str, default="train", help="train | eval")
    p.add_argument("--dataset_type", type=str, default="")
    p.add_argument("--dvgo_init", default=False, type=_flag,
                   help="geometry search with the DVGO density model")
    p.add_argument("--geometry_searching", default=True, type=_flag)
    p.add_argument("--coarse_training", default=True, type=_flag)
    p.add_argument("--fine_training", default=True, type=_flag)
    p.add_argument("--i_print", type=int, default=500)
    p.add_argument("--i_validate", type=int, default=100000)
    p.add_argument("--scene", type=int, default=0)
    p.add_argument("--only_mesh", action="store_true")
    p.add_argument("--mesh_resolution", type=int, default=1024)
    p.add_argument("--eval_ssim", default=True, type=_flag)
    p.add_argument("--eval_lpips", default=False, type=_flag)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--resume", action="store_true",
                   help="resume each requested stage from its saved "
                        "mid-stage checkpoint when one exists")
    p.add_argument("--render_only", action="store_true",
                   help="do not optimize; reload weights and render the "
                        "render_poses camera path")
    p.add_argument("--mesh", type=str, default="auto",
                   help="'auto', 'none' or 'dp=1' (one device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the default) or cpu")
    return p


def _check_mesh(spec: str) -> None:
    if spec in ("auto", "none"):
        return
    for part in spec.split(","):
        name, _, n = part.partition("=")
        if name.strip() not in ("dp", "sp") or not n.strip().isdigit():
            raise SystemExit(f"--mesh {spec!r}: expected 'auto', 'none' or "
                             "'dp=N[,sp=M]'")
        if int(n) > 1:
            raise NotImplementedError(
                f"--mesh {spec}: the port trains on one device; data and "
                "spatial parallelism are not ported yet (ROADMAP item A9)")


def main(argv=None) -> None:
    args = config_parser().parse_args(argv)
    _check_mesh(args.mesh)

    from fgs_nerf_tpu_torch.config.base import load_config
    from fgs_nerf_tpu_torch.device import resolve_device

    try:
        cfg = load_config(args.config)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None
    dev = resolve_device(args.device)
    if args.dataset_path:
        cfg["data"]["datadir"] = args.dataset_path
    if args.dataset_type:
        cfg["data"]["dataset_type"] = args.dataset_type
    cfg["expname"] = args.expname
    cfg["basedir"] = args.output_dir

    out_dir = os.path.join(args.output_dir, args.expname)
    os.makedirs(out_dir, exist_ok=True)
    ts = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    log = logging.getLogger("fgs")
    log.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    handlers = [logging.StreamHandler(),
                logging.FileHandler(os.path.join(out_dir,
                                                 f"{ts}_{args.mode}.log"))]
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    try:
        _run(args, cfg, out_dir, dev, log)
    finally:
        for h in handlers:
            log.removeHandler(h)
            h.close()


def _run(args, cfg, out_dir, dev, log) -> None:
    from fgs_nerf_tpu_torch.data.dataset import load_dataset

    data_dict = load_dataset(cfg)
    log.info(f"dataset: {cfg['data']['dataset_type']} "
             f"views={len(data_dict['poses'])} hw={data_dict['hwf'][:2]} "
             f"near/far={data_dict['near']}/{data_dict['far']} device={dev}")

    if args.render_only:
        from fgs_nerf_tpu_torch.eval.evaluator import render_pose_path

        render_pose_path(_find_checkpoint(out_dir), cfg, data_dict, out_dir,
                         logger=log, device=dev)
        return

    if args.mode == "train":
        from fgs_nerf_tpu_torch.train.pipeline import run_training

        stages = [s for s, on in (("geometry_searching", args.geometry_searching),
                                  ("coarse", args.coarse_training),
                                  ("fine", args.fine_training)) if on]
        if not stages:
            raise SystemExit("no stage selected")
        run_training(cfg, data_dict, out_dir, stages=tuple(stages),
                     dvgo_init=args.dvgo_init, i_print=args.i_print,
                     i_validate=args.i_validate, resume=args.resume,
                     logger=log, device=dev)
        # end-of-training eval render + mesh of the last stage
        _evaluate(args, cfg, data_dict, out_dir, log, dev, mesh_resolution=512)
    elif args.mode == "eval":
        _evaluate(args, cfg, data_dict, out_dir, log, dev,
                  mesh_resolution=args.mesh_resolution)
    else:
        raise SystemExit(f"unknown mode {args.mode}")


def _find_checkpoint(out_dir: str) -> str:
    for stage in ("fine", "coarse", "geometry_searching"):
        p = os.path.join(out_dir, f"{stage}_last.npz")
        if os.path.exists(p):
            return p
    raise SystemExit(
        f"no checkpoint found under {out_dir} — train first "
        "(expected fine_last.npz / coarse_last.npz / "
        "geometry_searching_last.npz)")


def _evaluate(args, cfg, data_dict, out_dir, log, dev, mesh_resolution):
    from fgs_nerf_tpu_torch.eval.evaluator import evaluate_checkpoint

    return evaluate_checkpoint(
        _find_checkpoint(out_dir), cfg, data_dict, out_dir,
        eval_ssim=bool(args.eval_ssim), eval_lpips=bool(args.eval_lpips),
        mesh_resolution=mesh_resolution, only_mesh=args.only_mesh,
        scene=args.scene, logger=log, device=dev)


if __name__ == "__main__":
    main()
