"""Command line: train the three stages, or evaluate a trained run, with
the flags of the JAX package's ``run.py`` plus ``--device``.

    python -m fgs_nerf_tpu_torch.run --mode train --config quick_synthetic \\
        --expname demo --output_dir ./results --device cpu
    python -m fgs_nerf_tpu_torch.run --mode eval --config quick_synthetic \\
        --expname demo --output_dir ./results --mesh_resolution 256

``--device`` defaults to ``cuda``.  Training ends with a test-view render
and a 512^3 mesh of the last stage, as the JAX CLI does.

Under ``torch.distributed.run`` (one process per rank) ``--mesh`` takes
``auto`` (dp over every rank), ``none`` or ``dp=N[,sp=M]`` with N * M
the world size (``parallel/mesh.py``): rays over dp, the ``sdf`` / ``k0``
grids in x-slabs over sp (the lattice engine).  ``--dist_backend`` is
``nccl`` (a card per rank) or ``gloo`` (the CPU, or ranks sharing a
card); a rank's device is ``cuda:LOCAL_RANK`` unless ``--device`` names
one.  Rank 0 logs and writes checkpoints, and alone runs the final
evaluation; the other ranks wait until training is done and exit::

    python -m torch.distributed.run --nproc_per_node 2 \
        -m fgs_nerf_tpu_torch.run --mesh dp=2 --dist_backend gloo \
        --device cpu --config quick_synthetic --expname demo
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
                   help="'auto', 'none' or 'dp=N[,sp=M]' (N * M ranks "
                        "under torch.distributed.run)")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=("nccl", "gloo"),
                   help="process-group backend (default: nccl on cuda, "
                        "gloo on cpu)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the default; cuda:LOCAL_RANK "
                        "under a launcher), cuda:N or cpu")
    return p


def main(argv=None) -> None:
    args = config_parser().parse_args(argv)

    from fgs_nerf_tpu_torch.config.base import load_config
    from fgs_nerf_tpu_torch.device import resolve_device
    from fgs_nerf_tpu_torch.parallel import mesh as mesh_lib

    try:
        cfg = load_config(args.config)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None
    launched = any(k in os.environ for k in mesh_lib.ENV_KEYS)
    dev = resolve_device(mesh_lib.rank_device(args.device) if launched
                         else args.device)
    if dev.type == "cuda" and dev.index is not None:
        import torch

        torch.cuda.set_device(dev)
    mesh_lib.maybe_distributed_init(
        args.dist_backend or mesh_lib.default_backend(dev), dev)
    try:
        mesh = mesh_lib.build_mesh(args.mesh, device=dev)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None
    try:
        _main(args, cfg, dev, mesh)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _main(args, cfg, dev, mesh) -> None:
    from fgs_nerf_tpu_torch.parallel.mesh import is_writer

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
    # rank 0 alone logs at INFO and keeps the log file
    log.setLevel(logging.INFO if is_writer(mesh) else logging.WARNING)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    handlers = [logging.StreamHandler()]
    if is_writer(mesh):
        handlers.append(logging.FileHandler(
            os.path.join(out_dir, f"{ts}_{args.mode}.log")))
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    try:
        _run(args, cfg, out_dir, dev, log, mesh)
    finally:
        for h in handlers:
            log.removeHandler(h)
            h.close()


def _run(args, cfg, out_dir, dev, log, mesh=None) -> None:
    from fgs_nerf_tpu_torch.data.dataset import load_dataset
    from fgs_nerf_tpu_torch.parallel.mesh import barrier, is_writer

    data_dict = load_dataset(cfg)
    log.info(f"dataset: {cfg['data']['dataset_type']} "
             f"views={len(data_dict['poses'])} hw={data_dict['hwf'][:2]} "
             f"near/far={data_dict['near']}/{data_dict['far']} device={dev}")

    if args.render_only:
        if not is_writer(mesh):
            return
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
                     logger=log, device=dev, mesh=mesh)
        # every rank has trained; rank 0 alone evaluates
        barrier(mesh)
        if is_writer(mesh):
            # end-of-training eval render + mesh of the last stage
            _evaluate(args, cfg, data_dict, out_dir, log, dev,
                      mesh_resolution=512)
    elif args.mode == "eval":
        if is_writer(mesh):
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
