"""Does the PyTorch port repeat its own training on the card?  Two probes,
each run twice in one process from the same inputs and compared bit for
bit:

1. ``step``: the sorted coarse bench step (``chip_smoke._setup``): the
   loss and every gradient leaf of ``loss_and_grads``, with the kernels,
   then with every kernel call site routed to its plain twin.
2. ``stage``: the geometry-searching stage of the ``quick_synthetic``
   config cut to ``--steps`` steps (losses logged at every step): the
   first step whose loss differs and the largest difference of the final
   parameters.

    python scripts/repeat_step_torch.py [--steps N] [--deterministic]

``--deterministic`` runs both under ``torch.use_deterministic_algorithms
(True, warn_only=True)`` (with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``) and
lists the ops that warned they have no deterministic implementation.
Prints one JSON line per probe, with the card's name and power limit.
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _differing(a, b):
    """Names of the leaves of two flat {name: tensor} dicts that differ,
    with the largest difference of each."""
    return {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a if not a[k].equal(b[k])}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None and hasattr(v, "detach"):
            out[f"{prefix}{k}"] = v.detach().clone()
    return out


def step_probe(torch, np):
    import chip_smoke as CS
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.ops import scatter as SC
    from fgs_nerf_tpu_torch.ops import sorted_cm as ST
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1

    dev = torch.device("cuda")
    n_rand = 8192
    rng = np.random.default_rng(0)
    rays_o = np.broadcast_to(np.array([0.0, 0.0, 3.5], np.float32),
                             (n_rand, 3)).copy()
    rays_d = rng.normal(size=(n_rand, 3)).astype(np.float32) * 0.4 - rays_o
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(n_rand, 3)).astype(np.float32)
    batch = [torch.as_tensor(a, device=dev)
             for a in (rays_o, rays_d, viewdirs, target)]
    _, _, params0, _, s_val, loss_and_grads, _ = CS._setup(
        torch, M, "coarse", "sorted", dev, n_rand)

    def once():
        _, losses, grads = loss_and_grads(params0, {}, *batch, s_val, 1.0)
        torch.cuda.synchronize()
        return float(losses["loss"].detach()), _flat(grads)

    out = {}
    for label in ("kernels", "plain twins"):
        if label == "kernels":
            (l1, g1), (l2, g2) = once(), once()
        else:
            with CS._plain_twins(ST, FS, SC, B1, B2, B56, B7):
                (l1, g1), (l2, g2) = once(), once()
        out[label] = dict(loss=[l1, l2], loss_equal=l1 == l2,
                          leaves=len(g1), differing=_differing(g1, g2))
    return out


def stage_probe(torch, steps):
    from fgs_nerf_tpu_torch.config.base import load_config
    from fgs_nerf_tpu_torch.data.dataset import load_dataset
    from fgs_nerf_tpu_torch.train import bbox as bbox_lib
    from fgs_nerf_tpu_torch.train import trainer

    cfg = load_config("quick_synthetic")
    data = load_dataset(cfg)
    xyz_min, xyz_max = bbox_lib.compute_bbox_by_cam_frustrm(cfg, data)
    log = logging.getLogger("fgs.repeat")
    log.setLevel(logging.INFO)
    runs = []
    for _ in range(2):
        lines = []
        handler = logging.Handler()
        handler.emit = lambda rec, lines=lines: lines.append(rec.getMessage())
        log.addHandler(handler)
        with tempfile.TemporaryDirectory(dir=ROOT / "results") as out_dir:
            res = trainer.train_stage(
                cfg, "geometry_searching", data, xyz_min, xyz_max, out_dir,
                n_iters_override=steps, i_print=1, logger=log, device="cuda")
        log.removeHandler(handler)
        torch.cuda.synchronize()
        losses = [float(m.split(" loss ")[1].split()[0])
                  for m in lines if " loss " in m]
        runs.append((losses, _flat(res.params)))
    (la, pa), (lb, pb) = runs
    first = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y), None)
    return dict(steps=len(la), losses=[la, lb], first_differing_step=first,
                params_differing=_differing(pa, pb))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--deterministic", action="store_true")
    a = ap.parse_args()
    if a.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("repeat_step_torch: needs a CUDA card")
    (ROOT / "results").mkdir(exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    warned = set()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if a.deterministic:
            torch.use_deterministic_algorithms(True, warn_only=True)
        for name, fn in (("step", lambda: step_probe(torch, np)),
                         ("stage", lambda: stage_probe(torch, a.steps))):
            res = fn()
            warned |= {str(w.message).split(" does not have")[0][:120]
                       for w in caught if "deterministic" in str(w.message)}
            print(json.dumps({"probe": name, "deterministic": a.deterministic,
                              **res, "card": card}), flush=True)
    if a.deterministic:
        print(json.dumps({"nondeterministic_ops": sorted(warned),
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
