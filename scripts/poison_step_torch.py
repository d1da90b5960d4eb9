"""Do the port's train steps read device memory they never wrote?  For the
sorted coarse and fine ``bench.py`` steps, the lattice coarse step
(``chip_smoke._setup``) and the ``dtu`` config's geometry step at its
full grid (from the ball init), this runs ``loss_and_grads`` once in fresh
memory, then fills the caching allocator's free memory with a poison
value (NaN, then 1e30) and runs it again from the same inputs; then it
does the same for every kernel call the step made, on its recorded
inputs.  A result that reads memory it did not write changes with the
poison.  Prints one JSON line per step and per kernel call: whether the
loss, each gradient leaf and each kernel output repeat bit for bit, the
first differing leaves, with the card's name and power limit.

    python scripts/poison_step_torch.py [--repeats R]

``--repeats R`` also runs every kernel call R more times in a row and
counts the outputs that differ from its first (a race shows as a rare
difference), with the largest difference.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _poison(torch, value):
    """Fill the caching allocator's free memory with ``value``: 1 GiB
    blocks until 4 GiB of the card stay free, then 1 MiB blocks for the
    small pool, all dropped without ``empty_cache``."""
    held = []
    while torch.cuda.mem_get_info()[0] > 4 << 30:
        held.append(torch.full((1 << 28,), value, device="cuda"))
    held += [torch.full((1 << 18,), value, device="cuda") for _ in range(512)]
    torch.cuda.synchronize()
    del held


def _tensors(x):
    """The tensors of a kernel's output (a tensor or nested lists)."""
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return [x]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v.detach().clone()
    return out


def _dtu_geometry(torch, M, dev):
    """(params, s_val, loss_and_grads) of the built-in ``dtu`` config's
    geometry-searching step at its full grid, as ``train/trainer.py``
    builds it, over the box [-1, 1]^3."""
    from fgs_nerf_tpu_torch.config.base import load_config, stage_blocks
    from fgs_nerf_tpu_torch.core.box import SceneBox
    from fgs_nerf_tpu_torch.train import trainer as TR
    from fgs_nerf_tpu_torch.train.stage_common import config_passthrough

    blk, trn = stage_blocks(load_config("dtu"), "geometry_searching")
    lo, hi = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)
    cfg = M.make_model_config(stage="geometry_searching", xyz_min=lo,
                              xyz_max=hi, num_voxels=int(blk["num_voxels"]),
                              **config_passthrough(blk, M.SDFModelConfig))
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
    tv = dict(trn.get("tv_terms", {}))
    fn = TR.make_loss_and_grads(
        cfg, SceneBox.create(lo, hi, dev), TR.loss_weights_from_cfg(trn),
        near=0.2, bg=1.0, sdf_tv=float(tv.get("sdf_tv", 0.0)),
        smooth_grad_tv=float(tv.get("smooth_grad_tv", 0.0)),
        use_nonempty_mask=False)
    return params, torch.tensor(cfg.s_start, device=dev), fn


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as CS
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.ops import scatter as SC
    from fgs_nerf_tpu_torch.ops import sorted_cm as ST
    from fgs_nerf_tpu_torch.ops.cuda import build
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1

    if not torch.cuda.is_available():
        raise SystemExit("poison_step_torch: needs a CUDA card")
    build.build_all((B1.KERNEL, B2.KERNEL, FS.KERNEL, B56.KERNEL, B7.KERNEL))
    card = CS._card_line()
    dev = torch.device("cuda")
    n_rand = 8192
    rng = np.random.default_rng(0)
    cam = np.array([0.0, 0.0, 3.5], np.float32)
    rays_o = np.broadcast_to(cam, (n_rand, 3)).copy()
    rays_d = rng.normal(size=(n_rand, 3)).astype(np.float32) * 0.4 - rays_o
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(n_rand, 3)).astype(np.float32)
    batch = [torch.as_tensor(a, device=dev)
             for a in (rays_o, rays_d, viewdirs, target)]
    sites = [(ST, n) for n in ("window_gather_cm", "dense_accumulate_cm",
                               "tap_window_serve_cm",
                               "tap_dense_accumulate_cm")]
    sites += [(FS, "fused_shade_cm_fwd"), (FS, "fused_shade_cm_bwd"),
              (SC, "dense_accumulate")]

    for stage, engine in (("coarse", "sorted"), ("fine", "sorted"),
                          ("coarse", "lattice"), ("dtu geometry", "sorted")):
        if stage == "dtu geometry":
            params, s_val, loss_and_grads = _dtu_geometry(torch, M, dev)
        else:
            _, _, params, _, s_val, loss_and_grads, _ = CS._setup(
                torch, M, stage, engine, dev, n_rand)
        calls = []

        def recorder(name, fn):
            def run(*args):
                calls.append((name, CS._clone(args, torch)))
                return fn(*args)
            return run

        def step():
            _, lk, gk = loss_and_grads(params, {}, *batch, s_val, 1.0)
            out = {"loss": lk["loss"].detach().clone(), **_flat(gk)}
            torch.cuda.synchronize()
            return out

        with CS._patched([(mod, n, recorder(n, getattr(mod, n)))
                          for mod, n in sites]):
            fresh = step()
        report = {"step": f"{engine} {stage}", "card": card}
        for value in (float("nan"), 1e30):
            _poison(torch, value)
            again = step()
            report[f"differs_after_{value}"] = sorted(
                k for k in fresh if not torch.equal(fresh[k], again[k]))
            del again
        print(json.dumps(report))
        del fresh
        seen = {}
        while calls:
            name, args_ = calls.pop(0)
            seen[name] = seen.get(name, 0) + 1
            mod = next(m for m, n in sites if n == name)
            fn = getattr(mod, name)
            torch.cuda.empty_cache()
            first = [t.clone() for t in _tensors(fn(*args_))]
            line = {"kernel": name, "call": seen[name],
                    "step": f"{engine} {stage}"}
            for value in (float("nan"), 1e30):
                _poison(torch, value)
                out = _tensors(fn(*args_))
                line[f"equal_after_{value}"] = all(
                    torch.equal(a, b) for a, b in zip(first, out))
                line[f"nan_after_{value}"] = any(
                    bool(torch.isnan(b).any()) for b in out)
                del out
            n_diff, worst = 0, 0.0
            for _ in range(args.repeats):
                out = _tensors(fn(*args_))
                d = max(float((a - b).abs().max()) if a.numel() else 0.0
                        for a, b in zip(first, out))
                n_diff += d != 0.0 or not all(torch.equal(a, b)
                                              for a, b in zip(first, out))
                worst = max(worst, d)
                del out
            if args.repeats:
                line.update(repeats=args.repeats, repeats_differing=n_diff,
                            repeats_max_abs=worst)
            print(json.dumps(line))
            del first, args_
        del params, loss_and_grads
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
