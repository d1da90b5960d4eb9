"""The multichip dry run: two sharded training steps that cover the
parallel plan, on ``n`` local ranks.

Port of ``__graft_entry__.py:dryrun_multichip``:

1. the sorted coarse engine (the geometry / coarse fast path) on dp
   over every rank: 64^3 grid, 1,024 rays a rank, ``sample_k`` 96;
2. a fine lattice step on (dp, sp) with sp = 2 when ``n`` is even:
   ``sdf`` / ``k0`` and their Adam moments in x-slabs, the field gathers
   through the sharded gather (the sorted engine does not compose with
   sp and falls back to the lattice pipeline).

Both losses must be finite.
"""
from __future__ import annotations

import math

import numpy as np

LRS = {"sdf": 5e-3, "k0": 0.1, "refnet": 1e-3, "rgbnet": 1e-3}


def _tiny_setup(device, stage="fine", n_rays=256, grid=24, **cfg_overrides):
    """(cfg, box, params, batch) as ``__graft_entry__.py:_tiny_setup``
    builds them, with the port's seed-0 parameters."""
    import torch

    from fgs_nerf_tpu_torch.core.box import SceneBox
    from fgs_nerf_tpu_torch.models import sdf_voxel as M

    xyz_min = np.array([-1.0, -1.0, -1.0], np.float32)
    xyz_max = np.array([1.0, 1.0, 1.0], np.float32)
    kwargs = dict(
        stage=stage, xyz_min=xyz_min, xyz_max=xyz_max,
        num_voxels=grid**3, num_voxels_base=grid**3, stepsize=0.5,
        k0_dim=12, refnet_width=64, refnet_depth=3,
        rgbnet_width=64, rgbnet_depth=3,
        posbase_pe=5, viewbase_pe=3, refbase_pe=8,
        s_ratio=50.0, s_start=0.05, shade_k=32,
    )
    if stage == "fine":
        kwargs.update(grad_feat=(0.5, 1.0, 1.5, 2.0),
                      sdf_feat=(0.5, 1.0, 1.5, 2.0))
    kwargs.update(cfg_overrides)
    cfg = M.make_model_config(**kwargs)
    box = SceneBox.create(xyz_min, xyz_max, device=device)
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    rng = np.random.default_rng(0)
    rays_o = np.full((n_rays, 3), [0.0, 0.0, 3.0], np.float32)
    look = rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.3
    rays_d = look - rays_o
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(n_rays, 3)).astype(np.float32)
    batch = tuple(torch.as_tensor(a, device=device)
                  for a in (rays_o, rays_d, viewdirs, target))
    return cfg, box, params, batch


def _one_step(mesh, device, cfg, box, params, batch, loss_w, inject_tv,
              skip, s_val):
    import torch

    from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts, init_state
    from fgs_nerf_tpu_torch.parallel.mesh import check_replicas, shard_batch
    from fgs_nerf_tpu_torch.parallel.spatial_train import place_spatial
    from fgs_nerf_tpu_torch.train.trainer import make_train_step

    check_replicas(mesh, params)
    opts = {k: ParamOpts(skip_zero_grad=k in skip) for k in params}
    step = make_train_step(
        cfg, box, loss_w, opts, near=0.2, bg=1.0, n_rand=batch[0].shape[0],
        sdf_tv=0.1, smooth_grad_tv=0.05, inject_tv=inject_tv, tv_dense=True,
        weight_tv_density=0.01, weight_tv_k0=0.0, use_nonempty_mask=False,
        mesh=mesh)
    opt = init_state(params)
    if mesh.sp > 1:
        params, opt = place_spatial(mesh, params, opt)
    lrs = {k: torch.tensor(v, device=device) for k, v in LRS.items()
           if k in params}
    one = torch.tensor(1.0, device=device)
    _, _, metrics = step(params, opt, {}, *shard_batch(mesh, *batch),
                         torch.tensor(s_val, device=device), lrs, one)
    return float(metrics["loss"])


def _dryrun_rank(device):
    """One rank of the dry run: (loss of the dp sorted step, loss of the
    (dp, sp) fine step)."""
    import torch.distributed as dist

    from fgs_nerf_tpu_torch.device import resolve_device
    from fgs_nerf_tpu_torch.parallel.mesh import build_mesh, rank_device
    from fgs_nerf_tpu_torch.train.losses import LossWeights

    device = resolve_device(rank_device(device))
    n = dist.get_world_size()
    # 1. the sorted coarse step, dp over every rank
    mesh = build_mesh(f"dp={n}", device=device)
    cfg, box, params, batch = _tiny_setup(
        device, stage="coarse", n_rays=1024 * n, grid=64, engine="sorted",
        sample_k=96, shade_k=0, s_start=0.2, smooth_ksize=5,
        smooth_sigma=0.8)
    loss_w = LossWeights(
        weight_main=1.0, weight_rgbper=0.2, weight_entropy_last=1e-3,
        weight_orientation=1e-4, sigmoid_rgb_loss=0.1,
        weight_tv_density=0.01, ori_tv=True)
    loss_dp = _one_step(mesh, device, cfg, box, params, batch, loss_w, False,
                        ("k0", "sdf"), 0.2)

    # 2. the (dp, sp) fine step, grids in x-slabs
    sp = 2 if n % 2 == 0 else 1
    mesh = build_mesh(f"dp={n // sp},sp={sp}", device=device)
    cfg, box, params, batch = _tiny_setup(
        device, stage="fine", n_rays=16 * n, grid=16, sp_multiple=sp)
    loss_w = LossWeights(
        weight_main=1.0, weight_rgbper=0.0, weight_entropy_last=1e-3,
        weight_orientation=1e-4, sigmoid_rgb_loss=0.02,
        weight_tv_density=0.01, ori_tv=False)
    loss = _one_step(mesh, device, cfg, box, params, batch, loss_w, True,
                     ("k0",), 0.05)
    return {"loss_dp": loss_dp, "loss": loss, "sp": sp}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 300.0):
    """Run the dry run on ``n_devices`` local ranks (``device`` "cuda": a
    card a rank, NCCL; "cuda:0": every rank on one card, gloo; "cpu": gloo
    on the CPU); returns (dp sorted loss, (dp, sp) fine loss) and raises
    unless both are finite and every rank agrees."""
    from fgs_nerf_tpu_torch.parallel.launch import launch_local

    res = launch_local(n_devices,
                       "fgs_nerf_tpu_torch.parallel.dryrun:_dryrun_rank",
                       device=device, timeout=timeout)
    losses = [(float(r["loss_dp"]), float(r["loss"])) for r in res]
    if any(v != losses[0] for v in losses):
        raise RuntimeError(f"ranks disagree on the dry run's losses: {losses}")
    loss_dp, loss = losses[0]
    if not (math.isfinite(loss_dp) and math.isfinite(loss)):
        raise RuntimeError(f"non-finite dry-run loss: {loss_dp}, {loss}")
    sp = int(res[0]["sp"])
    print(f"dryrun_multichip({n_devices}): dp-sorted(64^3, "
          f"{1024 * n_devices} rays) loss={loss_dp:.6f}, "
          f"(dp={n_devices // sp}, sp={sp}) fine loss={loss:.6f} ok")
    return loss_dp, loss
