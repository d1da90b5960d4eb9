"""Rank programs for the port's multi-process tests, and the inputs both
sides share.

The tests (``tests/test_torch_{spatial,parallel,distributed}.py``) build
the JAX references in the pytest process and start the torch ranks with
``fgs_nerf_tpu_torch.parallel.launch.launch_local`` (gloo, one CPU
thread a rank).  A rank imports torch, numpy and the port only: this
module imports no JAX and nothing of ``fgs_nerf_tpu``.  Inputs are made
here with numpy from fixed seeds, so both sides see the same arrays;
JAX-initialised parameters reach the ranks as ``.npz`` files.
"""
import os

import numpy as np

BOX = (np.array([-1.0, -1.0, -1.0], np.float32),
       np.array([1.0, 1.0, 1.0], np.float32))

COARSE_CFG = dict(
    stage="coarse", num_voxels=16**3, num_voxels_base=16**3, stepsize=0.5,
    k0_dim=4, refnet_width=16, refnet_depth=3, posbase_pe=2, viewbase_pe=1,
    refbase_pe=2, s_ratio=50.0, s_start=0.2, shade_k=16)
FINE_CFG = dict(
    stage="fine", num_voxels=15**3, num_voxels_base=15**3, stepsize=0.5,
    k0_dim=4, refnet_width=16, refnet_depth=3, rgbnet_width=16,
    rgbnet_depth=3, posbase_pe=2, viewbase_pe=1, refbase_pe=2, s_ratio=50.0,
    s_start=0.2, shade_k=16, smooth_ksize=5, smooth_sigma=0.8,
    grad_feat=(1.0, 2.0), sdf_feat=(1.0, 2.0), k_grad_feat=(1.0,),
    k_sdf_feat=(1.0,), sp_multiple=2)
COARSE_LOSS = dict(weight_main=1.0, weight_entropy_last=1e-3,
                   weight_orientation=1e-4, sigmoid_rgb_loss=0.1,
                   weight_tv_density=0.01, ori_tv=True)
FINE_LOSS = dict(COARSE_LOSS, ori_tv=False)
COARSE_STEP = dict(near=0.2, bg=1.0, sdf_tv=0.1, smooth_grad_tv=0.05,
                   inject_tv=False, tv_dense=True, weight_tv_density=0.01,
                   weight_tv_k0=0.0, use_nonempty_mask=False)
FINE_STEP = dict(COARSE_STEP, inject_tv=True)
LRS = {"sdf": 0.1, "k0": 0.1, "refnet": 1e-3, "rgbnet": 1e-3}
S_VAL, TV_ON = 0.2, 1.0

# run_training's geometry stage (`tests/test_parallel.py:166-183`)
TINY_GEOMETRY = dict(
    geometry_searching=dict(N_iters=8, N_rand=256, pg_scale=[], inc_steps=4,
                            save_iter=10**9, decay_step_module={}),
    geometry_searching_model=dict(num_voxels=16**3, num_voxels_base=16**3,
                                  shade_k=32))


def rays(n_rays, seed):
    """(rays_o, rays_d, viewdirs, target), the JAX tests' draws."""
    rng = np.random.default_rng(seed)
    rays_o = np.full((n_rays, 3), [0, 0, 3.0], np.float32)
    rays_o += rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.2
    look = rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.3
    rays_d = look - rays_o
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(n_rays, 3)).astype(np.float32)
    return rays_o, rays_d, viewdirs, target


def sample_idx(rng, x, y, z, m):
    """Index coordinates over the interior, the borders and out of range
    (`tests/test_spatial.py:_sample_idx`)."""
    idx = np.stack([rng.uniform(-1.5, x + 0.5, size=m),
                    rng.uniform(-1.5, y + 0.5, size=m),
                    rng.uniform(-1.5, z + 0.5, size=m)], -1).astype(np.float32)
    idx[0] = [0.0, 0.0, 0.0]
    idx[1] = [x - 1.0, y - 1.0, z - 1.0]
    idx[2] = [x - 1.5, 0.5, z - 1.0]
    idx[3] = [-0.5, 0.0, 0.0]
    return idx


def spatial_inputs():
    """The grids and samples of the spatial cases, by name."""
    def normal(seed, shape):
        return np.random.default_rng(seed).normal(size=shape).astype(np.float32)

    rng = np.random.default_rng(6)
    out = {
        "halo_zero": normal(1, (16, 3, 4, 2)),
        "halo_replicate": normal(2, (8, 3, 3, 1)),
        "smooth": normal(3, (16, 7, 6, 2)),
        "sdf_gradient": normal(4, (12, 6, 5, 1)),
        "trilinear": normal(5, (16, 6, 5, 3)),
        "trilinear_idx": sample_idx(np.random.default_rng(7), 16, 6, 5, 257),
        "grid_grad": normal(8, (8, 5, 4, 2)),
        "grid_grad_idx": sample_idx(rng, 8, 5, 4, 129),
        "grid_grad_cot": rng.normal(size=(129, 2)).astype(np.float32),
        # 15 planes: unequal slabs, padded inside the gather
        "gather15": normal(9, (15, 6, 5, 3)),
        "gather15_idx": sample_idx(np.random.default_rng(10), 15, 6, 5, 200),
        "gather15_cot": normal(11, (200, 3)),
    }
    return out


SPATIAL_MESHES = (("dp=1,sp=4", 4), ("dp=2,sp=2", 2))
SDF_GRAD_MODES = ("interpolate", "raw", "grad_conv")


def save_tree(path, tree):
    flat = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix[:-1]] = np.asarray(t, np.float32)

    walk("", tree)
    np.savez(path, **flat)


def load_tree(path):
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            node = tree
            *parents, leaf = k.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return tree


def _flat_out(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_out(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = tree.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------


def spatial_rank(device):
    """Every spatial case on sp = 4 (one group of 4) and sp = 2 (two
    groups of 2): this rank's slab of each output, or the sample values
    and grid gradients."""
    import torch

    from fgs_nerf_tpu_torch.ops.stencils import smooth_grid
    from fgs_nerf_tpu_torch.parallel.mesh import build_mesh
    from fgs_nerf_tpu_torch.parallel.spatial import (
        grid_slab, halo_exchange, sharded_sdf_gradient, sharded_stencil,
        sharded_trilinear_sample,
    )
    from fgs_nerf_tpu_torch.parallel.spatial_train import (
        gather_grid, make_spatial_gather,
    )

    ins = {k: torch.as_tensor(v) for k, v in spatial_inputs().items()}
    out = {}
    for spec, n in SPATIAL_MESHES:
        mesh = build_mesh(spec, device=device)
        out[f"sp{n}/dp_index"] = mesh.dp_index
        out[f"sp{n}/sp_index"] = mesh.sp_index

        def slab(name):
            return grid_slab(mesh, ins[name])

        for halo in (1, 2):
            out[f"sp{n}/halo_zero/{halo}"] = halo_exchange(
                slab("halo_zero"), halo, mesh, edge="zero").numpy()
        out[f"sp{n}/halo_replicate"] = halo_exchange(
            slab("halo_replicate"), 2, mesh, edge="replicate").numpy()
        out[f"sp{n}/smooth"] = sharded_stencil(
            lambda g: smooth_grid(g, 5, 0.8), slab("smooth"), 2, mesh,
            edge="replicate").numpy()
        for mode in SDF_GRAD_MODES:
            out[f"sp{n}/sdf_gradient/{mode}"] = sharded_sdf_gradient(
                slab("sdf_gradient"), 0.37, mesh, mode=mode).numpy()
        out[f"sp{n}/trilinear"] = sharded_trilinear_sample(
            slab("trilinear"), ins["trilinear_idx"], 16, mesh).numpy()
        g = slab("grid_grad").requires_grad_(True)
        vals = sharded_trilinear_sample(g, ins["grid_grad_idx"], 8, mesh)
        torch.sum(vals * ins["grid_grad_cot"]).backward()
        out[f"sp{n}/grid_grad"] = g.grad.numpy()
        # the training gather on unequal slabs (15 planes)
        g15 = slab("gather15").requires_grad_(True)
        vals = make_spatial_gather(mesh)(g15, ins["gather15_idx"], 15)
        torch.sum(vals * ins["gather15_cot"]).backward()
        out[f"sp{n}/gather15"] = vals.detach().numpy()
        out[f"sp{n}/gather15_grad"] = gather_grid(mesh, g15.grad, 15).numpy()
    return out


def _port_setup(cfg_kw, loss_kw, device):
    from fgs_nerf_tpu_torch.core.box import SceneBox
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.train.losses import LossWeights

    cfg = M.make_model_config(xyz_min=BOX[0], xyz_max=BOX[1], **cfg_kw)
    return cfg, SceneBox.create(*BOX, device=device), LossWeights(**loss_kw)


def _step(cfg_kw, loss_kw, step_kw, params_path, n_rays, seed, mesh, device):
    """One train step of the port on ``mesh`` from the JAX-initialised
    parameters: (loss, full new params)."""
    import torch

    from fgs_nerf_tpu_torch import convert
    from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts, init_state
    from fgs_nerf_tpu_torch.parallel.mesh import check_replicas, shard_batch
    from fgs_nerf_tpu_torch.parallel.spatial_train import (
        gather_spatial, place_spatial,
    )
    from fgs_nerf_tpu_torch.train.trainer import make_train_step

    cfg, box, loss_w = _port_setup(cfg_kw, loss_kw, device)
    params = convert.params_from_jax(load_tree(params_path), device)
    opts = {k: ParamOpts(skip_zero_grad=k in ("k0", "sdf")) for k in params}
    step = make_train_step(cfg, box, loss_w, opts, n_rand=n_rays, mesh=mesh,
                           **step_kw)
    opt = init_state(params)
    if mesh is not None and mesh.sp > 1:
        params, opt = place_spatial(mesh, params, opt)
    batch = shard_batch(mesh, *(torch.as_tensor(a)
                                for a in rays(n_rays, seed)))
    lrs = {k: torch.tensor(v) for k, v in LRS.items() if k in params}
    new_p, _, metrics = step(params, opt, {}, *batch, torch.tensor(S_VAL),
                             lrs, torch.tensor(TV_ON))
    full = gather_spatial(mesh, new_p, cfg.world_size[0])
    check_replicas(mesh, full, "post-step params")
    return float(metrics["loss"]), full


def parallel_rank(device, case_dir):
    """The dp, sp and (dp, sp) steps against the single-device JAX step,
    and the mesh specs, on a world of 4."""
    import torch

    from fgs_nerf_tpu_torch import convert
    from fgs_nerf_tpu_torch.parallel.mesh import build_mesh
    from fgs_nerf_tpu_torch.train.trainer import (
        dp_reduce, make_loss_and_grads, step_metrics,
    )

    out = {}
    # sorted coarse engine on dp = 4: loss and dp-averaged gradients
    mesh = build_mesh("dp=4", device=device)
    kw = dict(COARSE_CFG, engine="sorted")
    cfg, box, loss_w = _port_setup(kw, COARSE_LOSS, device)
    params = convert.params_from_jax(
        load_tree(os.path.join(case_dir, "sorted.npz")), device)
    lg = make_loss_and_grads(
        cfg, box, loss_w, near=0.2, bg=1.0, sdf_tv=0.1, smooth_grad_tv=0.05,
        use_nonempty_mask=False, mesh=mesh)
    from fgs_nerf_tpu_torch.parallel.mesh import shard_batch

    batch = shard_batch(mesh, *(torch.as_tensor(a) for a in rays(32, 3)))
    render, losses, grads = lg(params, {}, *batch, torch.tensor(S_VAL),
                               torch.tensor(TV_ON))
    grads, metrics = dp_reduce(mesh, grads, step_metrics(render, losses))
    out["sorted/loss"] = float(metrics["loss"])
    _flat_out("sorted/grad", grads, out)
    loss, p = _step(kw, COARSE_LOSS, COARSE_STEP,
                    os.path.join(case_dir, "sorted.npz"), 32, 3, mesh, device)
    out["sorted/step_loss"], out["sorted/sdf"] = loss, p["sdf"].numpy()
    # the same step on one device, in this process
    _, p = _step(kw, COARSE_LOSS, COARSE_STEP,
                 os.path.join(case_dir, "sorted.npz"), 32, 3, None, device)
    out["sorted/single_sdf"] = p["sdf"].numpy()

    # lattice coarse step on dp = 4
    lattice = os.path.join(case_dir, "lattice.npz")
    loss, p = _step(COARSE_CFG, COARSE_LOSS, COARSE_STEP, lattice, 32, 3,
                    mesh, device)
    out["dp/loss"], out["dp/sdf"] = loss, p["sdf"].numpy()
    out["dp/refnet_w0"] = p["refnet"]["w0"].numpy()
    _, p = _step(COARSE_CFG, COARSE_LOSS, COARSE_STEP, lattice, 32, 3, None,
                 device)
    out["dp/single_sdf"] = p["sdf"].numpy()
    out["dp/single_refnet_w0"] = p["refnet"]["w0"].numpy()

    # fine lattice step on (dp = 2, sp = 2), 15^3 rounded to 16 planes
    mesh = build_mesh("dp=2,sp=2", device=device)
    loss, p = _step(FINE_CFG, FINE_LOSS, FINE_STEP,
                    os.path.join(case_dir, "fine.npz"), 32, 5, mesh, device)
    out["dpsp/loss"] = loss
    _flat_out("dpsp/p", p, out)

    # sp only: (dp = 1, sp = 4), lattice coarse, 16 rays
    mesh = build_mesh("dp=1,sp=4", device=device)
    loss, p = _step(COARSE_CFG, COARSE_LOSS, COARSE_STEP, lattice, 16, 3,
                    mesh, device)
    out["sp/loss"], out["sp/sdf"] = loss, p["sdf"].numpy()
    _, p = _step(COARSE_CFG, COARSE_LOSS, COARSE_STEP, lattice, 16, 3, None,
                 device)
    out["sp/single_sdf"] = p["sdf"].numpy()

    # build_mesh's specs (`tests/test_parallel.py:221-231`)
    try:  # no mesh in a world of 4: each rank would train alone
        build_mesh("none")
        out["specs/none"] = False
    except ValueError:
        out["specs/none"] = True
    m = build_mesh("dp=2,sp=2", device=device)
    out["specs/shape"] = np.array([m.dp, m.sp, m.dp_index, m.sp_index])
    m = build_mesh("auto", device=device)
    out["specs/auto"] = np.array([m.dp, m.sp])
    for bad in ("dp=64", "dp", "tp=4"):
        try:
            build_mesh(bad, device=device)
            out[f"specs/raises/{bad}"] = False
        except ValueError:
            out[f"specs/raises/{bad}"] = True
    return out


def training_rank(device, out_dir, params_path=None):
    """``run_training``'s geometry stage on ``build_mesh('auto')`` (dp over
    the world; one device without a process group), 4 synthetic views of
    24 x 24, from the parameters in ``params_path`` when given (the JAX
    package's initialisation)."""
    from fgs_nerf_tpu_torch import convert
    from fgs_nerf_tpu_torch.config.base import Cfg, deep_update, load_config
    from fgs_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.parallel.mesh import build_mesh
    from fgs_nerf_tpu_torch.train.pipeline import run_training

    if params_path is not None:
        M.init_params = lambda gen, cfg, dev=None: convert.params_from_jax(
            load_tree(params_path), dev)
    mesh = build_mesh("auto", device=device)
    cfg = Cfg(deep_update(dict(load_config("shiny_blender")), TINY_GEOMETRY))
    data = make_synthetic_dataset(n_views=4, h=24, w=24, n_test=1)
    r = run_training(cfg, data, out_dir, stages=("geometry_searching",),
                     device=device, mesh=mesh)["geometry_searching"]
    return {"dp": 1 if mesh is None else mesh.dp,
            "psnr": np.asarray(r.psnr_history),
            "sdf": r.params["sdf"].cpu().numpy()}


def distributed_rank(device, ckpt_path):
    """Two ranks: the dp rows of one global batch, then an sp = 2
    checkpoint written from slabs, read back and placed again."""
    import torch

    from fgs_nerf_tpu_torch import convert
    from fgs_nerf_tpu_torch.optim.masked_adam import init_state
    from fgs_nerf_tpu_torch.parallel.mesh import (
        all_reduce_sum, build_mesh, shard_batch,
    )
    from fgs_nerf_tpu_torch.parallel.spatial_train import (
        gather_spatial, place_spatial,
    )
    from fgs_nerf_tpu_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    out = {}
    mesh = build_mesh("dp=2", device=device)
    n = 16
    batch = np.arange(n * 3, dtype=np.float32).reshape(n, 3) * 0.5
    (local,) = shard_batch(mesh, torch.as_tensor(batch, device=device))
    out["rows"] = local.cpu().numpy()
    out["sum"] = float(all_reduce_sum(torch.sum(local * 2.0), mesh.dp_group))

    mesh = build_mesh("dp=1,sp=2", device=device)
    params_np = checkpoint_params()
    params = convert.params_from_jax(params_np, device)
    params, opt = place_spatial(mesh, params, init_state(params))
    out["slab_planes"] = params["sdf"].shape[0]
    full_p, full_o = gather_spatial(mesh, params, 8, opt)
    save_checkpoint(ckpt_path, global_step=3, params=full_p, opt_state=full_o,
                    sdf_mask=torch.where(full_p["sdf"] < 0.0, 1e-3, 0.0),
                    xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1], mesh=mesh)
    ck = load_checkpoint(ckpt_path)
    for name in ("sdf", "k0"):
        out[f"equal/{name}"] = bool(np.array_equal(ck.params[name],
                                                   params_np[name]))
    out["equal/w0"] = bool(np.array_equal(ck.params["refnet"]["w0"],
                                          params_np["refnet"]["w0"]))
    out["global_step"] = ck.global_step
    re_p = place_spatial(mesh, convert.params_from_jax(ck.params, device))
    s = torch.sum(re_p["sdf"]) + torch.sum(re_p["k0"])
    out["restored_sum"] = float(all_reduce_sum(s, mesh.sp_group))
    return out


def checkpoint_params():
    rng = np.random.default_rng(7)
    return {"sdf": rng.normal(size=(8, 4, 4, 1)).astype(np.float32),
            "k0": rng.normal(size=(8, 4, 4, 2)).astype(np.float32),
            "refnet": {"w0": rng.normal(size=(5, 3)).astype(np.float32)}}
