"""The port's DVGO density geometry search (``--dvgo_init``) against the
JAX package (CPU): the activation, the forward and its gradients, one
train step with per-voxel learning rates, the DVGO stage with its coarse
handoff through ``run_training``, and the DVGO checkpoint both ways.

Sizes are those of ``tests/test_density_model.py`` (16^3 density grid,
256 rays per step, 4 synthetic views of 24 x 24, a 20^3 coarse stage).
Inputs come from numpy seeds and go through both packages.

Tolerances and why: the activation is the same float32 formula
(``softplus`` as ``logaddexp(x, 0)`` on both sides), held to 1e-6 where
XLA's and torch's ``exp`` / ``log1p`` may differ in the last bit.  The
forward's ``alpha > fast_color_thres`` and ``weights > thres`` masks sit
near their threshold on a fresh grid (alpha_init 1e-6 gives alphas of
2e-7 to 1e-6 against 1e-7), so a last-bit difference flips a few
samples: the flips are counted and held to at most 0.5% of the live
samples, and every flipped sample carries a weight of about the
threshold, so renders agree to 1e-5 and gradients to relative L2 1e-4.
A stage's per-step losses agree to 1e-3 relative and its parameters to
relative L2 2e-2 of their change over the stage, as
``tests/test_torch_pipeline.py`` holds the geometry stage: Adam's first
steps are ``lr * g / (|g| + 1e-8)``, which moves a parameter by about
``lr`` whatever the size of its gradient.  The checkpoint's ``sdf_mask``
(alpha >= 1e-3) flips at most 0.5% of its voxels.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.config.base import Cfg as CfgJ
from fgs_nerf_tpu.config.base import deep_update as deep_update_j
from fgs_nerf_tpu.config.base import load_config as load_config_j
from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.data.synthetic import make_synthetic_dataset as synth_j
from fgs_nerf_tpu.models import density_voxel as DJ
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.optim.masked_adam import ParamOpts as ParamOptsJ
from fgs_nerf_tpu.optim.masked_adam import init_state as init_state_j
from fgs_nerf_tpu.train import checkpoint as ckpt_j
from fgs_nerf_tpu.train import density_trainer as DTJ
from fgs_nerf_tpu.train import stage_common as SCJ
from fgs_nerf_tpu.train.pipeline import run_training as run_training_j

from fgs_nerf_tpu_torch.config.base import load_config
from fgs_nerf_tpu_torch.convert import params_from_jax, params_to_numpy
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import density_voxel as DT
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts, init_state
from fgs_nerf_tpu_torch.train import checkpoint as ckpt_t
from fgs_nerf_tpu_torch.train import density_trainer as DTT
from fgs_nerf_tpu_torch.train import stage_common as SCT
from fgs_nerf_tpu_torch.train.pipeline import run_training

XYZ_MIN = np.array([-1.0, -1.0, -1.0], np.float32)
XYZ_MAX = np.array([1.0, 1.0, 1.0], np.float32)
FLIP_SHARE = 1e-2  # live-mask flips per live sample (module doc)
# gradients away from the flipped samples' voxels (module doc)
GRAD_REL_L2 = {"fresh": 1e-2, "trained": 1e-4}

# `tests/test_density_model.py:65-77` (the built-in dvgo_model's
# fast_color_thres 1e-7 stays; alpha_init 0.01 lets a few steps reach
# the sdf_mask's alpha 1e-3)
TINY = dict(
    dvgo=dict(N_iters=20, N_rand=256, pg_scale=[6], pervoxel_lr=True,
              pervoxel_lr_downrate=2),
    dvgo_model=dict(num_voxels=16**3, num_voxels_base=16**3,
                    alpha_init=0.01, sample_k=0),
    coarse_train=dict(N_iters=8, N_rand=256, pg_scale=[], save_iter=10**9,
                      decay_step_module={}, tv_updates={}),
    coarse_model=dict(num_voxels=20**3, num_voxels_base=20**3, shade_k=32),
)


def _cfgs(**kw):
    base = dict(xyz_min=XYZ_MIN, xyz_max=XYZ_MAX, num_voxels=16**3,
                num_voxels_base=16**3, stepsize=0.5, alpha_init=1e-6,
                fast_color_thres=1e-7, **kw)
    return DJ.make_density_config(**base), DT.make_density_config(**base)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    rays_o = np.full((n, 3), [0, 0, 3.0], np.float32)
    rays_o += rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    look = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    rays_d = look - rays_o
    vd = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    return rays_o, rays_d, vd, target


def _params(cfg, seed, regime):
    """A color grid of random values and a density grid: "fresh" is the
    ball init plus noise (alphas of 1e-7 to 1e-5, around the 1e-7
    thresholds), "trained" has opaque and empty regions (alphas up to 1)."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in DJ.init_params(cfg).items()}
    noise = rng.normal(size=p["density"].shape).astype(np.float32)
    if regime == "fresh":
        p["density"] = p["density"] + 2.0 * noise
    else:
        p["density"] = 8.0 * noise + 4.0
    p["k0"] = rng.normal(size=p["k0"].shape).astype(np.float32)
    return p


def _flipped_voxels(cfg_t, box_t, ro, rd, flips):
    """The grid nodes whose trilinear weights a flipped sample touches
    (its 8 corners), from the forward's own sample points."""
    from fgs_nerf_tpu_torch.ops.ray_sample import sample_along_rays

    ro, rd = torch.as_tensor(ro), torch.as_tensor(rd)
    rs = sample_along_rays(ro, rd, box_t, 0.2, cfg_t.step_dist, cfg_t.s_max)
    pts = rs.pts
    if 0 < cfg_t.sample_k < cfg_t.s_max:
        _, steps, _ = MT._compact_valid(rs.valid, cfg_t.sample_k)
        pts = MT._pts_at_steps(ro, rd, rs.t_min, steps, cfg_t.step_dist)
    sizes = np.asarray(cfg_t.world_size)
    idx = (box_t.normalize(pts) * torch.as_tensor(sizes - 1.0,
                                                  dtype=torch.float32)).numpy()
    mark = np.zeros(cfg_t.world_size, bool)
    for r, s_ in np.argwhere(flips):
        i0 = np.floor(idx[r, s_]).astype(int)
        for off in np.ndindex(2, 2, 2):
            c = i0 + off
            if np.all(c >= 0) and np.all(c < sizes):
                mark[tuple(c)] = True
    return mark


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_activate_density_matches_jax():
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.normal(size=2000).astype(np.float32) * 8,
                        np.float32([-100.0, -30.0, 0.0, 19.0, 21.0, 40.0])])
    act_shift = float(np.log(1 / (1 - 1e-6) - 1))
    for interval in (0.5, 0.125):
        want = np.asarray(DJ.activate_density(jnp.asarray(d), interval,
                                              act_shift))
        got = DT.activate_density(torch.as_tensor(d), interval,
                                  act_shift).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the softplus is jax's logaddexp(x, 0), also past torch's threshold 20
    x = np.float32([20.5, 25.0, 60.0, -120.0])
    np.testing.assert_array_equal(
        DT.softplus(torch.as_tensor(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_pervoxel_clamp_underflows_with_zero_gradient():
    """The per-voxel learning rate's clamp to -100 makes alpha exactly 0
    in float32 on both sides, and its gradient exactly 0."""
    act_shift = float(np.log(1 / (1 - 1e-6) - 1))
    d = np.float32([-100.0, -100.0])
    gj = np.asarray(jax.grad(lambda x: jnp.sum(DJ.activate_density(
        x, 0.5, act_shift)))(jnp.asarray(d)))
    xt = torch.as_tensor(d).requires_grad_(True)
    at = DT.activate_density(xt, 0.5, act_shift)
    (gt,) = torch.autograd.grad(at.sum(), xt)
    assert np.all(at.detach().numpy() == 0.0)
    assert np.all(gj == 0.0) and np.all(gt.numpy() == 0.0)


@pytest.mark.parametrize("regime", ["fresh", "trained"])
@pytest.mark.parametrize("sample_k,mask_cache", [(0, False), (48, True)])
def test_forward_and_grads_match_jax(regime, sample_k, mask_cache):
    cfg_j, cfg_t = _cfgs(sample_k=sample_k)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)
    box_t = SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu")
    p_np = _params(cfg_j, 1, regime)
    ro, rd, vd, target = _rays(64, 2)
    buf_j, buf_t = {}, {}
    if mask_cache:
        alpha = np.asarray(DJ.build_alpha_grid(p_np, cfg_j))
        m = np.where(alpha >= 1e-6, 4e-3, 0.0).astype(np.float32)
        buf_j["mask_cache"] = MJ.build_mask_cache(jnp.asarray(m), XYZ_MIN,
                                                   XYZ_MAX)
        buf_t["mask_cache"] = MT.build_mask_cache(torch.as_tensor(m), XYZ_MIN,
                                                  XYZ_MAX)

    def loss_j(p):
        out = DJ.forward(p, buf_j, cfg_j, box_j, jnp.asarray(ro),
                         jnp.asarray(rd), jnp.asarray(vd), near=0.2, bg=1.0)
        return jnp.mean((out["rgb_marched"] - target) ** 2
                        ) + jnp.mean(out["normal_marched"] ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree.map(jnp.asarray, p_np))
    p_t = params_from_jax(p_np, "cpu")
    p_t = {k: v.requires_grad_(True) for k, v in p_t.items()}
    out_t = DT.forward(p_t, buf_t, cfg_t, box_t, *(torch.as_tensor(a)
                       for a in (ro, rd, vd)), near=0.2, bg=1.0)
    loss_t = (torch.mean((out_t["rgb_marched"] - torch.as_tensor(target)) ** 2)
              + torch.mean(out_t["normal_marched"] ** 2))
    g_t = torch.autograd.grad(loss_t, [p_t["density"], p_t["k0"]])

    np.testing.assert_array_equal(out_t["valid"].numpy(),
                                  np.asarray(out_j["valid"]))
    live_j, live_t = np.asarray(out_j["live"]), out_t["live"].numpy()
    flips = live_j != live_t
    assert live_j.sum() > 100
    assert flips.sum() <= FLIP_SHARE * live_j.sum(), int(flips.sum())
    for key in ("rgb_marched", "alphainv_cum", "normal_marched"):
        np.testing.assert_allclose(out_t[key].detach().numpy(),
                                   np.asarray(out_j[key]), atol=1e-5,
                                   err_msg=key)
    # a flipped sample's own alpha gets an O(1) cotangent on one side
    # only: its 8 corners are set aside, and are few
    mark = _flipped_voxels(cfg_t, box_t, ro, rd, flips)
    assert mark.sum() <= 8 * flips.sum()
    for name, gt in zip(("density", "k0"), g_t):
        got, want = gt.numpy(), np.asarray(g_j[name])
        assert np.abs(want).max() > 0
        err = _rel_l2(got[~mark], want[~mark])
        assert err < GRAD_REL_L2[regime], (name, err)


def _per_voxel(cfg_j, cfg_t, data, near, far):
    """The per-voxel learning rate of both stages from the same views."""
    from fgs_nerf_tpu.data import rays as RJ
    from fgs_nerf_tpu_torch.data import rays as RT

    conv = dict(ndc=False, inverse_y=False, flip_x=False, flip_y=False)
    i_tr = data["i_train"]
    args = (np.asarray(data["images"])[i_tr], np.asarray(data["poses"])[i_tr],
            np.asarray(data["HW"])[i_tr], np.asarray(data["Ks"])[i_tr])
    _, o_j, d_j, _ = RJ.get_training_rays(*args, **conv)
    _, o_t, d_t, _ = RT.get_training_rays(*args, **conv)
    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)
    box_t = SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu")
    cnt_j = MJ.voxel_count_views(cfg_j, box_j, o_j, d_j, near, far,
                                 cfg_j.stepsize, downrate=2)
    cnt_t = MT.voxel_count_views(cfg_t, box_t, o_t, d_t, near, far,
                                 cfg_t.stepsize, downrate=2)
    # 128 of the training pixels' rays, as the stage draws them
    rgb, _, _, v = RT.get_training_rays(*args, **conv)
    pick = tuple(np.random.default_rng(5).integers(0, n, 128)
                 for n in rgb.shape[:3])
    rays = tuple(np.ascontiguousarray(a[pick], np.float32)
                 for a in (o_t, d_t, v, rgb))
    return cnt_j, cnt_t, rays


def test_train_step_with_pervoxel_lr_matches_jax():
    cfg_j, cfg_t = _cfgs()
    data = synth_j(n_views=12, h=24, w=24, n_test=1)
    near, far = float(data["near"]), float(data["far"])
    cnt_j, cnt_t, (ro, rd, vd, target) = _per_voxel(cfg_j, cfg_t, data,
                                                    near, far)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert 0 < int((np.asarray(cnt_j) <= 2).sum()) < cnt_j.size

    p_np = _params(cfg_j, 4, "trained")
    names = ("density", "k0")
    opts_j = {n: ParamOptsJ(skip_zero_grad=True) for n in names}
    opts_t = {n: ParamOpts(skip_zero_grad=True) for n in names}
    p_j, opts_j, buf_j = SCJ.apply_pervoxel_lr(
        jax.tree.map(jnp.asarray, p_np), opts_j, {}, cnt_j, "density", -100.0)
    p_t, opts_t, buf_t = SCT.apply_pervoxel_lr(
        params_from_jax(p_np, "cpu"), opts_t, {}, cnt_t, "density", -100.0)
    # the count grid's shape test: density takes the rate, k0 does not
    assert {n: o.has_per_lr for n, o in opts_t.items()} == {
        n: o.has_per_lr for n, o in opts_j.items()} == {
        "density": True, "k0": False}
    kw = dict(near=near, bg=1.0, n_rand=128, weight_main=1.0,
              weight_entropy_last=0.01, weight_rgbper=0.1)
    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)
    box_t = SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu")
    step_j = DTJ.make_density_train_step(cfg_j, box_j, opts_j, **kw)
    step_t = DTT.make_density_train_step(cfg_t, box_t, opts_t, **kw)
    lrs = {"density": 0.1, "k0": 0.1}
    p0_j = jax.tree.map(np.array, p_j)  # a copy: the step donates its inputs
    new_j, _, m_j = step_j(p_j, init_state_j(p_j), buf_j,
                           *(jnp.asarray(a) for a in (ro, rd, vd, target)),
                           {k: jnp.asarray(v, jnp.float32)
                            for k, v in lrs.items()})
    new_t, _, m_t = step_t(p_t, init_state(p_t), buf_t,
                           *(torch.as_tensor(a) for a in (ro, rd, vd, target)),
                           {k: torch.tensor(v) for k, v in lrs.items()})
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    for name in names:
        want = np.asarray(new_j[name])
        got = new_t[name].numpy()
        moved = want != p0_j[name]
        assert moved.any()
        # clamped voxels stay at -100: no gradient, skip_zero_grad
        np.testing.assert_array_equal(got[~moved], want[~moved])
        change = np.linalg.norm(want - p0_j[name])
        assert np.linalg.norm(got - want) / change < 1e-3, name


def _stage_cfgs(tiny):
    cfg_j = CfgJ(deep_update_j(dict(load_config_j("shiny_blender")), tiny))
    cfg_t = load_config("shiny_blender")
    cfg_t.update(deep_update_j(dict(cfg_t), tiny))
    return cfg_j, cfg_t


def test_dvgo_stage_and_coarse_handoff_match_jax(tmp_path, monkeypatch,
                                                  caplog):
    """``run_training(dvgo_init=True)``: the DVGO stage (a pg_scale rung
    at step 3, per-voxel learning rates) and 4 coarse steps off its
    checkpoint, the port against the JAX pipeline (tolerances: module
    doc).  The coarse stage starts from the JAX initial weights."""
    from fgs_nerf_tpu.train import trainer as TJ
    from fgs_nerf_tpu_torch.train import trainer as TT

    tiny = deep_update_j(TINY, dict(dvgo=dict(pg_scale=[3])))
    cfg_j, cfg_t = _stage_cfgs(tiny)
    data = synth_j(n_views=4, h=24, w=24, n_test=1)
    k_init = jax.random.split(jax.random.PRNGKey(777), 2)[1]

    def init_params(gen, cfg, device=None):
        cj = MJ.SDFModelConfig(**dataclasses.asdict(cfg))
        return params_from_jax(
            jax.tree.map(np.asarray, MJ.init_params(k_init, cj)), device)

    losses = {"jax": [], "port": []}
    starts = {"jax": [], "port": []}  # the parameters each step began from

    def recorder(make, side, stage):
        def make_step(*a, **kw):
            step = make(*a, **kw)

            def run(*args):
                if stage == "dvgo":
                    starts[side].append({
                        k: np.array(v.detach().cpu() if side == "port" else v)
                        for k, v in args[0].items()})
                out = step(*args)
                losses[side].append((stage, float(out[2]["loss"])))
                return out
            return run
        return make_step

    monkeypatch.setattr(MT, "init_params", init_params)
    for mod, name, side, stage in (
            (DTJ, "make_density_train_step", "jax", "dvgo"),
            (DTT, "make_density_train_step", "port", "dvgo"),
            (TJ, "make_train_step", "jax", "coarse"),
            (TT, "make_train_step", "port", "coarse")):
        monkeypatch.setattr(mod, name, recorder(getattr(mod, name), side,
                                                stage))
    iters = {"geometry_searching": 6, "coarse": 4}
    stages = ("geometry_searching", "coarse")
    kept = []  # the coarse stage's logged in_maskcache kept share, per side
    caplog.set_level(logging.INFO, logger="fgs")
    res_j = run_training_j(cfg_j, data, str(tmp_path / "jax"), stages=stages,
                           dvgo_init=True, n_iters_override=iters, i_print=1)
    res_t = run_training(cfg_t, data, str(tmp_path / "port"), stages=stages,
                         dvgo_init=True, n_iters_override=iters, i_print=1,
                         device="cpu")
    for rec in caplog.records:
        if "kept ratio" in rec.getMessage():
            kept.append(float(rec.getMessage().split()[-1]))
    geo_j, geo_t = res_j["geometry_searching"], res_t["geometry_searching"]
    assert dataclasses.asdict(geo_t.cfg_model) == dataclasses.asdict(
        geo_j.cfg_model)
    assert [s for s, _ in losses["port"]] == [s for s, _ in losses["jax"]] \
        == ["dvgo"] * 6 + ["coarse"] * 4
    np.testing.assert_allclose([v for s, v in losses["port"] if s == "dvgo"],
                               [v for s, v in losses["jax"] if s == "dvgo"],
                               rtol=1e-3)
    got = params_to_numpy(geo_t.params)
    start = starts["jax"][2]  # the first step of the last rung
    for name in ("density", "k0"):
        np.testing.assert_allclose(starts["port"][2][name], start[name],
                                   atol=1e-5)
        want = np.asarray(geo_j.params[name])
        change = max(np.linalg.norm(want - start[name]), 1e-6)
        err = np.linalg.norm(got[name] - want) / change
        assert err < 2e-2, (name, err)

    ck_j = ckpt_j.load_checkpoint(str(tmp_path / "jax" /
                                      "geometry_searching_last.npz"))
    ck_t = ckpt_t.load_checkpoint(str(tmp_path / "port" /
                                      "geometry_searching_last.npz"))
    m_j, m_t = np.asarray(ck_j.sdf_mask), ck_t.sdf_mask
    assert (m_j > 0).any() and m_t.shape == m_j.shape
    assert int((m_j != m_t).sum()) <= FLIP_SHARE * m_j.size
    assert ck_t.meta["model_kwargs"] == ck_j.meta["model_kwargs"]
    assert set(ck_t.params) == {"density", "k0"}

    # the coarse stage ran off the DVGO checkpoint: the bbox shrunk to its
    # sdf_mask, the grid, and the mask cache's ray filter.  Its 1e-3
    # cells interpolate to exactly the 1e-3 threshold inside the mask,
    # where a last-bit difference keeps or drops a pixel (ROADMAP §C,
    # "Known, not faults"), so the kept shares agree to 0.5% and the
    # steps draw other rays: the coarse losses are not compared.
    co_j, co_t = res_j["coarse"], res_t["coarse"]
    np.testing.assert_allclose(co_t.box.xyz_min.numpy(),
                               np.asarray(co_j.box.xyz_min), atol=1e-6)
    np.testing.assert_allclose(co_t.box.xyz_max.numpy(),
                               np.asarray(co_j.box.xyz_max), atol=1e-6)
    assert co_t.cfg_model.world_size == co_j.cfg_model.world_size
    assert len(kept) == 2 and kept[1] == round(co_t.kept_ratio, 3)
    assert abs(kept[1] - kept[0]) <= 5e-3, kept
    assert np.isfinite(co_t.psnr_history).all()
    assert len(co_t.psnr_history) == 4


def _cfg_from_kwargs(cls, kw):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in kw.items()})


def test_dvgo_checkpoint_loads_both_ways(tmp_path):
    """A DVGO checkpoint (density, k0, Adam moments, the alpha-based
    sdf_mask, the DensityModelConfig) written by either package reads
    back in the other with the same arrays and config."""
    from fgs_nerf_tpu.optim.masked_adam import AdamState as AdamStateJ
    from fgs_nerf_tpu_torch.convert import adam_state_from_jax

    cfg_j, cfg_t = _cfgs()
    p_np = _params(cfg_j, 6, "trained")
    r = np.random.default_rng(7)
    m = {k: r.normal(size=v.shape).astype(np.float32) for k, v in p_np.items()}
    v = {k: np.abs(a) for k, a in m.items()}
    box = dict(xyz_min=XYZ_MIN, xyz_max=XYZ_MAX)

    path_j = str(tmp_path / "jax" / "geometry_searching_last.npz")
    mask_j = DJ.build_sdf_mask(jax.tree.map(jnp.asarray, p_np), cfg_j)
    ckpt_j.save_checkpoint(
        path_j, global_step=9, params=p_np,
        opt_state=AdamStateJ(np.asarray(9, np.int32), m, v), sdf_mask=mask_j,
        model_kwargs=dataclasses.asdict(cfg_j), lrs={"density": 0.1}, **box)
    ck = ckpt_t.load_checkpoint(path_j)
    assert _cfg_from_kwargs(DT.DensityModelConfig,
                            ck.meta["model_kwargs"]) == cfg_t
    for k in p_np:
        np.testing.assert_array_equal(ck.params[k], p_np[k])
        np.testing.assert_array_equal(ck.opt["exp_avg_sq"][k], v[k])
    np.testing.assert_array_equal(ck.sdf_mask, np.asarray(mask_j))
    np.testing.assert_array_equal(ck.box[0], XYZ_MIN)

    path_t = str(tmp_path / "port" / "geometry_searching_last.npz")
    p_t = params_from_jax(p_np, "cpu")
    mask_t = DT.build_sdf_mask(p_t, cfg_t)
    assert int((mask_t.numpy() != np.asarray(mask_j)).sum()) \
        <= FLIP_SHARE * mask_t.numel()
    ckpt_t.save_checkpoint(
        path_t, global_step=9, params=p_t,
        opt_state=adam_state_from_jax(9, m, v, "cpu"), sdf_mask=mask_t,
        model_kwargs=dataclasses.asdict(cfg_t), lrs={"density": 0.1},
        xyz_min=torch.as_tensor(XYZ_MIN), xyz_max=torch.as_tensor(XYZ_MAX))
    ck = ckpt_j.load_checkpoint(path_t)
    assert ck.global_step == 9 and ck.meta["lrs"] == {"density": 0.1}
    assert _cfg_from_kwargs(DJ.DensityModelConfig,
                            ck.meta["model_kwargs"]) == cfg_j
    for k in p_np:
        np.testing.assert_array_equal(np.asarray(ck.params[k]), p_np[k])
        np.testing.assert_array_equal(np.asarray(ck.opt["exp_avg"][k]), m[k])
    np.testing.assert_array_equal(np.asarray(ck.sdf_mask), mask_t.numpy())
    lo, hi = ck.box
    np.testing.assert_array_equal(np.asarray(hi), XYZ_MAX)
