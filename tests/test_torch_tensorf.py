"""The port's TensoRF k0 grid (``grid_type='tensorf'``) against the JAX
package (CPU): the bilinear and line samples, densify, the rung resize,
one sorted coarse train step with a TensoRF k0 (loss, every factor's
gradient, the post-Adam factors) and the checkpoint both ways.

The factors are drawn by the JAX package and carried across with
``fgs_nerf_tpu_torch.convert``; rays and perturbations come from numpy
seeds.  Size: 20^3 grid, 4 components, 12 k0 channels, 64 rays, sample_k
32 (M = 2,048), refnet width 16, depth 3, the float32 head.

Tolerances and why: samples, densify and resize are the same float32
products and sums, except that densify's basis product (a matmul) sums
over the 12 components in another order: 1e-6 (values of order 1).  The
train step's loss agrees to reassociation (1e-5 relative) and every
gradient leaf to relative L2 1e-4, as in ``tests/test_torch_coarse_step.
py``'s float32 case; post-Adam factors within 1e-4 where |g| > 1e-6
(Adam's first step is lr * g / (|g| + 1e-8), steep where |g| is small).
Checkpoints carry the same arrays (equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.core import grids as GJ
from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.optim.masked_adam import ParamOpts as ParamOptsJ
from fgs_nerf_tpu.optim.masked_adam import init_state as init_state_j
from fgs_nerf_tpu.train import checkpoint as ckpt_j
from fgs_nerf_tpu.train.losses import LossWeights as LossWeightsJ
from fgs_nerf_tpu.train.trainer import make_train_step as make_train_step_j

from fgs_nerf_tpu_torch import convert
from fgs_nerf_tpu_torch.core import grids as GT
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts, init_state
from fgs_nerf_tpu_torch.train import checkpoint as ckpt_t
from fgs_nerf_tpu_torch.train.losses import LossWeights
from fgs_nerf_tpu_torch.train.trainer import make_loss_and_grads, make_train_step

XYZ_MIN = np.array([-1.0, -1.0, -1.0], np.float32)
XYZ_MAX = np.array([1.0, 1.0, 1.0], np.float32)
N_RAYS = 64
# ori_tv with a k0 TV: the loss reads the densified k0 (`losses.py:130`)
LOSS_W = dict(
    weight_main=1.0, weight_rgbper=0.2, weight_entropy_last=1e-3,
    weight_orientation=1e-4, sigmoid_rgb_loss=0.1, weight_tv_density=0.01,
    weight_tv_k0=0.01, ori_tv=True,
)
STEP_KW = dict(near=0.2, bg=1.0, n_rand=N_RAYS, sdf_tv=0.1,
               smooth_grad_tv=0.05, inject_tv=False, tv_dense=True,
               weight_tv_density=0.01, weight_tv_k0=0.01,
               use_nonempty_mask=False)
LRS = {"sdf": 0.1, "k0": 0.1, "refnet": 1e-3}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(
                v, torch.Tensor) else v)
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _factors(channels, ws=(6, 7, 5), n_comp=3, seed=0):
    pj = GJ.init_tensorf_params(jax.random.PRNGKey(seed), channels, ws, n_comp)
    np_p = jax.tree.map(np.asarray, pj)
    return pj, np_p, convert.params_from_jax(np_p, "cpu")


def test_bilinear_and_line_samples_match_jax():
    rng = np.random.default_rng(0)
    plane = rng.normal(size=(6, 7, 4)).astype(np.float32)
    # inside, on the edges and outside (zero padding)
    uv = rng.uniform(-1.5, 7.5, size=(300, 2)).astype(np.float32)
    uv[:6] = [[0, 0], [5, 6], [5.0, 0.5], [-1, 3], [6, 2], [2.5, 6.0]]
    want = np.asarray(GJ.bilinear_sample(jnp.asarray(plane), jnp.asarray(uv)))
    got = GT.bilinear_sample(torch.as_tensor(plane), torch.as_tensor(uv))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    vec = rng.normal(size=(9, 4)).astype(np.float32)
    t = rng.uniform(-2, 10, size=(50,)).astype(np.float32)
    np.testing.assert_allclose(
        GT._line_sample(torch.as_tensor(vec), torch.as_tensor(t)).numpy(),
        np.asarray(GJ._line_sample(jnp.asarray(vec), jnp.asarray(t))),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("channels", [1, 4])
def test_densify_sample_and_scale_match_jax(channels):
    pj, np_p, pt = _factors(channels)
    assert set(pt) == set(np_p)
    np.testing.assert_allclose(
        GT.tensorf_densify(pt, channels).numpy(),
        np.asarray(GJ.tensorf_densify(pj, channels)), atol=1e-6, rtol=1e-6)
    rng = np.random.default_rng(channels)
    xyz = rng.uniform(-1.1, 1.1, size=(40, 3)).astype(np.float32)
    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)
    box_t = SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu")
    np.testing.assert_allclose(
        GT.tensorf_sample(pt, torch.as_tensor(xyz), box_t, channels).numpy(),
        np.asarray(GJ.tensorf_sample(pj, jnp.asarray(xyz), box_j, channels)),
        atol=1e-6, rtol=1e-6)
    sj = GJ.tensorf_scale(pj, (11, 9, 8))
    st = GT.tensorf_scale(pt, (11, 9, 8))
    for name in np_p:
        np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]),
                                   atol=1e-6, err_msg=name)
    assert st["xy_plane"].shape[:2] == (11, 9)


def test_init_draws_the_jax_layout():
    """The port draws its own factors (``torch.Generator``) in the JAX
    package's names, shapes and scales."""
    gen = torch.Generator().manual_seed(0)
    pt = GT.init_tensorf_params(gen, 12, (20, 18, 16), 4, device="cpu")
    _, np_p, _ = _factors(12, (20, 18, 16), 4)
    assert {k: tuple(v.shape) for k, v in pt.items()} == {
        k: v.shape for k, v in np_p.items()}
    assert abs(float(pt["xy_plane"].std()) - 0.1) < 0.01
    bound = np.sqrt(6.0 / 12) / np.sqrt(6.0)
    assert float(pt["f_vec"].abs().max()) <= bound


def _cfg_kwargs():
    return dict(
        stage="coarse", xyz_min=XYZ_MIN, xyz_max=XYZ_MAX,
        num_voxels=20**3, num_voxels_base=20**3, stepsize=0.5, k0_dim=12,
        refnet_width=16, refnet_depth=3, posbase_pe=5, viewbase_pe=1,
        refbase_pe=5, smooth_ksize=5, smooth_sigma=0.8, s_ratio=50.0,
        s_start=0.2, fast_color_thres=1e-4, shade_k=0, sample_k=32,
        shade_remat=False, engine="sorted", mlp_bf16=False,
        grid_type="tensorf", tensorf_n_comp=4,
    )


def test_sorted_coarse_step_with_tensorf_k0_matches_jax():
    kw = _cfg_kwargs()
    cfg_j, cfg_t = MJ.make_model_config(**kw), MT.make_model_config(**kw)
    rng = np.random.default_rng(11)
    pj = MJ.init_params(jax.random.PRNGKey(0), cfg_j)
    pj["sdf"] = pj["sdf"] + jnp.asarray(
        rng.normal(size=pj["sdf"].shape).astype(np.float32) * 0.1)
    cam = np.array([0.0, 0.1, 2.6], np.float32)
    rays_o = np.broadcast_to(cam, (N_RAYS, 3)).copy()
    look = rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.4
    rays_d = (look - rays_o).astype(np.float32)
    viewdirs = (rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
                ).astype(np.float32)
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    batch = (rays_o, rays_d, viewdirs, target)
    np_params = jax.tree.map(np.asarray, pj)

    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)
    opts_j = {k: ParamOptsJ(skip_zero_grad=k in ("k0", "sdf")) for k in pj}
    step_j = make_train_step_j(cfg_j, box_j, LossWeightsJ(**LOSS_W), opts_j,
                               **STEP_KW)

    def grads_j(p):
        from fgs_nerf_tpu.train.losses import compute_losses

        def loss(q):
            r = MJ.forward(q, {}, cfg_j, box_j, *map(jnp.asarray, batch[:3]),
                           jnp.float32(0.2), near=0.2, bg=1.0)
            return compute_losses(
                r, jnp.asarray(target), jnp.asarray(viewdirs), q, cfg_j,
                LossWeightsJ(**LOSS_W), sdf_tv=0.1, smooth_grad_tv=0.05,
                tv_on=1.0, nonempty_mask=None)["loss"]
        return jax.jit(jax.value_and_grad(loss))(p)

    lj, gj = grads_j(jax.tree.map(jnp.asarray, np_params))
    new_pj, _, _ = step_j(
        jax.tree.map(jnp.asarray, np_params), init_state_j(pj), {},
        *map(jnp.asarray, batch), jnp.float32(0.2),
        {k: jnp.asarray(v) for k, v in LRS.items()}, jnp.float32(1.0))

    box_t = SceneBox.create(XYZ_MIN, XYZ_MAX, device="cpu")
    pt = convert.params_from_jax(np_params, "cpu")
    assert set(pt["k0"]) == {"xy_plane", "xz_plane", "yz_plane", "x_vec",
                             "y_vec", "z_vec", "f_vec"}
    tb = [torch.from_numpy(a) for a in batch]
    fn = make_loss_and_grads(cfg_t, box_t, LossWeights(**LOSS_W), near=0.2,
                             bg=1.0, sdf_tv=0.1, smooth_grad_tv=0.05,
                             use_nonempty_mask=False)
    _, lt, gt = fn(pt, {}, *tb[:3], tb[3], torch.tensor(0.2), 1.0)
    np.testing.assert_allclose(float(lt["loss"].detach()), float(lj),
                               rtol=1e-5)
    gj_f, gt_f = _flat(gj), _flat(gt)
    assert set(gt_f) == set(gj_f)
    for name in gj_f:
        if name == "s_val":
            continue
        assert np.abs(gj_f[name]).max() > 0, name
        err = _rel_l2(gt_f[name], gj_f[name])
        assert err < 1e-4, (name, err)

    opts_t = {k: ParamOpts(skip_zero_grad=k in ("k0", "sdf")) for k in pt}
    step_t = make_train_step(cfg_t, box_t, LossWeights(**LOSS_W), opts_t,
                             **STEP_KW)
    new_pt, _, _ = step_t(pt, init_state(pt), {}, *tb, torch.tensor(0.2),
                          {k: torch.tensor(v) for k, v in LRS.items()},
                          torch.tensor(1.0))
    new_j, new_t = _flat(new_pj), _flat(new_pt)
    for name in gj_f:
        if not name.startswith("k0."):
            continue
        clear = np.abs(gj_f[name]) > 1e-6
        assert clear.any()
        np.testing.assert_allclose(new_t[name][clear], new_j[name][clear],
                                   atol=1e-4, err_msg=name)


def test_tensorf_checkpoint_round_trip(tmp_path):
    """The nested k0 factors cross in both directions through
    ``train/checkpoint.py`` and ``convert.py``, with the rung resize."""
    kw = _cfg_kwargs()
    cfg_j, cfg_t = MJ.make_model_config(**kw), MT.make_model_config(**kw)
    pj = jax.tree.map(np.asarray, MJ.init_params(jax.random.PRNGKey(2), cfg_j))
    path = str(tmp_path / "coarse_last.npz")
    ckpt_j.save_checkpoint(path, global_step=3, params=pj,
                           model_kwargs=dataclasses.asdict(cfg_j),
                           xyz_min=XYZ_MIN, xyz_max=XYZ_MAX)
    ck = ckpt_t.load_checkpoint(path)
    pt = convert.params_from_jax(ck.params, "cpu")
    for name, a in _flat(pj).items():
        np.testing.assert_array_equal(_flat(pt)[name], a)

    cfg2 = dataclasses.replace(cfg_t, world_size=(24, 22, 20))
    pt2 = MT.scale_volume_grid(pt, cfg2)
    assert MT.k0_dense(pt2, cfg2).shape == (24, 22, 20, 12)
    path2 = str(tmp_path / "coarse_last_port.npz")
    ckpt_t.save_checkpoint(path2, global_step=4, params=pt2,
                           opt_state=init_state(pt2),
                           model_kwargs=dataclasses.asdict(cfg2),
                           xyz_min=torch.as_tensor(XYZ_MIN),
                           xyz_max=torch.as_tensor(XYZ_MAX))
    back = ckpt_j.load_checkpoint(path2)
    want = _flat(convert.params_to_numpy(pt2))
    got = _flat(back.params)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(
        np.asarray(back.opt["exp_avg"]["k0"]["f_vec"]), 0.0)
