"""The ported coarse sorted-engine train step against the JAX step (CPU).

Same parameters (made by the JAX package, perturbed from a numpy seed,
carried across with ``fgs_nerf_tpu_torch.convert``) and the same rays go
through ``fgs_nerf_tpu`` and ``fgs_nerf_tpu_torch``; the port runs its
plain PyTorch paths here (CPU tensors), the JAX package its CPU
references.  Size: 20^3 grid, 64 rays, sample_k 32 -> M = 2,048 samples
(a multiple of 1,024, so the bf16 case takes the fused shading branch
on both sides), refnet width 16, depth 3.

Tolerances and why:
* float32 paths (mlp_bf16=False): values and gradients agree to
  reassociation, ~1e-6 relative; held at 1e-5 (values) / 1e-4 (rel L2).
* bf16 shading (mlp_bf16=True): the forward rounds at the same places
  (logits ~1e-6); the port's backward rounds each layer's cotangent to
  bf16 where the TPU kernel does (`fused_mlp_cm.py:525-536`), the JAX CPU
  path differentiates its reference instead (`:717-723`), so gradients
  are compared by relative L2 at 2e-2.
* post-Adam parameters: Adam's first step is lr * g / (|g| + 1e-7), which
  amplifies gradient noise where |g| is near 1e-7; compared where
  |g| > 1e-6 (see test_post_adam_params).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.optim.masked_adam import ParamOpts as ParamOptsJ
from fgs_nerf_tpu.optim.masked_adam import init_state as init_state_j
from fgs_nerf_tpu.ops.sorted_cm import padded_rows_cm as padded_rows_j
from fgs_nerf_tpu.train.losses import LossWeights as LossWeightsJ
from fgs_nerf_tpu.train.losses import compute_losses as compute_losses_j
from fgs_nerf_tpu.train.trainer import make_train_step as make_train_step_j

from fgs_nerf_tpu_torch import convert
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.ops.sorted_cm import padded_rows_cm, rp_for
from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts, init_state
from fgs_nerf_tpu_torch.train.losses import LossWeights
from fgs_nerf_tpu_torch.train.trainer import make_loss_and_grads, make_train_step

XYZ_MIN = np.array([-1.0, -1.0, -1.0], np.float32)
XYZ_MAX = np.array([1.0, 1.0, 1.0], np.float32)
N_RAYS = 64
S_VAL = 0.2
LOSS_W = dict(
    weight_main=1.0, weight_rgbper=0.2, weight_entropy_last=1e-3,
    weight_orientation=1e-4, sigmoid_rgb_loss=0.1, weight_tv_density=0.01,
    weight_tv_k0=0.0, ori_tv=True,
)
STEP_KW = dict(near=0.2, bg=1.0, n_rand=N_RAYS, sdf_tv=0.1,
               smooth_grad_tv=0.05, inject_tv=False, tv_dense=True,
               weight_tv_density=0.01, weight_tv_k0=0.0,
               use_nonempty_mask=False)
LRS = {"sdf": 0.1, "k0": 0.1, "refnet": 1e-3}


def _cfg_kwargs(mlp_bf16):
    return dict(
        stage="coarse", xyz_min=XYZ_MIN, xyz_max=XYZ_MAX,
        num_voxels=20**3, num_voxels_base=20**3, stepsize=0.5, k0_dim=12,
        refnet_width=16, refnet_depth=3, posbase_pe=5, viewbase_pe=1,
        refbase_pe=5, smooth_ksize=5, smooth_sigma=0.8, s_ratio=50.0,
        s_start=0.2, fast_color_thres=1e-4, shade_k=0, sample_k=32,
        # the f32 case also covers the recomputed (checkpointed) head
        shade_remat=not mlp_bf16, engine="sorted", mlp_bf16=mlp_bf16,
    )


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=[True, False], ids=["bf16", "f32"])
def case(request):
    mlp_bf16 = request.param
    kw = _cfg_kwargs(mlp_bf16)
    cfg_j = MJ.make_model_config(**kw)
    cfg_t = MT.make_model_config(**kw)
    rng = np.random.default_rng(11)
    pj = MJ.init_params(jax.random.PRNGKey(0), cfg_j)
    pj["sdf"] = pj["sdf"] + jnp.asarray(
        rng.normal(size=pj["sdf"].shape).astype(np.float32) * 0.1)
    pj["k0"] = jnp.asarray(
        rng.normal(size=pj["k0"].shape).astype(np.float32) * 0.3)
    cam = np.array([0.0, 0.1, 2.6], np.float32)
    rays_o = np.broadcast_to(cam, (N_RAYS, 3)).copy()
    look = rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.4
    rays_d = (look - rays_o).astype(np.float32)
    viewdirs = (rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
                ).astype(np.float32)
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    batch = (rays_o, rays_d, viewdirs, target)

    # --- JAX side ---------------------------------------------------------
    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)
    lw_j = LossWeightsJ(**LOSS_W)

    def loss_j(p):
        r = MJ.forward(p, {}, cfg_j, box_j, *map(jnp.asarray, batch[:3]),
                       jnp.float32(S_VAL), near=0.2, bg=1.0)
        losses = compute_losses_j(
            r, jnp.asarray(target), jnp.asarray(viewdirs), p, cfg_j, lw_j,
            sdf_tv=0.1, smooth_grad_tv=0.05, tv_on=1.0, nonempty_mask=None)
        return losses["loss"], r

    (lj, rj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    np_params = jax.tree.map(np.asarray, pj)
    opts_j = {k: ParamOptsJ(skip_zero_grad=k in ("k0", "sdf")) for k in pj}
    step_j = make_train_step_j(cfg_j, box_j, lw_j, opts_j, **STEP_KW)
    new_pj, new_oj, metrics_j = step_j(
        jax.tree.map(jnp.asarray, np_params), init_state_j(pj), {},
        *map(jnp.asarray, batch), jnp.float32(S_VAL),
        {k: jnp.asarray(v) for k, v in LRS.items()}, jnp.float32(1.0))

    # --- port -------------------------------------------------------------
    box_t = SceneBox.create(XYZ_MIN, XYZ_MAX, device="cpu")
    lw_t = LossWeights(**LOSS_W)
    pt = convert.params_from_jax(np_params, "cpu")
    tb = [torch.from_numpy(a) for a in batch]
    fn = make_loss_and_grads(cfg_t, box_t, lw_t, near=0.2, bg=1.0,
                             sdf_tv=0.1, smooth_grad_tv=0.05,
                             use_nonempty_mask=False)
    rt, lt, gt = fn(pt, {}, *tb, torch.tensor(S_VAL), 1.0)
    opts_t = {k: ParamOpts(skip_zero_grad=k in ("k0", "sdf")) for k in pt}
    step_t = make_train_step(cfg_t, box_t, lw_t, opts_t, **STEP_KW)
    new_pt, new_ot, metrics_t = step_t(
        pt, init_state(pt), {}, *tb, torch.tensor(S_VAL), LRS, 1.0)

    return dict(
        mlp_bf16=mlp_bf16, cfg_j=cfg_j, cfg_t=cfg_t,
        jax=dict(loss=float(lj), render=rj, grads=_flat(gj),
                 new_params=_flat(new_pj), new_state=new_oj,
                 metrics=metrics_j),
        torch=dict(loss=float(lt["loss"].detach()), render=rt,
                   grads=_flat(convert.params_to_numpy(gt)),
                   new_params=_flat(convert.params_to_numpy(new_pt)),
                   new_state=new_ot, metrics=metrics_t),
    )


def test_config_matches(case):
    assert dataclasses.asdict(case["cfg_t"]) == dataclasses.asdict(case["cfg_j"])


@pytest.mark.parametrize("key", ["rgb_marched", "sigmoid_rgb", "alphainv_cum",
                                 "weights", "ndv", "depth"])
def test_forward_outputs(case, key):
    want = np.asarray(case["jax"]["render"][key])
    got = case["torch"]["render"][key].detach().numpy()
    # n.v normalizes the interpolated SDF gradient: where that gradient is
    # small, its reassociation noise grows by 1/|g| (seen up to 7e-5)
    tol = 2e-4 if key == "ndv" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("key", ["valid", "live", "overflow"])
def test_forward_masks(case, key):
    np.testing.assert_array_equal(
        case["torch"]["render"][key].numpy(),
        np.asarray(case["jax"]["render"][key]))


def test_loss(case):
    np.testing.assert_allclose(case["torch"]["loss"], case["jax"]["loss"],
                               rtol=1e-5)


@pytest.mark.parametrize(
    "leaf", ["sdf", "k0", "refnet.w0", "refnet.b0", "refnet.w1",
             "refnet.b1", "refnet.w2", "refnet.b2"])
def test_gradients(case, leaf):
    want = case["jax"]["grads"][leaf]
    got = case["torch"]["grads"][leaf]
    assert np.abs(want).max() > 0
    tol = 2e-2 if case["mlp_bf16"] else 1e-4
    assert _rel_l2(got, want) < tol


@pytest.mark.parametrize(
    "leaf", ["sdf", "k0", "refnet.w0", "refnet.b0", "refnet.w1",
             "refnet.b1", "refnet.w2", "refnet.b2", "s_val"])
def test_post_adam_params(case, leaf):
    """Post-Adam parameters after one full step on each side.  Adam's
    first update is lr * g / (|g| + 1e-7), whose slope 1e-7 / (|g| + 1e-7)^2
    amplifies the gradients' own differences where |g| is small; values
    are compared where |g| > 1e-6 (f32, gradients ~1e-6 apart, at 1e-5)
    or |g| > 1e-5 (bf16, gradients ~1e-2 apart, at 1e-4)."""
    want = case["jax"]["new_params"][leaf]
    got = case["torch"]["new_params"][leaf]
    if leaf == "s_val":
        np.testing.assert_array_equal(got, want)
        return
    g = case["jax"]["grads"][leaf]
    floor, tol = (1e-5, 1e-4) if case["mlp_bf16"] else (1e-6, 1e-5)
    clear = np.abs(g) > floor
    assert clear.sum() > 0 or leaf == "k0"
    np.testing.assert_allclose(got[clear], want[clear], rtol=0, atol=tol)
    # skip_zero_grad: voxels with an exactly zero gradient stay untouched
    zero = case["torch"]["grads"][leaf] == 0
    if leaf == "k0":
        assert zero.any()
        np.testing.assert_array_equal(zero, g == 0)
        np.testing.assert_array_equal(got[zero], want[zero])


def test_adam_state_and_metrics(case):
    step, m, v = convert.adam_state_to_numpy(case["torch"]["new_state"])
    assert int(step) == int(case["jax"]["new_state"].step) == 1
    for name in ("mse", "w_nonzero_frac", "mask_frac", "overflow_frac"):
        np.testing.assert_allclose(
            float(case["torch"]["metrics"][name]),
            float(case["jax"]["metrics"][name]), rtol=1e-5, atol=1e-7)
    m_j = _flat(case["jax"]["new_state"].exp_avg)
    for leaf, val in _flat(m).items():
        tol = 2e-2 if case["mlp_bf16"] else 1e-4
        if np.abs(m_j[leaf]).max() > 0:
            assert _rel_l2(val, m_j[leaf]) < tol, leaf


def test_convert_round_trip():
    rng = np.random.default_rng(3)
    tree = {
        "sdf": rng.normal(size=(4, 5, 6, 1)).astype(np.float32),
        "k0": rng.normal(size=(4, 5, 6, 3)).astype(np.float32),
        "refnet": {"w0": rng.normal(size=(7, 8)).astype(np.float32),
                   "b0": rng.normal(size=(8,)).astype(np.float32)},
        "s_val": np.array([0.2], np.float32),
    }
    back = _flat(convert.params_to_numpy(convert.params_from_jax(tree, "cpu")))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == np.float32
    state = convert.adam_state_from_jax(
        np.int32(7), tree, jax.tree.map(lambda a: a * a, tree), "cpu")
    step, m, v = convert.adam_state_to_numpy(state)
    assert int(step) == 7
    np.testing.assert_array_equal(m["refnet"]["w0"], tree["refnet"]["w0"])


def test_bench_geometry():
    """The bench configuration's sizes (`bench.py:105-119`)."""
    kw = dict(stage="coarse", xyz_min=XYZ_MIN, xyz_max=XYZ_MAX,
              num_voxels=1_500_000, num_voxels_base=1_500_000,
              stepsize=0.5, k0_dim=12, refnet_width=192, refnet_depth=3,
              posbase_pe=5, viewbase_pe=1, refbase_pe=5, sample_k=288,
              engine="sorted")
    cfg_t = MT.make_model_config(**kw)
    cfg_j = MJ.make_model_config(**kw)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.world_size == (114, 114, 114)
    assert (cfg_t.s_max, cfg_t.sample_k) == (400, 288)
    assert padded_rows_cm(cfg_t.world_size) == padded_rows_j(cfg_j.world_size)
    assert padded_rows_cm(cfg_t.world_size) == 1_722_368
    assert rp_for(cfg_t.world_size) == 1_723_392
    assert cfg_t.refnet_in_dim() == cfg_j.refnet_in_dim() == 90


def test_forward_with_mask_buffers():
    """The forward's mask branch: a prior-stage mask cache and an
    incremental-voxel box restrict the lattice the same way on both
    sides (exact f32 threshold).  The mask holds 2e-3, not the stage
    handoff's 1e-3: interpolating all-1e-3 corners lands exactly on the
    1e-3 threshold, where any reassociation (XLA's fused code included)
    flips the comparison."""
    kw = _cfg_kwargs(False)
    cfg_j = MJ.make_model_config(**kw)
    cfg_t = MT.make_model_config(**kw)
    rng = np.random.default_rng(5)
    pj = MJ.init_params(jax.random.PRNGKey(1), cfg_j)
    pj["k0"] = jnp.asarray(rng.normal(size=pj["k0"].shape).astype(np.float32))
    mask = (rng.uniform(size=(*cfg_j.world_size, 1)) > 0.4).astype(np.float32) * 2e-3
    lower = np.float32([0.05, 0.1, 0.0])
    upper = np.float32([0.9, 0.95, 0.8])
    cam = np.array([0.1, 0.0, 2.6], np.float32)
    rays_o = np.broadcast_to(cam, (N_RAYS, 3)).copy()
    rays_d = (rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.4 - rays_o)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    buf_j = {"mask_cache": MJ.build_mask_cache(jnp.asarray(mask), XYZ_MIN, XYZ_MAX),
             "inc_lower": jnp.asarray(lower), "inc_upper": jnp.asarray(upper)}
    rj = MJ.forward(pj, buf_j, cfg_j, SceneBoxJ.create(XYZ_MIN, XYZ_MAX),
                    jnp.asarray(rays_o), jnp.asarray(rays_d),
                    jnp.asarray(viewdirs), jnp.float32(S_VAL), near=0.2, bg=1.0)
    buf_t = {"mask_cache": MT.build_mask_cache(torch.from_numpy(mask), XYZ_MIN, XYZ_MAX),
             "inc_lower": torch.from_numpy(lower),
             "inc_upper": torch.from_numpy(upper)}
    rt = MT.forward(convert.params_from_jax(jax.tree.map(np.asarray, pj), "cpu"),
                    buf_t, cfg_t, SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu"),
                    torch.from_numpy(rays_o), torch.from_numpy(rays_d),
                    torch.from_numpy(viewdirs), torch.tensor(S_VAL), 0.2, 1.0)
    np.testing.assert_array_equal(rt["valid"].numpy(), np.asarray(rj["valid"]))
    assert 0 < rt["valid"].sum() < np.asarray(
        MJ.forward(pj, {}, cfg_j, SceneBoxJ.create(XYZ_MIN, XYZ_MAX),
                   jnp.asarray(rays_o), jnp.asarray(rays_d),
                   jnp.asarray(viewdirs), jnp.float32(S_VAL), near=0.2,
                   bg=1.0)["valid"]).sum()
    np.testing.assert_allclose(rt["rgb_marched"].detach().numpy(),
                               np.asarray(rj["rgb_marched"]), rtol=1e-5, atol=1e-5)
