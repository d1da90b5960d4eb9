"""The ported lattice-engine train steps against the JAX steps (CPU).

Same parameters (made by the JAX package, given a noisy sphere SDF and
k0 from a numpy seed, carried across with ``fgs_nerf_tpu_torch.convert``)
and the same rays go through ``fgs_nerf_tpu`` and
``fgs_nerf_tpu_torch`` with ``engine="lattice"``; the port runs its plain
paths (CPU tensors: kernel B7's wrapper takes its ``index_add_`` twin),
the JAX package its CPU paths.

Sizes: coarse 20^3 grid, 64 rays, sample_k 32, shade_k 24, refnet width
16 depth 3, the bench's loss weights (``bench.py:124-128``); fine 16^3
grid, 32 rays, sample_k 40, shade_k 24, displacements (0.5, 1, 1.5, 2),
rgbnet / refnet width 16 depth 3, TV injected into the sdf gradient
(``inject_tv=True``), the fine bench's loss weights
(``bench.py:368-373``).  Each stage runs with float32 shading behind the
recomputed (checkpointed) head, and with bf16 shading.

Tolerances and why:
* float32: render outputs and the loss agree to reassociation (~2e-7),
  held at 1e-5; normals divide by the interpolated gradient's norm,
  whose noise grows where it is small (seen 6.5e-6), held at 2e-4;
  gradients agree to ~1e-6 relative L2, held at 1e-4.
* bf16 shading: the forward rounds at the same points (rgb_marched within
  ~4e-6, held at 1e-5; one bf16 ulp of a hidden value moves a
  per-sample logit by up to ~6e-5, sel_rgb held at 2e-4); gradients at
  relative L2 2e-2, except the hidden layers' bias gradients, held at
  1e-1: the JAX CPU transpose of the bf16 bias add sums the bf16
  cotangent over the samples with bf16 partial sums (1% off the
  round-once sum on a 768-value sum alone; 4-6.5% relative L2 on these
  steps), while the port sums in float32 and rounds once.
* post-Adam parameters: Adam's first step lr * g / (|g| + eps) amplifies
  gradient differences where |g| is small; compared where |g| > 1e-6 at
  1e-5 (float32) or |g| > 1e-5 at 1e-4 (bf16; the hidden biases' 5%
  gradient difference moves lr * g / |g| by ~1e-6 only).
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
from fgs_nerf_tpu.train.losses import LossWeights as LossWeightsJ
from fgs_nerf_tpu.train.losses import compute_losses as compute_losses_j
from fgs_nerf_tpu.train.trainer import make_train_step as make_train_step_j

from fgs_nerf_tpu_torch import convert
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts, init_state
from fgs_nerf_tpu_torch.train.losses import LossWeights
from fgs_nerf_tpu_torch.train.trainer import make_loss_and_grads, make_train_step

XYZ_MIN = np.array([-1.0, -1.0, -1.0], np.float32)
XYZ_MAX = np.array([1.0, 1.0, 1.0], np.float32)
S_VAL = 0.2
DISPLACE = (0.5, 1.0, 1.5, 2.0)

STAGES = {
    "coarse": dict(
        n_rays=64,
        cfg=dict(stage="coarse", num_voxels=20**3, num_voxels_base=20**3,
                 stepsize=0.5, k0_dim=12, refnet_width=16, refnet_depth=3,
                 posbase_pe=5, viewbase_pe=1, refbase_pe=5, smooth_ksize=5,
                 smooth_sigma=0.8, s_ratio=50.0, s_start=0.2,
                 fast_color_thres=1e-4, shade_k=24, sample_k=32),
        loss_w=dict(weight_main=1.0, weight_rgbper=0.2,
                    weight_entropy_last=1e-3, weight_orientation=1e-4,
                    sigmoid_rgb_loss=0.1, weight_tv_density=0.01,
                    weight_tv_k0=0.0, ori_tv=True),
        inject_tv=False,
        lrs={"sdf": 0.1, "k0": 0.1, "refnet": 1e-3},
    ),
    "fine": dict(
        n_rays=32,
        cfg=dict(stage="fine", num_voxels=16**3, num_voxels_base=16**3,
                 stepsize=0.5, k0_dim=4, refnet_width=16, refnet_depth=3,
                 rgbnet_width=16, rgbnet_depth=3, posbase_pe=2,
                 viewbase_pe=1, refbase_pe=2, s_ratio=50.0, s_start=0.2,
                 shade_k=24, sample_k=40, grad_feat=DISPLACE,
                 sdf_feat=DISPLACE, fast_color_thres=1e-4),
        loss_w=dict(weight_main=1.0, weight_rgbper=0.0,
                    weight_entropy_last=1e-3, weight_orientation=1e-4,
                    sigmoid_rgb_loss=0.02, weight_tv_density=0.01,
                    weight_tv_k0=0.0, ori_tv=False),
        inject_tv=True,
        lrs={"sdf": 5e-3, "k0": 0.1, "refnet": 1e-3, "rgbnet": 1e-3},
    ),
}
HIDDEN_BIASES = ("refnet.b0", "refnet.b1", "rgbnet.b0", "rgbnet.b1")


def _cfg_kwargs(stage, mlp_bf16):
    return dict(xyz_min=XYZ_MIN, xyz_max=XYZ_MAX, **STAGES[stage]["cfg"],
                shade_remat=not mlp_bf16, engine="lattice", mlp_bf16=mlp_bf16)


def _step_kw(stage):
    return dict(near=0.2, bg=1.0, n_rand=STAGES[stage]["n_rays"], sdf_tv=0.1,
                smooth_grad_tv=0.05, inject_tv=STAGES[stage]["inject_tv"],
                tv_dense=True, weight_tv_density=0.01, weight_tv_k0=0.0,
                use_nonempty_mask=False)


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


def _params_and_rays(cfg_j, n_rays, seed=11):
    rng = np.random.default_rng(seed)
    pj = MJ.init_params(jax.random.PRNGKey(0), cfg_j)
    axes = [np.linspace(-1.0, 1.0, n) for n in cfg_j.world_size]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(gx**2 + gy**2 + gz**2)[..., None]
    pj["sdf"] = jnp.asarray(
        (r - 0.55 + rng.normal(size=r.shape) * 0.02).astype(np.float32))
    pj["k0"] = jnp.asarray(
        rng.normal(size=pj["k0"].shape).astype(np.float32) * 0.3)
    rays_o = (np.array([0.0, 0.1, 2.6], np.float32)
              + rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.1)
    rays_d = (rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.4
              - rays_o).astype(np.float32)
    viewdirs = (rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
                ).astype(np.float32)
    target = rng.uniform(size=(n_rays, 3)).astype(np.float32)
    return pj, (rays_o, rays_d, viewdirs, target)


@pytest.fixture(scope="module",
                params=[("coarse", False), ("coarse", True), ("fine", False),
                        ("fine", True)],
                ids=["coarse_f32", "coarse_bf16", "fine_f32", "fine_bf16"])
def case(request):
    stage, mlp_bf16 = request.param
    kw = _cfg_kwargs(stage, mlp_bf16)
    cfg_j = MJ.make_model_config(**kw)
    cfg_t = MT.make_model_config(**kw)
    pj, batch = _params_and_rays(cfg_j, STAGES[stage]["n_rays"])
    rays_o, rays_d, viewdirs, target = batch
    loss_w = STAGES[stage]["loss_w"]
    lrs = STAGES[stage]["lrs"]
    step_kw = _step_kw(stage)

    # --- JAX side ---------------------------------------------------------
    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)
    lw_j = LossWeightsJ(**loss_w)

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
    step_j = make_train_step_j(cfg_j, box_j, lw_j, opts_j, **step_kw)
    new_pj, _, metrics_j = step_j(
        jax.tree.map(jnp.asarray, np_params), init_state_j(pj), {},
        *map(jnp.asarray, batch), jnp.float32(S_VAL),
        {k: jnp.asarray(v) for k, v in lrs.items()}, jnp.float32(1.0))

    # --- port -------------------------------------------------------------
    box_t = SceneBox.create(XYZ_MIN, XYZ_MAX, device="cpu")
    lw_t = LossWeights(**loss_w)
    pt = convert.params_from_jax(np_params, "cpu")
    tb = [torch.from_numpy(a) for a in batch]
    fn = make_loss_and_grads(cfg_t, box_t, lw_t, near=0.2, bg=1.0,
                             sdf_tv=0.1, smooth_grad_tv=0.05,
                             use_nonempty_mask=False)
    rt, lt, gt = fn(pt, {}, *tb, torch.tensor(S_VAL), 1.0)
    opts_t = {k: ParamOpts(skip_zero_grad=k in ("k0", "sdf")) for k in pt}
    step_t = make_train_step(cfg_t, box_t, lw_t, opts_t, **step_kw)
    new_pt, _, metrics_t = step_t(pt, init_state(pt), {}, *tb,
                                  torch.tensor(S_VAL), lrs, 1.0)
    return dict(
        mlp_bf16=mlp_bf16, cfg_j=cfg_j, cfg_t=cfg_t,
        jax=dict(loss=float(lj), render=rj, grads=_flat(gj),
                 new_params=_flat(new_pj), metrics=metrics_j),
        torch=dict(loss=float(lt["loss"].detach()), render=rt,
                   grads=_flat(convert.params_to_numpy(gt)),
                   new_params=_flat(convert.params_to_numpy(new_pt)),
                   metrics=metrics_t),
    )


def test_config_matches(case):
    assert dataclasses.asdict(case["cfg_t"]) == dataclasses.asdict(case["cfg_j"])
    assert case["cfg_t"].engine == "lattice"


@pytest.mark.parametrize("key", ["rgb_marched", "sigmoid_rgb", "alphainv_cum",
                                 "cum_weights", "weights", "sel_weights",
                                 "depth", "normal", "normal_marched",
                                 "sel_rgb"])
def test_forward_outputs(case, key):
    want = np.asarray(case["jax"]["render"][key])
    got = case["torch"]["render"][key].detach().numpy()
    assert got.shape == want.shape
    if key in ("normal", "normal_marched"):
        tol = 2e-4
    elif key == "sel_rgb" and case["mlp_bf16"]:
        tol = 2e-4
    else:
        tol = 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("key", ["valid", "live", "sel_live", "overflow"])
def test_forward_masks(case, key):
    got = case["torch"]["render"][key].numpy()
    np.testing.assert_array_equal(got, np.asarray(case["jax"]["render"][key]))
    if key in ("live", "sel_live"):
        assert got.any()


def test_loss(case):
    np.testing.assert_allclose(case["torch"]["loss"], case["jax"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(case["torch"]["metrics"]["loss"]),
                               float(case["jax"]["metrics"]["loss"]),
                               rtol=1e-5)
    for name in ("mse", "w_nonzero_frac", "mask_frac", "overflow_frac"):
        np.testing.assert_allclose(float(case["torch"]["metrics"][name]),
                                   float(case["jax"]["metrics"][name]),
                                   rtol=1e-5, atol=1e-7)


def test_gradients(case):
    grads_j, grads_t = case["jax"]["grads"], case["torch"]["grads"]
    assert set(grads_t) == set(grads_j)
    for leaf, want in grads_j.items():
        got = grads_t[leaf]
        assert got.shape == want.shape, leaf
        if leaf == "s_val":
            continue
        assert np.abs(want).max() > 0, leaf
        if not case["mlp_bf16"]:
            tol = 1e-4
        elif leaf in HIDDEN_BIASES:
            tol = 1e-1
        else:
            tol = 2e-2
        assert _rel_l2(got, want) < tol, (leaf, _rel_l2(got, want))


def test_post_adam_params(case):
    for leaf, want in case["jax"]["new_params"].items():
        got = case["torch"]["new_params"][leaf]
        if leaf == "s_val":
            np.testing.assert_array_equal(got, want)
            continue
        g = case["jax"]["grads"][leaf]
        floor, tol = (1e-5, 1e-4) if case["mlp_bf16"] else (1e-6, 1e-5)
        clear = np.abs(g) > floor
        assert clear.sum() > 0 or leaf == "k0", leaf
        np.testing.assert_allclose(got[clear], want[clear], rtol=0, atol=tol,
                                   err_msg=leaf)
        if leaf == "k0":
            # skip_zero_grad: voxels with an exactly zero gradient stay
            zero = case["torch"]["grads"][leaf] == 0
            assert zero.any()
            np.testing.assert_array_equal(got[zero], want[zero])


def test_dispatch_takes_the_lattice_engine():
    """``forward`` runs the lattice engine for ``engine="lattice"`` and for
    a sorted fine stage whose displacements lack 1.0 (`sdf_voxel.py:621-631`)."""
    calls = []
    saved = (MT.forward_coarse, MT.forward_fine)
    MT.forward_coarse = lambda *a: calls.append("coarse")
    MT.forward_fine = lambda *a: calls.append("fine")
    try:
        for stage, extra in (("coarse", {}), ("fine", {}),
                             ("fine", dict(grad_feat=(0.5,), sdf_feat=(0.5,),
                                           k_grad_feat=(0.5,),
                                           engine="sorted"))):
            kw = _cfg_kwargs(stage, False)
            kw.update(extra)
            cfg = MT.make_model_config(**kw)
            MT.forward({}, {}, cfg, None, None, None, None, None, 0.2, 1.0)
    finally:
        MT.forward_coarse, MT.forward_fine = saved
    assert calls == ["coarse", "fine", "fine"]


def test_forward_with_mask_buffers():
    """The lattice coarse forward's mask branch: a prior-stage mask cache
    and an incremental-voxel box restrict the lattice the same way on
    both sides.  The mask holds 2e-3, not the handoff's 1e-3, for the
    reason of ``tests/test_torch_coarse_step.py``."""
    kw = _cfg_kwargs("coarse", False)
    cfg_j = MJ.make_model_config(**kw)
    cfg_t = MT.make_model_config(**kw)
    pj, (rays_o, rays_d, viewdirs, _) = _params_and_rays(cfg_j, 64, seed=5)
    rng = np.random.default_rng(5)
    mask = (rng.uniform(size=(*cfg_j.world_size, 1)) > 0.4).astype(np.float32) * 2e-3
    lower = np.float32([0.05, 0.1, 0.0])
    upper = np.float32([0.9, 0.95, 0.8])
    buf_j = {"mask_cache": MJ.build_mask_cache(jnp.asarray(mask), XYZ_MIN, XYZ_MAX),
             "inc_lower": jnp.asarray(lower), "inc_upper": jnp.asarray(upper)}
    fwd_j = jax.jit(lambda p, b: MJ.forward(
        p, b, cfg_j, SceneBoxJ.create(XYZ_MIN, XYZ_MAX), jnp.asarray(rays_o),
        jnp.asarray(rays_d), jnp.asarray(viewdirs), jnp.float32(S_VAL),
        near=0.2, bg=1.0))
    rj = fwd_j(pj, buf_j)
    buf_t = {"mask_cache": MT.build_mask_cache(torch.from_numpy(mask), XYZ_MIN,
                                               XYZ_MAX),
             "inc_lower": torch.from_numpy(lower),
             "inc_upper": torch.from_numpy(upper)}
    with torch.no_grad():
        rt = MT.forward(convert.params_from_jax(jax.tree.map(np.asarray, pj),
                                                "cpu"),
                        buf_t, cfg_t, SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu"),
                        torch.from_numpy(rays_o), torch.from_numpy(rays_d),
                        torch.from_numpy(viewdirs), torch.tensor(S_VAL), 0.2,
                        1.0)
    np.testing.assert_array_equal(rt["valid"].numpy(), np.asarray(rj["valid"]))
    assert 0 < rt["valid"].sum() < np.asarray(fwd_j(pj, {})["valid"]).sum()
    np.testing.assert_allclose(rt["rgb_marched"].numpy(),
                               np.asarray(rj["rgb_marched"]), rtol=1e-5,
                               atol=1e-5)
