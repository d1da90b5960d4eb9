"""The port's coarse-path primitives against the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both sides.
Tolerance: float32 elementwise math agrees to a few ulps (1e-6); the
scans and reductions reassociate like the JAX code (Hillis-Steele
scan kept on purpose), held at 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.ops import encoding as EJ
from fgs_nerf_tpu.ops import ray_sample as RJ
from fgs_nerf_tpu.ops import sdf2alpha as AJ
from fgs_nerf_tpu.ops import stencils as SJ
from fgs_nerf_tpu.ops import transmittance as TJ
from fgs_nerf_tpu.ops import tv as VJ
from fgs_nerf_tpu.optim import masked_adam as OJ

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import mlp as MLPT
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.ops import encoding as ET
from fgs_nerf_tpu_torch.ops import ray_sample as RT
from fgs_nerf_tpu_torch.ops import sdf2alpha as AT
from fgs_nerf_tpu_torch.ops import stencils as ST
from fgs_nerf_tpu_torch.ops import transmittance as TT
from fgs_nerf_tpu_torch.ops import tv as VT
from fgs_nerf_tpu_torch.optim import masked_adam as OT


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- transmittance


def _alpha_case(seed):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.0, 0.6, size=(6, 40)).astype(np.float32)
    alpha[0, 5] = 1.0          # alpha == 1: the 1e-10 backward guard
    alpha[1, :] = 0.35         # crosses T < 1e-3 mid-ray: early exit
    alpha[2, :] = 0.001        # never exits
    valid = rng.uniform(size=alpha.shape) > 0.2
    valid[1, :] = True
    g_w = rng.normal(size=alpha.shape).astype(np.float32)
    g_last = rng.normal(size=(6,)).astype(np.float32)
    return alpha, valid, g_w, g_last


@pytest.mark.parametrize("seed", [0, 1])
def test_alpha_to_weights_forward_and_vjp(seed):
    alpha, valid, g_w, g_last = _alpha_case(seed)
    (wj, lj), vjp = jax.vjp(lambda a: TJ.alpha_to_weights(a, jnp.asarray(valid)),
                            jnp.asarray(alpha))
    (ga_j,) = vjp((jnp.asarray(g_w), jnp.asarray(g_last)))
    a_t = T(alpha).requires_grad_(True)
    wt, lt = TT.alpha_to_weights(a_t, T(valid))
    (ga_t,) = torch.autograd.grad((wt * T(g_w)).sum() + (lt * T(g_last)).sum(),
                                  a_t)
    close(wt.detach(), wj)
    close(lt.detach(), lj)
    close(ga_t, ga_j, 1e-4)
    # the early-exit ray stops: zero weight and zero gradient past T < 1e-3
    w1 = wt.detach().numpy()[1]
    assert (w1 == 0).any() and (w1[:3] > 0).all()
    assert np.isfinite(ga_t.numpy()).all()


# ---------------------------------------------------------------- alpha / encodings / rays


def test_neus_alpha_and_schedule():
    rng = np.random.default_rng(2)
    cos, sdf = (rng.normal(size=(500,)).astype(np.float32) for _ in range(2))
    for s_val in (0.05, 0.2):
        close(AT.neus_alpha_from_cos(T(cos), T(sdf), 0.0088, torch.tensor(s_val)),
              AJ.neus_alpha_from_cos(cos, sdf, jnp.float32(0.0088), jnp.float32(s_val)),
              1e-6)
    close(AT.s_val_schedule(123, 50.0, 0.05), AJ.s_val_schedule(123, 50.0, 0.05), 1e-7)


def test_encodings_and_ray_box():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    n = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(ET.freq_bank(4).numpy(), EJ.freq_bank(4))
    close(ET.reflect(T(x), T(n)), EJ.reflect(x, n), 1e-6)
    close(ET.l2_normalize(T(x)), EJ.l2_normalize(x), 1e-6)
    ro = rng.normal(size=(50, 3)).astype(np.float32) * 3
    rd = rng.normal(size=(50, 3)).astype(np.float32)
    rd[0, 1] = 0.0
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 1, 1])
    tj = RJ.ray_box_intersect(ro, rd, SceneBoxJ.create(lo, hi), 0.2, 1e9)
    tt = RT.ray_box_intersect(T(ro), T(rd), SceneBox.create(lo, hi, "cpu"), 0.2, 1e9)
    for a, b in zip(tt, tj):
        close(a, b, 1e-6)


# ---------------------------------------------------------------- stencils / TV


@pytest.mark.parametrize("mode", ["interpolate", "raw", "grad_conv"])
def test_sdf_gradients(mode):
    rng = np.random.default_rng(4)
    sdf = rng.normal(size=(7, 8, 9, 1)).astype(np.float32)
    close(ST.sdf_gradient(T(sdf), 0.1, mode), SJ.sdf_gradient(sdf, 0.1, mode))
    close(ST.sdf_gradient_cm(T(sdf[..., 0]), 0.1, mode),
          SJ.sdf_gradient_cm(sdf[..., 0], 0.1, mode))


def test_smoothing_stencils():
    rng = np.random.default_rng(5)
    g1 = rng.normal(size=(7, 8, 9, 1)).astype(np.float32)
    g3 = rng.normal(size=(7, 8, 9, 3)).astype(np.float32)
    close(ST.smooth_grid(T(g1), 5, 0.8), SJ.smooth_grid(g1, 5, 0.8))
    close(ST.smooth_grid(T(g3), 3, 1.0), SJ.smooth_grid(g3, 3, 1.0))
    close(ST.tv_smooth(T(g3)), SJ.tv_smooth(g3))


@pytest.mark.parametrize("masked", [False, True])
def test_tv_losses_and_grad(masked):
    rng = np.random.default_rng(6)
    sdf = rng.normal(size=(6, 7, 8, 1)).astype(np.float32)
    k0 = rng.normal(size=(6, 7, 8, 4)).astype(np.float32)
    grad = SJ.sdf_gradient(sdf, 0.1)
    mask = (rng.uniform(size=(6, 7, 8, 1)) > 0.3) if masked else None
    tmask = T(mask) if masked else None
    close(VT.density_tv_loss(T(sdf), T(np.asarray(grad)), 0.1, 0.1, 0.05, tmask),
          VJ.density_tv_loss(sdf, grad, 0.1, 0.1, 0.05, mask))
    close(VT.k0_tv_loss(T(k0), tmask), VJ.k0_tv_loss(k0, mask))
    g_in = rng.normal(size=k0.shape).astype(np.float32)
    g_in[g_in < 0] = 0.0
    for dense in (True, False):
        close(VT.tv_grad(T(k0), T(g_in), 0.3, 0.3, 0.3, dense, tmask),
              VJ.tv_grad(k0, g_in, 0.3, 0.3, 0.3, dense, mask), 1e-6)


# ---------------------------------------------------------------- masked Adam


@pytest.mark.parametrize("skip_zero_grad", [False, True])
def test_masked_adam(skip_zero_grad):
    """Two steps, a frozen group, per-voxel lr, and zero gradients that
    skip_zero_grad must leave untouched (parameter and both moments)."""
    rng = np.random.default_rng(7)
    p = {"a": rng.normal(size=(5, 6)).astype(np.float32),
         "net": {"w0": rng.normal(size=(3, 4)).astype(np.float32)},
         "frozen": rng.normal(size=(2,)).astype(np.float32)}
    per_lr = {"a": rng.uniform(0.5, 1.5, size=(5, 6)).astype(np.float32)}
    opts_j = {"a": OJ.ParamOpts(skip_zero_grad, has_per_lr=True),
              "net": OJ.ParamOpts()}
    opts_t = {"a": OT.ParamOpts(skip_zero_grad, has_per_lr=True),
              "net": OT.ParamOpts()}
    lrs = {"a": 0.1, "net": 1e-3}
    pj, sj = jax.tree.map(jnp.asarray, p), OJ.init_state(jax.tree.map(jnp.asarray, p))
    pt = OT.tree_map(T, p)
    st = OT.init_state(pt)
    for it in range(2):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), p)
        g["a"][g["a"] > 0.5] = 0.0
        pj, sj = OJ.adam_update(pj, jax.tree.map(jnp.asarray, g), sj,
                                {k: jnp.asarray(v) for k, v in lrs.items()},
                                opts_j, per_lr=jax.tree.map(jnp.asarray, per_lr))
        pt, st = OT.adam_update(pt, OT.tree_map(T, g), st, lrs, opts_t,
                                per_lr=OT.tree_map(T, per_lr))
    assert int(st.step) == int(sj.step) == 2
    for got, want in ((pt, pj), (st.exp_avg, sj.exp_avg),
                      (st.exp_avg_sq, sj.exp_avg_sq)):
        close(got["a"], want["a"], 1e-6)
        close(got["net"]["w0"], want["net"]["w0"], 1e-6)
    np.testing.assert_array_equal(pt["frozen"].numpy(), p["frozen"])
    if skip_zero_grad:
        zero = g["a"] == 0.0
        assert zero.any()


# ---------------------------------------------------------------- model helpers


def test_compact_valid_and_masks():
    rng = np.random.default_rng(8)
    valid = rng.uniform(size=(9, 40)) > 0.4
    valid[3, :] = True  # overflows k
    vj, sj_, oj = MJ._compact_valid(jnp.asarray(valid), 16)
    vt, st_, ot = MT._compact_valid(T(valid), 16)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(st_.numpy(), np.asarray(sj_))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))

    # 2e-3, not 1e-3: all-1e-3 corners interpolate onto the threshold itself
    mask = (rng.uniform(size=(10, 11, 12, 1)) > 0.7).astype(np.float32) * 2e-3
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 1, 1])
    mc_j = MJ.build_mask_cache(jnp.asarray(mask), lo, hi)
    mc_t = MT.build_mask_cache(T(mask), lo, hi)
    np.testing.assert_array_equal(mc_t["grid"].numpy(), np.asarray(mc_j["grid"]))
    pts = rng.uniform(-1.1, 1.1, size=(300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        MT.mask_cache_query(mc_t, T(pts), 1e-3).numpy(),
        np.asarray(MJ.mask_cache_query(mc_j, jnp.asarray(pts), 1e-3)))
    lower, upper = np.float32([0.1, 0.2, 0.0]), np.float32([0.8, 0.9, 0.7])
    np.testing.assert_array_equal(
        MT.inc_mask_query(T(lower), T(upper), T(pts), SceneBox.create(lo, hi, "cpu"),
                          (10, 11, 12)).numpy(),
        np.asarray(MJ.inc_mask_query(jnp.asarray(lower), jnp.asarray(upper),
                                     jnp.asarray(pts), SceneBoxJ.create(lo, hi),
                                     (10, 11, 12))))


def test_init_params_layout(monkeypatch):
    cfg = MT.make_model_config(
        stage="coarse", xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
        num_voxels=12**3, num_voxels_base=12**3, stepsize=0.5,
        refnet_width=16, refnet_depth=3, engine="sorted")
    gen = torch.Generator().manual_seed(0)
    p = MT.init_params(gen, cfg, "cpu")
    cfg_j = MJ.make_model_config(
        stage="coarse", xyz_min=np.float32([-1, -1, -1]),
        xyz_max=np.float32([1, 1, 1]), num_voxels=12**3,
        num_voxels_base=12**3, stepsize=0.5, refnet_width=16,
        refnet_depth=3, engine="sorted")
    pj = MJ.init_params(jax.random.PRNGKey(0), cfg_j)
    np.testing.assert_array_equal(p["sdf"].numpy(), np.asarray(pj["sdf"]))
    assert p["k0"].shape == pj["k0"].shape and not p["k0"].any()
    for k, v in pj["refnet"].items():
        assert tuple(p["refnet"][k].shape) == v.shape
        bound = 1.0 / np.sqrt(v.shape[0] if k.startswith("w") else
                              pj["refnet"]["w" + k[1:]].shape[0])
        assert float(p["refnet"][k].abs().max()) <= bound
    assert MLPT.refnet_dims(90, 192, 3) == [90, 192, 192, 3]
    # the same parameters serve the lattice engine, which forward picks
    # for engine="lattice"
    seen = []
    monkeypatch.setattr(MT, "forward_coarse",
                        lambda params, buffers, c, *a: seen.append(c.engine))
    MT.forward(p, {}, cfg.__class__(**{**cfg.__dict__, "engine": "lattice"}),
               None, None, None, None, None, 0.2, 1.0)
    assert seen == ["lattice"]
