"""The port's evaluation path against the JAX package (CPU): rays, the
procedural sphere, the metrics and the full-image lattice render.

Rays, the synthetic scene and the metrics are numpy copies of the JAX
package's numpy code, so they agree bit for bit.  The renders use
parameters made by the JAX package (a noisy sphere SDF and random k0
from a numpy seed, carried across with ``fgs_nerf_tpu_torch.convert``)
and a 24 x 32 view of the synthetic dataset, cut into 256-ray chunks
(the last one padded), through ``eval/render.py`` on both sides: a
coarse model with float32 shading and a fine model with bf16 shading.
Tolerances: image outputs agree to float32 reassociation (~1e-6), held
at 1e-5; normals divide by the interpolated gradient's norm, whose noise
grows where it is small, held at 2e-4; disparity is 1 / depth and
inherits depth's relative noise (its absolute noise, ~3e-7, is 1e-1 at
background pixels of depth ~1e-7 and 2e-5 at depth 1e-2), so it is
compared where depth > 1e-2, at 1e-4 relative; PSNR and SSIM of those
images at 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.data.rays import get_rays_of_a_view as get_rays_of_a_view_j
from fgs_nerf_tpu.data.synthetic import make_synthetic_dataset as make_synth_j
from fgs_nerf_tpu.eval import metrics as metrics_j
from fgs_nerf_tpu.eval import render as render_j
from fgs_nerf_tpu.models import sdf_voxel as MJ

from fgs_nerf_tpu_torch import convert
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.data.rays import get_rays_of_a_view
from fgs_nerf_tpu_torch.data.synthetic import (
    intrinsics, make_synthetic_dataset, pose_spherical,
)
from fgs_nerf_tpu_torch.eval import metrics as metrics_t
from fgs_nerf_tpu_torch.eval import render as render_t
from fgs_nerf_tpu_torch.models import sdf_voxel as MT

XYZ_MIN = np.array([-1.0, -1.0, -1.0], np.float32)
XYZ_MAX = np.array([1.0, 1.0, 1.0], np.float32)
CONV = dict(ndc=False, inverse_y=False, flip_x=False, flip_y=False)
H, W = 24, 32
S_VAL = 0.2
MODELS = {
    "coarse_f32": dict(stage="coarse", num_voxels=20**3, num_voxels_base=20**3,
                       stepsize=0.5, k0_dim=12, refnet_width=16, refnet_depth=3,
                       posbase_pe=5, viewbase_pe=1, refbase_pe=5,
                       smooth_ksize=5, smooth_sigma=0.8, shade_k=24,
                       sample_k=48, mlp_bf16=False, engine="sorted"),
    "fine_bf16": dict(stage="fine", num_voxels=16**3, num_voxels_base=16**3,
                      stepsize=0.5, k0_dim=4, refnet_width=16, refnet_depth=3,
                      rgbnet_width=16, rgbnet_depth=3, posbase_pe=2,
                      viewbase_pe=1, refbase_pe=2, shade_k=24, sample_k=40,
                      grad_feat=(0.5, 1.0, 1.5, 2.0),
                      sdf_feat=(0.5, 1.0, 1.5, 2.0), mlp_bf16=True),
}


@pytest.mark.parametrize("ndc,inverse_y,flip_x,flip_y", [
    (False, False, False, False), (True, False, False, False),
    (False, True, True, False), (False, False, False, True)])
def test_get_rays_of_a_view(ndc, inverse_y, flip_x, flip_y):
    k = intrinsics(H, W)
    c2w = pose_spherical(30.0, -30.0, 4.0)
    want = get_rays_of_a_view_j(H, W, k, c2w, ndc, inverse_y, flip_x, flip_y)
    got = get_rays_of_a_view(H, W, k, c2w, ndc, inverse_y, flip_x, flip_y)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_make_synthetic_dataset():
    want = make_synth_j(n_views=3, h=16, w=20, n_test=2)
    got = make_synthetic_dataset(n_views=3, h=16, w=20, n_test=2)
    assert set(got) == set(want)
    for key in ("HW", "Ks", "poses", "images", "masks", "i_train", "i_test",
                "render_poses"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["hwf"] == want["hwf"]
    assert (got["near"], got["far"]) == (want["near"], want["far"])
    assert 0 < got["masks"].sum() < got["masks"].size


def test_metrics():
    rng = np.random.default_rng(4)
    gt = rng.uniform(size=(30, 40, 3)).astype(np.float32)
    rgb = np.clip(gt + rng.normal(size=gt.shape) * 0.05, 0, 1).astype(np.float32)
    mask = (rng.uniform(size=(30, 40)) > 0.5).astype(np.float32)
    for m in (None, mask):
        assert metrics_t.psnr_splits(rgb, gt, m) == metrics_j.psnr_splits(rgb, gt, m)
    assert metrics_t.rgb_ssim(rgb, gt, 1) == metrics_j.rgb_ssim(rgb, gt, 1)
    assert metrics_t.mse2psnr(0.01) == metrics_j.mse2psnr(0.01)
    np.testing.assert_array_equal(metrics_t.to8b(rgb), metrics_j.to8b(rgb))


def _model(name):
    kw = dict(xyz_min=XYZ_MIN, xyz_max=XYZ_MAX, s_ratio=50.0, s_start=0.2,
              fast_color_thres=1e-4, **MODELS[name])
    cfg_j = MJ.make_model_config(**kw)
    cfg_t = MT.make_model_config(**kw)
    rng = np.random.default_rng(13)
    pj = MJ.init_params(jax.random.PRNGKey(0), cfg_j)
    axes = [np.linspace(-1.0, 1.0, n) for n in cfg_j.world_size]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(gx**2 + gy**2 + gz**2)[..., None]
    pj["sdf"] = jnp.asarray(
        (r - 0.5 + rng.normal(size=r.shape) * 0.02).astype(np.float32))
    pj["k0"] = jnp.asarray(
        rng.normal(size=pj["k0"].shape).astype(np.float32) * 0.3)
    return cfg_j, cfg_t, pj


@pytest.fixture(scope="module", params=sorted(MODELS))
def renders(request):
    cfg_j, cfg_t, pj = _model(request.param)
    data = make_synthetic_dataset(n_views=1, h=H, w=W, n_test=2)
    poses = data["poses"][data["i_test"]]
    hw = data["HW"][data["i_test"]]
    ks = data["Ks"][data["i_test"]]
    gts = data["images"][data["i_test"]]
    masks = data["masks"][data["i_test"]]
    fn_j = render_j.make_render_fn(cfg_j, SceneBoxJ.create(XYZ_MIN, XYZ_MAX),
                                   near=2.0, bg=1.0)
    img_j = render_j.render_image(fn_j, pj, {}, H, W, ks[0], poses[0], CONV,
                                  S_VAL, chunk=256)
    stats_j = render_j.render_viewpoints(fn_j, pj, {}, poses, hw, ks, CONV,
                                         S_VAL, gt_imgs=gts, masks=masks)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    fn_t = render_t.make_render_fn(cfg_t, SceneBox.create(XYZ_MIN, XYZ_MAX,
                                                          "cpu"),
                                   near=2.0, bg=1.0)
    img_t = render_t.render_image(fn_t, pt, {}, H, W, ks[0], poses[0], CONV,
                                  S_VAL, chunk=256)
    stats_t = render_t.render_viewpoints(fn_t, pt, {}, poses, hw, ks, CONV,
                                         S_VAL, gt_imgs=gts, masks=masks)
    return dict(img_j=img_j, img_t=img_t, stats_j=stats_j, stats_t=stats_t,
                fn_t=fn_t, pt=pt, pose=poses[0], k=ks[0])


@pytest.mark.parametrize("key", ["rgb_marched", "depth", "disp",
                                 "alphainv_cum", "normal_marched"])
def test_render_image(renders, key):
    want = np.asarray(renders["img_j"][key])
    got = renders["img_t"][key]
    assert got.shape == want.shape and got.shape[:2] == (H, W)
    tol = atol = 2e-4 if key == "normal_marched" else 1e-5
    if key == "disp":
        solid = np.asarray(renders["img_j"]["depth"]) > 1e-2
        assert solid.any()
        got, want, tol, atol = got[solid], want[solid], 1e-4, 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)
    if key == "rgb_marched":
        assert np.all(np.isfinite(got)) and got.min() >= 0 and got.max() <= 1
        # the sphere is in view: some pixels are not background
        assert (renders["img_t"]["alphainv_cum"] < 0.5).any()


def test_render_overflow_and_stats(renders):
    assert renders["img_t"]["overflow_frac"] == renders["img_j"]["overflow_frac"]
    sj, st = renders["stats_j"], renders["stats_t"]
    for key in ("psnr", "fore_psnr", "bg_psnr", "ssim"):
        assert len(st[key]) == 2
        np.testing.assert_allclose(st[key], sj[key], rtol=1e-4)
    for a, b in zip(st["rgbs"], sj["rgbs"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def test_render_viewpoints_without_lpips(renders):
    out = render_t.render_viewpoints(renders["fn_t"], renders["pt"], {},
                                     [renders["pose"]], [(H, W)],
                                     [renders["k"]], CONV, S_VAL)
    assert out["psnr"] == [] and out["rgbs"][0].shape == (H, W, 3)
    # no autograd graph: eval needs no gradients
    assert not torch.is_tensor(out["rgbs"][0])
