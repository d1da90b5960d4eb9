"""The port's LPIPS(alex) against the JAX package's native one (CPU).

The same numpy images (from a seed) go through
``fgs_nerf_tpu.eval.lpips_native.lpips_native`` and
``fgs_nerf_tpu_torch.eval.lpips_native.lpips_native``: with the seed-0
fallback weights, with a small random ``.npz`` named by
``FGS_LPIPS_WEIGHTS`` (as ``tests/test_lpips.py`` writes one), with the
fallback off, with a corrupt weight shape, and through both packages'
``render_viewpoints(eval_lpips=True)`` on one 36 x 36 view (24 x 32 is
too small: AlexNet's second pool gets an empty window there).
Tolerance: relative 1e-4, since XLA's and PyTorch's CPU convolutions
sum in different orders.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.eval import lpips_native as lpips_j
from fgs_nerf_tpu.eval import render as render_j
from fgs_nerf_tpu.models import sdf_voxel as MJ

from fgs_nerf_tpu_torch import convert
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from fgs_nerf_tpu_torch.eval import lpips_native as lpips_t
from fgs_nerf_tpu_torch.eval import metrics as metrics_t
from fgs_nerf_tpu_torch.eval import render as render_t
from fgs_nerf_tpu_torch.models import sdf_voxel as MT

RTOL = 1e-4


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.25, size=a.shape), 0, 1).astype(
        np.float32)
    return a, b


def _clear():
    lpips_j._CACHE.clear()
    lpips_t._CACHE.clear()


@pytest.fixture
def no_env(monkeypatch):
    monkeypatch.delenv("FGS_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("FGS_LPIPS_FALLBACK", raising=False)
    _clear()
    yield
    _clear()


def _write_npz(path, rng, corrupt=False):
    arrs = {}
    for i, (co, ci, k, _, _) in enumerate(lpips_t._ALEX):
        arrs[f"conv{i}_w"] = (rng.normal(size=(co, ci, k, k)).astype(
            np.float32) / np.sqrt(ci * k * k))
        arrs[f"conv{i}_b"] = rng.normal(scale=0.05, size=co).astype(
            np.float32)
        arrs[f"lin{i}"] = rng.uniform(-0.2, 1, size=co).astype(np.float32)
    if corrupt:
        arrs["conv2_w"] = arrs["conv2_w"][:, :10]
    np.savez(path, **arrs)


def test_fallback_weights_bit_equal(no_env):
    wj = lpips_j._fallback_weights()
    wt = lpips_t._fallback_weights()
    assert set(wj) == set(wt)
    for k in wj:
        np.testing.assert_array_equal(wt[k], wj[k])


@pytest.mark.parametrize("hw", [(36, 36), (64, 48)])
def test_fallback_matches_jax(no_env, hw):
    a, b = _pair(*hw, seed=hw[0])
    with pytest.warns(UserWarning, match="RANDOM-FEATURE fallback"):
        got = lpips_t.lpips_native(a, b, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # cached: no second warning
        same = lpips_t.lpips_native(a, a, device="cpu")
        via_metrics = metrics_t.rgb_lpips(a, b, "alex", device="cpu")
    with pytest.warns(UserWarning):
        want = lpips_j.lpips_native(a, b)
    assert same == 0.0 and got > 0.0
    assert via_metrics == got
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_weights_file_matches_jax(no_env, tmp_path, monkeypatch):
    path = str(tmp_path / "lpips_alex.npz")
    _write_npz(path, np.random.default_rng(5))
    monkeypatch.setenv("FGS_LPIPS_WEIGHTS", path)
    a, b = _pair(40, 52, seed=6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a weights file: no warning
        got = lpips_t.lpips_native(a, b, device="cpu")
    want = lpips_j.lpips_native(a, b)
    assert got > 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(lpips_t.lpips_native(b, a, device="cpu"),
                               got, rtol=1e-6)


def test_fallback_off_gives_none(no_env, monkeypatch):
    monkeypatch.setenv("FGS_LPIPS_FALLBACK", "0")
    a, _ = _pair(36, 36, seed=7)
    assert lpips_t.lpips_native(a, a, device="cpu") is None
    assert lpips_j.lpips_native(a, a) is None
    assert metrics_t.rgb_lpips(a, a, "alex", device="cpu") is None
    assert metrics_t.rgb_lpips(a, a, "vgg", device="cpu") is None


def test_corrupt_weights_raise(no_env, tmp_path, monkeypatch):
    path = str(tmp_path / "bad.npz")
    _write_npz(path, np.random.default_rng(8), corrupt=True)
    monkeypatch.setenv("FGS_LPIPS_WEIGHTS", path)
    a = np.zeros((36, 36, 3), np.float32)
    with pytest.raises(ValueError, match="conv2_w"):
        lpips_t.lpips_native(a, a, device="cpu")
    with pytest.raises(ValueError, match="conv2_w"):
        lpips_j.lpips_native(a, a)


def test_render_viewpoints_lpips_matches_jax(no_env):
    """One 36 x 36 test view of the procedural sphere through both
    packages' ``render_viewpoints(eval_lpips=True)`` on a small coarse
    model (JAX parameters carried across with ``convert``)."""
    h = w = 36
    xyz_min = np.full(3, -1.0, np.float32)
    xyz_max = np.full(3, 1.0, np.float32)
    kw = dict(xyz_min=xyz_min, xyz_max=xyz_max, s_ratio=50.0, s_start=0.2,
              fast_color_thres=1e-4, stage="coarse", num_voxels=16**3,
              num_voxels_base=16**3, stepsize=0.5, k0_dim=6,
              refnet_width=16, refnet_depth=3, posbase_pe=2, viewbase_pe=1,
              refbase_pe=2, smooth_ksize=5, smooth_sigma=0.8, shade_k=24,
              sample_k=40, mlp_bf16=False, engine="sorted")
    cfg_j = MJ.make_model_config(**kw)
    cfg_t = MT.make_model_config(**kw)
    rng = np.random.default_rng(9)
    pj = MJ.init_params(jax.random.PRNGKey(0), cfg_j)
    axes = [np.linspace(-1.0, 1.0, n) for n in cfg_j.world_size]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(gx**2 + gy**2 + gz**2)[..., None]
    pj["sdf"] = jnp.asarray((r - 0.5).astype(np.float32))
    pj["k0"] = jnp.asarray(
        rng.normal(size=pj["k0"].shape).astype(np.float32) * 0.3)
    data = make_synthetic_dataset(n_views=1, h=h, w=w, n_test=1)
    it = data["i_test"]
    args = (data["poses"][it], data["HW"][it], data["Ks"][it],
            dict(ndc=False, inverse_y=False, flip_x=False, flip_y=False),
            0.2)
    extra = dict(gt_imgs=data["images"][it], masks=data["masks"][it],
                 eval_ssim=False, eval_lpips=True)
    fn_j = render_j.make_render_fn(cfg_j, SceneBoxJ.create(xyz_min, xyz_max),
                                   near=2.0, bg=1.0)
    with pytest.warns(UserWarning):
        want = render_j.render_viewpoints(fn_j, pj, {}, *args, **extra)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    fn_t = render_t.make_render_fn(
        cfg_t, SceneBox.create(xyz_min, xyz_max, "cpu"), near=2.0, bg=1.0)
    with pytest.warns(UserWarning):
        got = render_t.render_viewpoints(fn_t, pt, {}, *args, **extra)
    assert len(got["lpips_alex"]) == len(want["lpips_alex"]) == 1
    assert got["lpips_vgg"] == [] and got["lpips_alex"][0] > 0.0
    np.testing.assert_allclose(got["lpips_alex"], want["lpips_alex"],
                               rtol=RTOL)
